"""Single-source shortest paths: one key per call, the port's ``SSSP``
(float32 distances, ``min_plus`` over the edge weights). The answer is
exact: every vertex's distance equals the reference's bit for bit
(``reference/paths.py`` says why one exists), ``inf`` where unreached."""
from __future__ import annotations

import numpy as np
import torch

from gbench.reference import paths

WEIGHTED = True
LIMITS = {"mismatched_values": 0}
CONTROLS = ("bf16",)      # the nearest precision below float32


def program(lanes: int):
    from repro_torch.algos.sssp import SSSP
    if lanes != 1:
        raise ValueError(f"SSSP serves one key a call, not {lanes}")
    return SSSP()


def params(keys: np.ndarray) -> dict:
    return {"source": int(keys[0])}


def reference(edges, keys, **kw) -> torch.Tensor:
    return paths.shortest_paths(edges.src, edges.dst, edges.w,
                                edges.n_vertices, torch.as_tensor(keys),
                                **kw)


def control(edges, keys, name: str) -> torch.Tensor:
    if name != "bf16":
        raise ValueError(f"no control {name!r} for sssp: {CONTROLS}")
    return reference(edges, keys, dtype=torch.bfloat16).float()
