"""Breadth-first levels from many keys in one call: the port's
``MultiSourceBFS`` with one lane per key (float32 levels, ``min_plus``
with unit cost, no weight read). Levels are exact small integers, equal to
the reference's; ``inf`` where a key does not reach."""
from __future__ import annotations

import numpy as np
import torch

from gbench.reference import paths

WEIGHTED = False
LIMITS = {"mismatched_values": 0}
# "short": the search stopped one level before its deepest (the guarantee
# that every reachable vertex gets its hop count, broken); "bf16": levels
# in bfloat16, which holds these small integers exactly and so is no
# control (kept to show it)
CONTROLS = ("short", "bf16")


def program(lanes: int):
    from repro_torch.algos.bfs import MultiSourceBFS
    return MultiSourceBFS(payload=int(lanes))


def params(keys: np.ndarray) -> dict:
    return {"sources": np.asarray(keys, np.int32)}


def reference(edges, keys, **kw) -> torch.Tensor:
    return paths.bfs_levels(edges.src, edges.dst, edges.n_vertices,
                            torch.as_tensor(keys), **kw)


def control(edges, keys, name: str) -> torch.Tensor:
    if name == "bf16":
        return reference(edges, keys, dtype=torch.bfloat16).float()
    if name != "short":
        raise ValueError(f"no control {name!r} for msbfs: {CONTROLS}")
    full = reference(edges, keys)
    deepest = int(full[torch.isfinite(full)].max())
    return reference(edges, keys, max_rounds=max(deepest - 1, 0))
