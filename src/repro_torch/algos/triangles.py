"""Triangle counting: K-pivot batched diag(A^3) over plus_times sweeps.

For a pivot vertex p of a simple undirected graph (both directions stored,
no self-loops, no duplicates) the number of closed length-3 walks through
p is

    diag(A^3)[p] = a_p^T A a_p = sum_u y_p[u] * z_p[u],
    y_p = A x_p (x_p one-hot at p, so y_p = a_p),   z_p = A y_p

— two ``SemiringSweep("plus_times", "one")`` products, the declarative spec
PageRank uses, so the program runs on every edge backend. K pivots batch
into [P, v_max, K] columns, one launch per sweep.

The two products are a phase machine: y must be globally synced before z
reads it, so phase 0 computes and sum-exchanges y partials, phase 1 does
the same for z, phase 2 emits nothing and vote-to-halt ends the run after
exactly three supersteps. Where the JAX package keeps ``phase`` / ``swept``
as per-partition scalars under ``vmap``, the stacked port keeps them as
[P] int32 tensors, which the engine's per-partition select carries.
``result`` is the per-vertex product ``y * z``; ``triangles_from_result``
folds it: ``diag(A^3)[p] = 2 * (triangles through p)``.

The values are integer counts: float32 holds them exactly while every
``z`` stays below 2**24, so the order of a sum does not change the answer.
Not monotone — every query is a fresh three-superstep run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.api import DeviceSubgraph, SemiringSweep, VertexProgram


def _per_part(x: torch.Tensor) -> torch.Tensor:
    """[P] -> [P, 1, 1], to select [P, v_max, K] tensors by partition."""
    return x[:, None, None]


@dataclasses.dataclass
class TriangleCount(VertexProgram):
    combiner: str = "sum"
    payload: int = 4               # K pivots; set at construction
    dtype: object = np.float32
    delta_based: bool = True
    monotone: bool = False

    sweep_spec = SemiringSweep("plus_times", "one")

    def init(self, sg: DeviceSubgraph, params, ec):
        pivots = params["pivots"]         # [K] global vertex ids
        x = ((sg.vid32[..., None] == pivots) &
             sg.vmask[..., None]).to(torch.float32)
        zeros = torch.zeros_like(x)
        P = sg.n_parts
        return {"x": x, "y": zeros, "z": zeros,
                "phase": torch.zeros(P, dtype=torch.int32, device=sg.device),
                "swept": torch.full((P,), -1, dtype=torch.int32,
                                    device=sg.device)}

    def apply_frontier(self, sg, params, state, merged, ec):
        f = sg.frontier[..., None]
        p = _per_part(state["phase"])
        y = torch.where((p == 0) & f, merged, state["y"])
        z = torch.where((p == 1) & f, merged, state["z"])
        changed = ((merged != 0).any(dim=-1) & sg.frontier).sum(
            dim=-1, dtype=torch.int32)
        return {"x": state["x"], "y": y, "z": z,
                "phase": torch.clamp(state["phase"] + 1, max=2),
                "swept": state["swept"]}, changed

    def sweep_values(self, sg, params, state):
        return torch.where(_per_part(state["phase"]) == 0, state["x"],
                           state["y"])

    def sweep_fold(self, sg, params, state, agg):
        p = state["phase"]
        do = (state["swept"] < p) & (p <= 1)
        agg = torch.where(sg.vmask[..., None], agg, 0.0)
        y = torch.where(_per_part((p == 0) & do), agg, state["y"])
        z = torch.where(_per_part((p == 1) & do), agg, state["z"])
        swept = torch.where(do, p, state["swept"])
        return {"x": state["x"], "y": y, "z": z, "phase": p,
                "swept": swept}, do.to(torch.int32)

    def frontier_out(self, sg, params, state):
        p = _per_part(state["phase"])
        out = torch.where(p == 0, state["y"],
                          torch.where(p == 1, state["z"], 0.0))
        return torch.where(sg.frontier[..., None], out, 0.0)

    def result(self, sg, params, state):
        """Per-vertex [K] summands of diag(A^3) at each pivot."""
        return torch.where(sg.vmask[..., None], state["y"] * state["z"], 0.0)


def make_triangles(pivots):
    """(program, params) counting triangles through the given pivots."""
    pivots = np.asarray(pivots, np.int32)
    prog = TriangleCount(payload=int(pivots.shape[0]))
    return prog, {"pivots": pivots}


def triangles_from_result(values) -> np.ndarray:
    """Per-pivot triangle counts from collected [n, K] result values:
    triangles through pivot k = sum_u (y*z)[u, k] / 2. With pivots = all
    vertices, ``triangles_from_result(vals).sum() / 3`` is the global
    triangle count."""
    vals = np.asarray(values, np.float64)
    return vals.sum(axis=0) / 2.0
