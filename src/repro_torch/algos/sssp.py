"""Single-Source Shortest Path (paper §7.1).

The local solver is Bellman–Ford iterated to the partition-local fixed point
(min-plus semiring sweeps) — distances propagate arbitrarily far inside a
partition per superstep, as in the paper's SC model — and the SBS Aggregate
operator is ``min``. Weights must be non-negative; distances are float32.
All methods work on the stacked ``[P, v_max]`` batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.api import DeviceSubgraph, SemiringSweep, VertexProgram

INF = float("inf")


@dataclasses.dataclass
class SSSP(VertexProgram):
    combiner: str = "min"
    payload: int = 1
    dtype: object = np.float32
    delta_based: bool = False
    monotone: bool = True          # distances only tighten -> warm-startable
    value_key: str = "dist"

    sweep_spec = SemiringSweep("min_plus", "weight")

    def init(self, sg: DeviceSubgraph, params, ec):
        src = params["source"]            # global vertex id
        zero = torch.zeros((), dtype=torch.float32, device=sg.device)
        inf = torch.full((), INF, dtype=torch.float32, device=sg.device)
        dist = torch.where(sg.vid32 == src, zero, inf)
        return {"dist": torch.where(sg.vmask, dist, inf)}

    def apply_frontier(self, sg, params, state, merged, ec):
        d = state["dist"]
        new = torch.where(sg.frontier, torch.minimum(d, merged[..., 0]), d)
        return {"dist": new}, (new < d).sum(dim=-1, dtype=torch.int32)

    def sweep_values(self, sg, params, state):
        return state["dist"]

    def sweep_fold(self, sg, params, state, agg):
        d = state["dist"]
        new = torch.where(sg.vmask, torch.minimum(d, agg), d)
        return {"dist": new}, (new < d).sum(dim=-1, dtype=torch.int32)

    def frontier_out(self, sg, params, state):
        return state["dist"][..., None]

    def result(self, sg, params, state):
        return state["dist"]
