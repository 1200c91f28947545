"""Connected Components (paper §5.1 Algorithm 1, §5.2 Fig. 3).

Label propagation: every vertex starts labelled with its own global id; a
local sweep takes the min label over in-neighbours (the graph is stored
undirected), iterated to the partition-local fixed point, and SBS merges
frontier labels with ``min``. Labels are int32 end to end on every edge
backend. All methods work on the stacked ``[P, v_max]`` batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.api import DeviceSubgraph, SemiringSweep, VertexProgram

_IMAX = 2**31 - 1


@dataclasses.dataclass
class ConnectedComponents(VertexProgram):
    combiner: str = "min"
    payload: int = 1
    dtype: object = np.int32
    delta_based: bool = False
    monotone: bool = True       # labels only decrease -> warm-startable
    value_key: str = "label"

    # min-plus over zero-valued edges == min-label propagation
    sweep_spec = SemiringSweep("min_plus", "zero")

    def init(self, sg: DeviceSubgraph, params, ec):
        imax = torch.full((), _IMAX, dtype=torch.int32, device=sg.device)
        return {"label": torch.where(sg.vmask, sg.vid32, imax)}

    def apply_frontier(self, sg, params, state, merged, ec):
        lab = state["label"]
        new = torch.where(sg.frontier, torch.minimum(lab, merged[..., 0]),
                          lab)
        return {"label": new}, (new < lab).sum(dim=-1, dtype=torch.int32)

    def sweep_values(self, sg, params, state):
        return state["label"]

    def sweep_fold(self, sg, params, state, agg):
        lab = state["label"]
        new = torch.where(sg.vmask, torch.minimum(lab, agg), lab)
        return {"label": new}, (new < lab).sum(dim=-1, dtype=torch.int32)

    def frontier_out(self, sg, params, state):
        return state["label"][..., None]

    def result(self, sg, params, state):
        return state["label"]
