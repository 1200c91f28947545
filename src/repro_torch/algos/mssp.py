"""Multi-source shortest paths (landmarks): K sources solved simultaneously.

Exercises the engine's vector payload (K > 1): vertex values are
[K]-vectors, one distance per source, and SBS reduces [n_slots, K] buffers
with ``min``. The sweep is hand-rolled (a COO gather and an ``amin``
scatter along the vertex axis of the stacked ``[P, v_max, K]`` batch), so
the program declares ``supports_edge_backends = ("coo",)``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import numpy as np
import torch

from repro_torch.algos._scatter import changed_rows, scatter_min
from repro_torch.core.api import DeviceSubgraph, VertexProgram

INF = float("inf")


@dataclasses.dataclass
class MultiSourceSSSP(VertexProgram):
    # hand-rolled sweep: implements the COO gather/scatter path only
    supports_edge_backends: ClassVar[Tuple[str, ...]] = ("coo",)

    combiner: str = "min"
    payload: int = 4            # K sources; set at construction
    dtype: object = np.float32
    delta_based: bool = False
    monotone: bool = True       # distances only tighten -> warm-startable
    value_key: str = "dist"

    def init(self, sg: DeviceSubgraph, params, ec):
        sources = params["sources"]          # [K] global vertex ids
        dist = torch.where(sg.vid32[..., None] == sources, 0.0, INF)
        return {"dist": torch.where(sg.vmask[..., None], dist,
                                    INF).to(torch.float32)}

    def apply_frontier(self, sg, params, state, merged, ec):
        d = state["dist"]
        new = torch.where(sg.frontier[..., None], torch.minimum(d, merged), d)
        return {"dist": new}, changed_rows(new, d)

    def sweep(self, sg, params, state, ec):
        d = state["dist"]
        cand = torch.where(sg.emask[..., None],
                           sg.gather(d, sg.esrc) + sg.ew[..., None], INF)
        agg = ec.min(scatter_min(sg, cand, sg.edst, INF))
        new = torch.where(sg.vmask[..., None], torch.minimum(d, agg), d)
        return {"dist": new}, changed_rows(new, d)

    def frontier_out(self, sg, params, state):
        return state["dist"]

    def result(self, sg, params, state):
        return state["dist"]


def make_mssp(sources):
    """(program, params) for K-source shortest paths."""
    sources = np.asarray(sources, np.int32)
    prog = MultiSourceSSSP(payload=int(sources.shape[0]))
    return prog, {"sources": sources}
