"""Label propagation / community detection, hop-stratified and confluent.

The deterministic variant of the GoFFish/Kakwani suite's LPA: every vertex
adopts the smallest vertex id reachable within ``hops`` edges, kept as one
lane per hop budget (``payload = hops + 1``):

    lane_h(v) = min id within h hops of v
              = min(v, min over in-neighbours u of lane_{h-1}(u))

Lane h only reads lane h-1 and each lane is a plain monotone min fixpoint,
so any fair schedule (SC, VC, any partitioning) converges to the same
answer. The community label is the last lane (``decode_labels``). The
lane-shifted edge map does not fit ``SemiringSweep``'s per-edge values, so
this is a hand-rolled COO sweep (``supports_edge_backends = ("coo",)``)
with int32 lanes on the stacked ``[P, v_max, hops + 1]`` batch. Monotone
under inserts: warm-startable after insert-only flushes.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import numpy as np
import torch

from repro_torch.algos._scatter import changed_rows, scatter_min
from repro_torch.core.api import DeviceSubgraph, VertexProgram

_IMAX = 2**31 - 1


@dataclasses.dataclass
class LabelPropagation(VertexProgram):
    # lane-shifted per-edge map: COO gather/scatter only
    supports_edge_backends: ClassVar[Tuple[str, ...]] = ("coo",)

    combiner: str = "min"
    payload: int = 4            # hops + 1 lanes; keep in sync with hops
    dtype: object = np.int32
    delta_based: bool = False
    monotone: bool = True       # lanes only decrease -> warm-startable
    value_key: str = "lanes"
    hops: int = 3               # propagation radius L

    def __post_init__(self):
        self.payload = self.hops + 1

    def init(self, sg: DeviceSubgraph, params, ec):
        lanes = torch.where(sg.vmask, sg.vid32, _IMAX)
        return {"lanes": lanes[..., None].expand(
            -1, -1, self.payload).contiguous()}

    def apply_frontier(self, sg, params, state, merged, ec):
        lanes = state["lanes"]
        new = torch.where(sg.frontier[..., None],
                          torch.minimum(lanes, merged), lanes)
        return {"lanes": new}, changed_rows(new, lanes)

    def sweep(self, sg, params, state, ec):
        lanes = state["lanes"]
        # message lane h carries the source's lane h-1; lane 0 never moves
        prev = torch.where(sg.emask[..., None],
                           sg.gather(lanes, sg.esrc)[..., :-1], _IMAX)
        cand = torch.cat([torch.full_like(prev[..., :1], _IMAX), prev],
                         dim=-1)
        agg = ec.min(scatter_min(sg, cand, sg.edst, _IMAX))
        new = torch.where(sg.vmask[..., None], torch.minimum(lanes, agg),
                          lanes)
        return {"lanes": new}, changed_rows(new, lanes)

    def frontier_out(self, sg, params, state):
        return state["lanes"]

    def result(self, sg, params, state):
        return state["lanes"]


def make_lp(hops: int = 3):
    """(program, params) for hop-bounded min-label propagation."""
    if hops < 1:
        raise ValueError(f"hops={hops}: the propagation radius must be >= 1")
    return LabelPropagation(hops=hops), {}


def decode_labels(lanes):
    """Community ids from collected lanes: the full-radius lane (IMAX
    padding rows stay IMAX)."""
    return np.asarray(lanes)[..., -1].astype(np.int32)
