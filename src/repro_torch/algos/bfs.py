"""Breadth-First Search levels (Kakwani & Simmhan's first suite member).

BFS is SSSP over unit edge weights: the level of a vertex is the min-plus
distance where every hop costs 1, declared as ``SemiringSweep("min_plus",
"one")`` so it runs on every edge backend (the COO product and the tile
layouts add the 1 at the edge; ``engine._edge_messages`` does the same for
the windowed path).

Levels are float32 with ``inf`` at unreachable vertices: small integer
levels are exact in f32 and ``inf + 1 == inf`` keeps the sentinel closed
under the semiring on every backend.

``MultiSourceBFS`` batches K roots into one launch ([P, v_max, K] values)
— the distance phase of the K-pivot Brandes stages (algos/betweenness.py)
and the main path's K > 1 user of both kernels. Both programs are monotone
under inserts, so a session warm-starts them across insert-only flushes.
All methods work on the stacked ``[P, v_max(, K)]`` batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.algos._scatter import changed_rows
from repro_torch.core.api import DeviceSubgraph, SemiringSweep, VertexProgram

INF = float("inf")


@dataclasses.dataclass
class BFS(VertexProgram):
    combiner: str = "min"
    payload: int = 1
    dtype: object = np.float32
    delta_based: bool = False
    monotone: bool = True          # levels only tighten under inserts
    value_key: str = "level"

    # unit-cost min-plus relax: level[d] = min_e level[src(e)] + 1
    sweep_spec = SemiringSweep("min_plus", "one")

    def init(self, sg: DeviceSubgraph, params, ec):
        src = params["source"]            # global vertex id
        lvl = torch.where(sg.vid32 == src, 0.0, INF).to(torch.float32)
        return {"level": torch.where(sg.vmask, lvl, INF)}

    def apply_frontier(self, sg, params, state, merged, ec):
        lvl = state["level"]
        new = torch.where(sg.frontier, torch.minimum(lvl, merged[..., 0]),
                          lvl)
        return {"level": new}, changed_rows(new, lvl)

    def sweep_values(self, sg, params, state):
        return state["level"]

    def sweep_fold(self, sg, params, state, agg):
        lvl = state["level"]
        new = torch.where(sg.vmask, torch.minimum(lvl, agg), lvl)
        return {"level": new}, changed_rows(new, lvl)

    def frontier_out(self, sg, params, state):
        return state["level"][..., None]

    def result(self, sg, params, state):
        return state["level"]


@dataclasses.dataclass
class MultiSourceBFS(VertexProgram):
    """K-root BFS in one launch: [P, v_max, K] levels, min-combined SBS."""

    combiner: str = "min"
    payload: int = 4               # K roots; set at construction
    dtype: object = np.float32
    delta_based: bool = False
    monotone: bool = True
    value_key: str = "level"

    sweep_spec = SemiringSweep("min_plus", "one")

    def init(self, sg: DeviceSubgraph, params, ec):
        sources = params["sources"]       # [K] global vertex ids
        lvl = torch.where(sg.vid32[..., None] == sources, 0.0, INF)
        return {"level": torch.where(sg.vmask[..., None], lvl,
                                     INF).to(torch.float32)}

    def apply_frontier(self, sg, params, state, merged, ec):
        lvl = state["level"]
        new = torch.where(sg.frontier[..., None], torch.minimum(lvl, merged),
                          lvl)
        return {"level": new}, changed_rows(new, lvl)

    def sweep_values(self, sg, params, state):
        return state["level"]

    def sweep_fold(self, sg, params, state, agg):
        lvl = state["level"]
        new = torch.where(sg.vmask[..., None], torch.minimum(lvl, agg), lvl)
        return {"level": new}, changed_rows(new, lvl)

    def frontier_out(self, sg, params, state):
        return state["level"]

    def result(self, sg, params, state):
        return state["level"]


def make_msbfs(sources):
    """(program, params) for K-root BFS from the given global vertex ids."""
    sources = np.asarray(sources, np.int32)
    prog = MultiSourceBFS(payload=int(sources.shape[0]))
    return prog, {"sources": sources}
