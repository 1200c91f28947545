"""Graph Simulation (paper §7.3, Algorithm 2).

Pattern matching by simulation relation pruning: start with the label-match
relation R0 and prune ``v from sim(u)`` whenever some pattern successor u' of
u has ``post(v)[u'] == 0``, where ``post(v)[u'] = |{w in N_v^out : w in
sim(u')}|``. Decrements to ``post`` propagate to in-neighbours; across
partitions the decrement vectors Δpost are exchanged through SBS with the
``sum`` Aggregate operator, as Algorithm 2's ``tempPost`` vectors.

An internal vertex has all its edges in one partition, so its ``post`` is
complete locally from superstep 0; a frontier vertex's ``post`` is valid
only after the first SBS merge, so pruning of frontier rows waits for
``nsync >= 1`` (a [P] int32 tensor on the stacked batch).

State: ``sim [P, v_max, VQ]`` membership, ``post [P, v_max, VQ]`` effective
counts (last synced + own pending), ``pending [P, v_max, VQ]`` un-synced
own delta. Vertex labels come from ``PartitionedGraph.set_vertex_labels``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import numpy as np
import torch

from repro_torch.algos._scatter import scatter_sum
from repro_torch.core.api import DeviceSubgraph, VertexProgram


@dataclasses.dataclass
class GraphSimulation(VertexProgram):
    # label-indexed joins per edge: COO gather/scatter only
    supports_edge_backends: ClassVar[Tuple[str, ...]] = ("coo",)

    combiner: str = "sum"
    payload: int = 1          # set to |V_Q| at construction
    dtype: object = np.int32
    delta_based: bool = True

    def _scatter_to_src(self, sg: DeviceSubgraph, rows, ec):
        """sum_{(s,d) in E_local} rows[d]  ->  [P, v_max, VQ] at s."""
        contrib = torch.where(sg.emask[..., None], sg.gather(rows, sg.edst),
                              0)
        return ec.sum(scatter_sum(sg, contrib, sg.esrc))

    def init(self, sg: DeviceSubgraph, params, ec):
        if sg.vlabel is None:
            raise ValueError(
                "GraphSimulation needs vertex labels: call "
                "PartitionedGraph.set_vertex_labels before the graph is "
                "uploaded (before a session's first query)")
        qlabel = params["qlabel"]  # [VQ]
        sim = sg.vmask[..., None] & (sg.vlabel[..., None] == qlabel)
        post = self._scatter_to_src(sg, sim.to(torch.int32), ec)
        return {"sim": sim, "post": post, "pending": post,
                "nsync": torch.zeros(sg.n_parts, dtype=torch.int32,
                                     device=sg.device)}

    def apply_frontier(self, sg, params, state, merged, ec):
        f = sg.frontier[..., None]
        post = torch.where(f, state["post"] - state["pending"] + merged,
                           state["post"])
        pending = torch.where(f, 0, state["pending"])
        changed = ((merged != 0).any(dim=-1) & sg.frontier).sum(
            dim=-1, dtype=torch.int32)
        return {"sim": state["sim"], "post": post, "pending": pending,
                "nsync": state["nsync"] + 1}, changed

    def sweep(self, sg, params, state, ec):
        qadj = params["qadj"]  # [VQ, VQ] int32, qadj[u, u'] = 1 iff u->u'
        sim, post, pending = state["sim"], state["post"], state["pending"]
        valid = (sg.internal | (state["nsync"] >= 1)[:, None])[..., None]
        bad = (post == 0).to(torch.int32)                  # [P, v_max, VQ']
        # (bad @ qadj.T) > 0, as an exact int32 sum (no integer matmul on
        # the card)
        viol = (bad[..., None, :] * qadj).sum(dim=-1) > 0  # [P, v_max, VQ]
        removed = sim & viol & valid & sg.vmask[..., None]
        sim = sim & ~removed
        dec = self._scatter_to_src(sg, removed.to(torch.int32), ec)
        changed = removed.sum(dim=(1, 2), dtype=torch.int32)
        return {"sim": sim, "post": post - dec, "pending": pending - dec,
                "nsync": state["nsync"]}, changed

    def frontier_out(self, sg, params, state):
        return torch.where(sg.frontier[..., None], state["pending"], 0)

    def result(self, sg, params, state):
        return state["sim"].to(torch.int32)


def make_gsim(qadj, qlabel):
    """Build the program + params for a pattern graph."""
    qadj = np.asarray(qadj, dtype=np.int32)
    qlabel = np.asarray(qlabel, dtype=np.int32)
    prog = GraphSimulation(payload=int(qlabel.shape[0]))
    return prog, {"qadj": qadj, "qlabel": qlabel}
