"""k-core decomposition (fixed k): iterative peel with frontier re-election.

The k-core is the maximal subgraph where every vertex keeps degree >= k,
computed by peeling vertices of degree < k until none remain. Each
partition peels to a local fixed point per superstep and exchanges degree
*decrements* for replicated frontier vertices (GoFFish's formulation):

  post     last-synced global degree + this replica's un-synced decrements
  pending  decrements accumulated since the last SBS sync (sum-combined)
  nsync    frontier degree counts are only globally valid after one sync

Degrees count a vertex's stored out-edges whose destination is still
un-peeled (graphs stored undirected make this the undirected degree).
Between syncs a frontier replica's ``post`` is an upper bound on the true
degree, so ``post < k`` can only fire late, never wrongly. ``nsync`` is a
[P] int32 tensor on the stacked batch (a per-partition scalar under
``vmap`` in the JAX package).

Monotone under DELETES (``warm_under = "deletes"``): removing edges only
shrinks the core. ``result`` reports a *peeled* flag (1 = out of the core)
whose sum-combiner identity 0 means "no information": ``warm_init`` marks
the previously peeled set as ``must`` peel, the first local sweep re-kills
it, and the ordinary decrement machinery rebuilds every degree; an
identity-filled cold block is a no-op.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import numpy as np
import torch

from repro_torch.algos._scatter import scatter_sum
from repro_torch.core.api import DeviceSubgraph, VertexProgram


@dataclasses.dataclass
class KCore(VertexProgram):
    # per-edge alive-gated counting: COO gather/scatter only
    supports_edge_backends: ClassVar[Tuple[str, ...]] = ("coo",)
    warm_under: ClassVar[str] = "deletes"

    combiner: str = "sum"
    payload: int = 2            # lane 0: decrement sum; lane 1: sync marker
    dtype: object = np.int32
    delta_based: bool = True
    monotone: bool = True       # peeled flags only grow under deletes
    value_key: str = "peeled"
    k: int = 2

    def _dec_to_src(self, sg: DeviceSubgraph, removed, ec):
        """Degree decrements: one per local out-edge into a just-peeled
        destination, summed at the edge's source row."""
        contrib = torch.where(sg.emask,
                              sg.gather(removed.to(torch.int32), sg.edst), 0)
        return ec.sum(scatter_sum(sg, contrib, sg.esrc))

    def init(self, sg: DeviceSubgraph, params, ec):
        ldeg = ec.sum(scatter_sum(sg, sg.emask.to(torch.int32), sg.esrc))
        return {"alive": sg.vmask, "post": ldeg, "pending": ldeg,
                "must": torch.zeros_like(sg.vmask),
                "nsync": torch.zeros(sg.n_parts, dtype=torch.int32,
                                     device=sg.device)}

    def warm_init(self, sg, params, state, warm):
        peeled = warm if warm.dim() == 2 else warm[..., 0]
        state = dict(state)
        state["must"] = (peeled > 0) & sg.vmask
        return state

    def apply_frontier(self, sg, params, state, merged, ec):
        f = sg.frontier
        m = merged[..., 0]
        post = torch.where(f, state["post"] - state["pending"] + m,
                           state["post"])
        pending = torch.where(f, 0, state["pending"])
        changed = ((m != 0) & f).sum(dim=-1, dtype=torch.int32)
        return {"alive": state["alive"], "post": post, "pending": pending,
                "must": state["must"], "nsync": state["nsync"] + 1}, changed

    def sweep(self, sg, params, state, ec):
        alive, post, pending = state["alive"], state["post"], state["pending"]
        valid = sg.internal | (state["nsync"] >= 1)[:, None]
        removed = alive & sg.vmask & \
            (state["must"] | (valid & (post < self.k)))
        alive = alive & ~removed
        dec = self._dec_to_src(sg, removed, ec)
        changed = removed.sum(dim=-1, dtype=torch.int32)
        return {"alive": alive, "post": post - dec, "pending": pending - dec,
                "must": state["must"] & ~removed,
                "nsync": state["nsync"]}, changed

    def frontier_out(self, sg, params, state):
        # lane 1 is nonzero exactly until the first sync: a replica whose
        # local degree cancels to zero before any exchange (a star hub
        # losing every local leaf in superstep one) must still emit once,
        # or no sync ever happens and the ``nsync`` validity gate that
        # allows ``post < k`` to fire on frontier rows never opens
        need = sg.frontier & (state["nsync"] == 0)[:, None]
        return torch.stack([torch.where(sg.frontier, state["pending"], 0),
                            need.to(torch.int32)], dim=-1)

    def result(self, sg, params, state):
        """1 = peeled out of the k-core, 0 = still in it."""
        return (sg.vmask & ~state["alive"]).to(torch.int32)


def make_kcore(k: int):
    """(program, params) for the fixed-k peel."""
    if k < 1:
        raise ValueError(f"k={k}: the k-core peel needs k >= 1")
    return KCore(k=k), {}
