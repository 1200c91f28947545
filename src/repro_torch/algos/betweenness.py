"""Approximate betweenness centrality: K-pivot Brandes, staged queries.

Brandes' algorithm per source s needs (1) BFS distances d_s, (2) shortest
-path counts sigma_s via the BFS DAG, (3) a backward dependency
accumulation delta_s. Stage 1 is ``MultiSourceBFS``; stages 2 and 3 are
fixpoints over the DAG, each its own ``VertexProgram`` with K pivots in
[P, v_max, K] columns. Sampling K << n pivots gives the Brandes–Pich
approximation; pivots = all vertices is exact.

Replicated frontier vertices receive partial DAG sums from every replica,
merged with the delta-accumulation discipline (emit only the change in the
local partial since the last sync, so the sum-combined exchange is exact
and the emitted deltas shrink to zero):

    value = acc + pin - emitted       acc: merged global in-flow so far
                                      pin: current local partial
                                      emitted: local partial at last sync

``SigmaCount`` runs it forward (sigma flows source->sink, scattered at edge
destinations), ``BrandesAccum`` backward (delta flows sink->source,
scattered at edge sources, the per-edge ratio sigma_s/sigma_d baked into a
coefficient at init). Both gate edges on the DAG predicate ``level[src] +
1 == level[dst]`` — a per-edge, per-pivot mask, hence hand-rolled COO
sweeps whose float sums are ``scatter_add_`` along the vertex axis.

``brandes_betweenness`` glues the three stages over any query callable
(a ``GraphSession.query`` wrapper, a raw ``run_sim`` — anything returning
collected global values). Unweighted, simple graphs; not monotone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Tuple

import numpy as np
import torch

from repro_torch.algos._scatter import scatter_sum
from repro_torch.algos.bfs import make_msbfs
from repro_torch.core.api import DeviceSubgraph, VertexProgram

INF = float("inf")


def _local_rows(sg: DeviceSubgraph, table: torch.Tensor,
                fill: float) -> torch.Tensor:
    """Gather a global [n, K] table into the [P, v_max, K] local rows
    (``fill`` at padded rows)."""
    idx = torch.clamp(sg.vid32, 0, table.shape[0] - 1).long()
    return torch.where(sg.vmask[..., None], table[idx], fill)


def _dag_mask(sg: DeviceSubgraph, lev: torch.Tensor) -> torch.Tensor:
    """[P, e_max, K] — edges on some shortest path (one level down)."""
    ls = sg.gather(lev, sg.esrc)
    return sg.emask[..., None] & torch.isfinite(ls) & \
        (ls + 1.0 == sg.gather(lev, sg.edst))


def _nonzero_frontier(sg: DeviceSubgraph, merged) -> torch.Tensor:
    return ((merged != 0).any(dim=-1) & sg.frontier).sum(
        dim=-1, dtype=torch.int32)


def _changed(new, old) -> torch.Tensor:
    return (new != old).any(dim=-1).sum(dim=-1, dtype=torch.int32)


@dataclasses.dataclass
class SigmaCount(VertexProgram):
    """Shortest-path counts sigma over the BFS DAG (forward fixpoint)."""

    supports_edge_backends: ClassVar[Tuple[str, ...]] = ("coo",)

    combiner: str = "sum"
    payload: int = 4               # K pivots; set at construction
    dtype: object = np.float32
    delta_based: bool = True
    monotone: bool = False

    def init(self, sg: DeviceSubgraph, params, ec):
        lev = _local_rows(sg, params["levels"], INF)
        dag = _dag_mask(sg, lev)
        seed = ((sg.vid32[..., None] == params["pivots"]) &
                sg.vmask[..., None]).to(torch.float32)
        zeros = torch.zeros_like(seed)
        return {"sigma": seed, "seed": seed, "dag": dag, "pin": zeros,
                "acc": zeros, "emitted": zeros}

    def apply_frontier(self, sg, params, state, merged, ec):
        f = sg.frontier[..., None]
        acc = torch.where(f, state["acc"] + merged, state["acc"])
        emitted = torch.where(f, state["pin"], state["emitted"])
        sigma = torch.where(f, state["seed"] + acc, state["sigma"])
        return {"sigma": sigma, "seed": state["seed"], "dag": state["dag"],
                "pin": state["pin"], "acc": acc,
                "emitted": emitted}, _nonzero_frontier(sg, merged)

    def sweep(self, sg, params, state, ec):
        sigma = state["sigma"]
        contrib = torch.where(state["dag"], sg.gather(sigma, sg.esrc), 0.0)
        pin = ec.sum(scatter_sum(sg, contrib, sg.edst))
        new = torch.where(sg.vmask[..., None],
                          state["seed"] + state["acc"] + pin
                          - state["emitted"], sigma)
        return {"sigma": new, "seed": state["seed"], "dag": state["dag"],
                "pin": pin, "acc": state["acc"],
                "emitted": state["emitted"]}, _changed(new, sigma)

    def frontier_out(self, sg, params, state):
        return torch.where(sg.frontier[..., None],
                           state["pin"] - state["emitted"], 0.0)

    def result(self, sg, params, state):
        return state["sigma"]


@dataclasses.dataclass
class BrandesAccum(VertexProgram):
    """Backward dependency accumulation delta over the BFS DAG."""

    supports_edge_backends: ClassVar[Tuple[str, ...]] = ("coo",)

    combiner: str = "sum"
    payload: int = 4               # K pivots; set at construction
    dtype: object = np.float32
    delta_based: bool = True
    monotone: bool = False

    def init(self, sg: DeviceSubgraph, params, ec):
        lev = _local_rows(sg, params["levels"], INF)
        dag = _dag_mask(sg, lev)
        sigl = _local_rows(sg, params["sigma"], 0.0)
        ss, sd = sg.gather(sigl, sg.esrc), sg.gather(sigl, sg.edst)
        coef = torch.where(dag & (sd > 0),
                           ss / torch.where(sd > 0, sd, 1.0), 0.0)
        zeros = torch.zeros_like(sigl)
        return {"delta": zeros, "coef": coef, "pout": zeros,
                "acc": zeros, "emitted": zeros}

    def apply_frontier(self, sg, params, state, merged, ec):
        f = sg.frontier[..., None]
        acc = torch.where(f, state["acc"] + merged, state["acc"])
        emitted = torch.where(f, state["pout"], state["emitted"])
        delta = torch.where(f, acc, state["delta"])
        return {"delta": delta, "coef": state["coef"], "pout": state["pout"],
                "acc": acc, "emitted": emitted}, \
            _nonzero_frontier(sg, merged)

    def sweep(self, sg, params, state, ec):
        delta = state["delta"]
        coef = state["coef"]
        contrib = coef * (1.0 + sg.gather(delta, sg.edst))
        pout = ec.sum(scatter_sum(sg, torch.where(coef > 0, contrib, 0.0),
                                  sg.esrc))
        new = torch.where(sg.vmask[..., None],
                          state["acc"] + pout - state["emitted"], delta)
        return {"delta": new, "coef": coef, "pout": pout,
                "acc": state["acc"],
                "emitted": state["emitted"]}, _changed(new, delta)

    def frontier_out(self, sg, params, state):
        return torch.where(sg.frontier[..., None],
                           state["pout"] - state["emitted"], 0.0)

    def result(self, sg, params, state):
        return state["delta"]


def brandes_betweenness(query: Callable[[VertexProgram, Any], Any],
                        pivots, undirected: bool = True) -> Dict[str, Any]:
    """Staged K-pivot Brandes over any engine entry point.

    ``query(program, params)`` must return collected global values ([n] or
    [n, K]) — e.g. ``lambda p, pp: sess.pg.collect(sess.query(p, pp)[0])``.
    Returns the per-stage arrays plus ``bc``: the dependency sum over
    pivots with the standard v != s exclusion, halved for undirected graphs
    (each undirected shortest path is seen from both directions)."""
    pivots = np.asarray(pivots, np.int32)
    K = int(pivots.shape[0])

    prog, p = make_msbfs(pivots)
    levels = np.asarray(query(prog, p), np.float32)

    sigma = np.asarray(query(SigmaCount(payload=K),
                             {"pivots": pivots, "levels": levels}),
                       np.float32)

    delta = np.asarray(query(BrandesAccum(payload=K),
                             {"levels": levels, "sigma": sigma}),
                       np.float32)

    not_pivot = np.arange(levels.shape[0])[:, None] != pivots[None, :]
    bc = (delta * not_pivot).sum(axis=1)
    if undirected:
        bc = bc / 2.0
    return {"levels": levels, "sigma": sigma, "delta": delta, "bc": bc}
