"""Graph partitioners (paper §6), host-side numpy.

Vertex-cut (edge-partitioning) assigns *edges* to partitions:
  - ``random_hash_vertex_cut``  — RH: hash the (canonical) edge key.
  - ``cdbh_vertex_cut``         — Canonical Degree-Based Hashing, the paper's
    default: hash the endpoint with the *smaller full degree*, after sorting
    the endpoint pair by id so (u,v) and (v,u) co-locate (§6.3).
  - ``grid_vertex_cut``         — 2D grid-constrained vertex-cut.
  - ``range_vertex_cut``        — id-range blocks (locality-preserving).

Edge-cut (vertex-partitioning) assigns *vertices* to partitions; an edge is
stored with its source's partition:
  - ``random_hash_edge_cut``    — the DRONE-EC baseline.
  - ``greedy_edge_cut``         — LDG-style greedy streaming edge-cut.

Stateful-streaming vertex-cut:
  - ``"ebv"``                   — the EBV router of ``repro_torch.partition``
    (a ``StatefulRouterSpec`` in ``STREAM_ROUTERS``: its placement depends
    on every edge routed before, so a stream carries its state).

All functions give the same assignment, bit for bit, as the JAX package's
partitioners.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np

from repro_torch.core.graph import Graph, splitmix64

__all__ = [
    "random_hash_vertex_cut", "cdbh_vertex_cut", "grid_vertex_cut",
    "range_vertex_cut", "random_hash_edge_cut", "greedy_edge_cut",
    "PARTITIONERS", "route_edges_rh_vc", "route_edges_cdbh",
    "route_edges_grid", "route_edges_range", "route_edges_rh_ec",
    "route_vertices_rh", "STREAM_ROUTERS", "StatefulRouterSpec",
    "is_stateful_router",
]


def _canonical(src: np.ndarray, dst: np.ndarray):
    return np.minimum(src, dst), np.maximum(src, dst)


# --------------------------------------------------------------------------- #
# Pure per-edge routing: raw endpoint arrays -> int32 partition id per edge
# --------------------------------------------------------------------------- #
def route_edges_rh_vc(src: np.ndarray, dst: np.ndarray, n_parts: int,
                      *, seed: int = 0) -> np.ndarray:
    """RH vertex-cut: uniformly hash the canonical edge key."""
    lo, hi = _canonical(src, dst)
    key = splitmix64(lo.astype(np.uint64) * np.uint64(0x9E3779B1)
                     ^ splitmix64(hi.astype(np.uint64) + np.uint64(seed)))
    return (key % np.uint64(n_parts)).astype(np.int32)


def route_edges_cdbh(src: np.ndarray, dst: np.ndarray, degrees: np.ndarray,
                     n_parts: int, *, seed: int = 0) -> np.ndarray:
    """CDBH: hash the endpoint with the smaller full degree (canonically
    ordered pair; ties broken on id)."""
    lo, hi = _canonical(src, dst)
    dl, dh = degrees[lo], degrees[hi]
    pick_lo = (dl < dh) | ((dl == dh) & (lo <= hi))
    chosen = np.where(pick_lo, lo, hi)
    key = splitmix64(chosen.astype(np.uint64) + np.uint64(seed))
    return (key % np.uint64(n_parts)).astype(np.int32)


def route_edges_range(src: np.ndarray, dst: np.ndarray, n_vertices: int,
                      n_parts: int) -> np.ndarray:
    """Id-range block of the canonical lower endpoint."""
    lo, _ = _canonical(src, dst)
    return ((lo.astype(np.uint64) * np.uint64(n_parts))
            // np.uint64(max(n_vertices, 1))).astype(np.int32)


def route_edges_grid(src: np.ndarray, dst: np.ndarray, n_parts: int,
                     *, seed: int = 0) -> np.ndarray:
    """2D grid placement in an r x c layout with r*c == P, ``r`` the largest
    divisor of P at most sqrt(P)."""
    r = 1
    for d in range(int(np.sqrt(n_parts)), 1, -1):
        if n_parts % d == 0:
            r = d
            break
    c = n_parts // r
    lo, hi = _canonical(src, dst)
    hu = splitmix64(lo.astype(np.uint64) + np.uint64(seed)) % np.uint64(r)
    hv = splitmix64(hi.astype(np.uint64) + np.uint64(seed ^ 0xABCDEF)) \
        % np.uint64(c)
    return (hu * np.uint64(c) + hv).astype(np.int32)


def route_vertices_rh(vids: np.ndarray, n_parts: int,
                      *, seed: int = 0) -> np.ndarray:
    """RH vertex->partition hash (edge-cut placement + isolated vertices)."""
    return (splitmix64(vids.astype(np.uint64) + np.uint64(seed))
            % np.uint64(n_parts)).astype(np.int32)


def route_edges_rh_ec(src: np.ndarray, dst: np.ndarray, n_parts: int,
                      *, seed: int = 0) -> np.ndarray:
    """RH edge-cut: an edge follows its source's vertex hash."""
    del dst
    return route_vertices_rh(src, n_parts, seed=seed)


@dataclasses.dataclass(frozen=True)
class StatefulRouterSpec:
    """A *stateful-streaming* ``STREAM_ROUTERS`` entry: a factory of the
    mutable router state a ``StreamContext`` carries (``ctx.router_state``)
    instead of a chunk function. ``make_state(n_parts, n_vertices, seed)``
    imports ``factory_module`` when first called (the partition package
    builds on this one). Membership tests (``name in STREAM_ROUTERS``) keep
    working: a stateful partitioner is streamable."""

    name: str
    factory_module: str
    factory_name: str

    def make_state(self, n_parts: int, n_vertices: int, seed: int = 0):
        fn = getattr(importlib.import_module(self.factory_module),
                     self.factory_name)
        return fn(n_parts, n_vertices, seed=seed)

    @property
    def stateful(self) -> bool:
        return True


def is_stateful_router(entry) -> bool:
    """True for ``STREAM_ROUTERS`` entries that need per-stream state."""
    return isinstance(entry, StatefulRouterSpec)


# Streamable routers under one chunk signature:
#   router(src, dst, degrees, n_vertices, n_parts, seed) -> int32[chunk]
# (or a StatefulRouterSpec — see is_stateful_router)
STREAM_ROUTERS = {
    "rh-vc": lambda s, d, deg, nv, p, seed: route_edges_rh_vc(s, d, p, seed=seed),
    "cdbh": lambda s, d, deg, nv, p, seed: route_edges_cdbh(s, d, deg, p, seed=seed),
    "grid": lambda s, d, deg, nv, p, seed: route_edges_grid(s, d, p, seed=seed),
    "range": lambda s, d, deg, nv, p, seed: route_edges_range(s, d, nv, p),
    "rh-ec": lambda s, d, deg, nv, p, seed: route_edges_rh_ec(s, d, p, seed=seed),
    "ebv": StatefulRouterSpec("ebv", "repro_torch.partition.ebv",
                              "EBVRouterState"),
}


# --------------------------------------------------------------------------- #
# Partitioners over a Graph
# --------------------------------------------------------------------------- #
def random_hash_vertex_cut(g: Graph, n_parts: int, *, seed: int = 0) -> np.ndarray:
    return route_edges_rh_vc(g.src, g.dst, n_parts, seed=seed)


def cdbh_vertex_cut(g: Graph, n_parts: int, *, seed: int = 0,
                    degrees: np.ndarray | None = None) -> np.ndarray:
    """Canonical Degree-Based Hashing (paper §6.3): hub endpoints are cut,
    their edges spread by their low-degree neighbours' hashes."""
    if degrees is None:
        degrees = g.total_degrees()
    return route_edges_cdbh(g.src, g.dst, degrees, n_parts, seed=seed)


def range_vertex_cut(g: Graph, n_parts: int, *, seed: int = 0) -> np.ndarray:
    """Locality-preserving vertex-cut by the id-range block of the canonical
    lower endpoint (road networks / meshes with locality-coherent ids)."""
    del seed
    return route_edges_range(g.src, g.dst, g.n_vertices, n_parts)


def grid_vertex_cut(g: Graph, n_parts: int, *, seed: int = 0) -> np.ndarray:
    return route_edges_grid(g.src, g.dst, n_parts, seed=seed)


def random_hash_edge_cut(g: Graph, n_parts: int, *, seed: int = 0) -> np.ndarray:
    return route_edges_rh_ec(g.src, g.dst, n_parts, seed=seed)


def greedy_edge_cut(g: Graph, n_parts: int, *, seed: int = 0,
                    n_chunks: int = 64) -> np.ndarray:
    """Linear Deterministic Greedy (LDG) streaming edge-cut: assign each
    vertex to the partition maximizing |neighbours already there| *
    (1 - |P_i|/capacity)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(g.n_vertices)
    vpart = np.full(g.n_vertices, -1, dtype=np.int32)
    sizes = np.zeros(n_parts, dtype=np.int64)
    cap = g.n_vertices / n_parts * 1.1 + 1
    und = np.concatenate([np.stack([g.src, g.dst], 1),
                          np.stack([g.dst, g.src], 1)], 0)
    und = und[np.argsort(und[:, 0], kind="stable")]
    starts = np.searchsorted(und[:, 0], np.arange(g.n_vertices + 1))
    for chunk in np.array_split(order, min(n_chunks, len(order))):
        for v in chunk:
            nbrs = und[starts[v]:starts[v + 1], 1]
            np_parts = vpart[nbrs]
            np_parts = np_parts[np_parts >= 0]
            if np_parts.size:
                counts = np.bincount(np_parts, minlength=n_parts)
            else:
                counts = np.zeros(n_parts)
            score = counts * np.maximum(1.0 - sizes / cap, 0.0)
            best = int(np.argmax(score + rng.random(n_parts) * 1e-9))
            vpart[v] = best
            sizes[best] += 1
    return vpart[g.src].astype(np.int32)


def _ebv_vertex_cut(g: Graph, n_parts: int, *, seed: int = 0) -> np.ndarray:
    """EBV one-shot entry (imported on use: the partition package builds
    on this module)."""
    from repro_torch.partition.ebv import ebv_vertex_cut
    return ebv_vertex_cut(g, n_parts, seed=seed)


PARTITIONERS = {
    "rh-vc": random_hash_vertex_cut,
    "cdbh": cdbh_vertex_cut,
    "grid": grid_vertex_cut,
    "range": range_vertex_cut,
    "rh-ec": random_hash_edge_cut,
    "greedy-ec": greedy_edge_cut,
    "ebv": _ebv_vertex_cut,
}
