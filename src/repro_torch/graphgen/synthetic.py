"""Synthetic graph generators used by tests and benchmarks.

- ``powerlaw_graph``: Zipf out-degree sampler, P(degree=d) ~ d^-alpha
  (paper §3 Eq. 1; alpha in [2,3] for real-world graphs).
- ``ring_graph`` / ``grid_graph``: large-diameter graphs standing in for the
  USARoad road network regime (paper §8, SSSP on large-diameter graphs).
- ``random_graph``: Erdos-Renyi-ish for property tests.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def powerlaw_graph(n_vertices: int, alpha: float = 2.2, *, avg_degree: int = 8,
                   seed: int = 0, weighted: bool = False,
                   undirected: bool = False) -> Graph:
    rng = np.random.default_rng(seed)
    # Zipf-distributed out-degrees, clipped and rescaled to the target mean.
    deg = rng.zipf(alpha, size=n_vertices).astype(np.int64)
    deg = np.minimum(deg, n_vertices - 1)
    scale = avg_degree / max(deg.mean(), 1e-9)
    deg = np.maximum((deg * scale).astype(np.int64), 0)
    src = np.repeat(np.arange(n_vertices, dtype=np.int64), deg)
    # Preferential-style destinations: mix of uniform and hub-biased picks so
    # max in-degree is also skewed (hubs), like the WebBase/LiveJournal stats.
    n_e = src.shape[0]
    hubs = rng.integers(0, max(n_vertices // 100, 1), size=n_e)
    unif = rng.integers(0, n_vertices, size=n_e)
    take_hub = rng.random(n_e) < 0.15
    dst = np.where(take_hub, hubs, unif).astype(np.int64)
    w = None
    if weighted:
        w = rng.uniform(1.0, 10.0, size=n_e).astype(np.float32)
    g = Graph(n_vertices, src, dst, w).drop_self_loops().dedup()
    if undirected:
        g = g.as_undirected()
    return g


def ring_graph(n_vertices: int, *, weighted: bool = False, seed: int = 0) -> Graph:
    """Cycle graph — diameter n/2; the adversarial case for vertex-centric."""
    v = np.arange(n_vertices, dtype=np.int64)
    src = v
    dst = (v + 1) % n_vertices
    w = None
    if weighted:
        rng = np.random.default_rng(seed)
        w = rng.uniform(1.0, 10.0, size=src.shape).astype(np.float32)
    return Graph(n_vertices, src, dst, w).as_undirected()


def grid_graph(side: int, *, weighted: bool = False, seed: int = 0) -> Graph:
    """side x side 4-neighbour grid — the road-network (USARoad) stand-in."""
    n = side * side
    idx = np.arange(n, dtype=np.int64)
    r, c = idx // side, idx % side
    edges = []
    right = (r * side + c + 1)[c < side - 1]
    edges.append(np.stack([idx[c < side - 1], right], 1))
    down = ((r + 1) * side + c)[r < side - 1]
    edges.append(np.stack([idx[r < side - 1], down], 1))
    e = np.concatenate(edges, 0)
    w = None
    if weighted:
        rng = np.random.default_rng(seed)
        w = rng.uniform(1.0, 10.0, size=e.shape[0]).astype(np.float32)
    return Graph(n, e[:, 0], e[:, 1], w).as_undirected()


def random_graph(n_vertices: int, n_edges: int, *, seed: int = 0,
                 weighted: bool = False, undirected: bool = False) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, size=n_edges).astype(np.int64)
    dst = rng.integers(0, n_vertices, size=n_edges).astype(np.int64)
    w = None
    if weighted:
        w = rng.uniform(1.0, 10.0, size=n_edges).astype(np.float32)
    g = Graph(n_vertices, src, dst, w).drop_self_loops().dedup()
    if undirected:
        g = g.as_undirected()
    return g
