"""Graph500-style Kronecker (R-MAT) graph generator (paper §8.1, Fig 9).

The paper's weak-scaling study uses the Kronecker generator of Leskovec et al.
[arXiv:0812.4905] with Graph500 parameters. Graph500's reference generator is
the recursive-matrix (R-MAT) sampler with (A,B,C,D) = (0.57, 0.19, 0.19, 0.05)
and edge factor 16. We reproduce exactly that, vectorized in numpy.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph

GRAPH500_A = 0.57
GRAPH500_B = 0.19
GRAPH500_C = 0.19
GRAPH500_D = 0.05
GRAPH500_EDGE_FACTOR = 16


def rmat_edges(scale: int, n_edges: int, *, a: float = GRAPH500_A,
               b: float = GRAPH500_B, c: float = GRAPH500_C,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Sample ``n_edges`` edges of a 2^scale-vertex R-MAT graph."""
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for bit in range(scale):
        ii = rng.random(n_edges) > ab
        jj = rng.random(n_edges) > np.where(ii, c_norm, a_norm)
        src += ii.astype(np.int64) << bit
        dst += jj.astype(np.int64) << bit
    # Graph500 permutes vertex labels so degree is not correlated with id.
    perm = rng.permutation(1 << scale).astype(np.int64)
    return perm[src], perm[dst]


def kronecker_graph(scale: int, *, edge_factor: int = GRAPH500_EDGE_FACTOR,
                    seed: int = 0, undirected: bool = True,
                    weighted: bool = False) -> Graph:
    n = 1 << scale
    m = edge_factor * n
    src, dst = rmat_edges(scale, m, seed=seed)
    w = None
    if weighted:
        rng = np.random.default_rng(seed + 1)
        w = rng.uniform(1.0, 10.0, size=src.shape).astype(np.float32)
    g = Graph(n, src, dst, w).drop_self_loops().dedup()
    if undirected:
        g = g.as_undirected()
    return g
