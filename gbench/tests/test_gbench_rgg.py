"""The DIMACS10 random geometric graph: the edge set against an all-pairs
check in numpy, the edge count against the analytic expectation, and the
``EdgeList`` layout."""
import math

import numpy as np
import pytest
import torch

from gbench.generators import rgg

RGG = {"scale": 10, "radius_factor": 0.55}


def _expected_edges(n, r):
    """C(n, 2) times the chance that two uniform points of the unit square
    lie closer than r (r <= 1): pi r^2 - 8 r^3 / 3 + r^4 / 2."""
    return n * (n - 1) / 2 * (math.pi * r**2 - 8 * r**3 / 3 + r**4 / 2)


def test_edges_are_the_all_pairs_check_in_cell_order():
    g = rgg.generate(RGG, 3, "cpu")
    xy = rgg.points(RGG, 3, "cpu").numpy()
    n = xy.shape[0]
    r = rgg.radius(n, 0.55)
    m = math.floor(1 / r)
    # ids: by cell row, then cell column, then draw order
    cells = np.floor(xy * m).astype(np.int64)
    order = np.lexsort((np.arange(n), cells[:, 0], cells[:, 1]))
    p = xy[order]
    d = np.sqrt(np.square(p[None, :, :] - p[:, None, :]).sum(-1))
    lo, hi = np.nonzero(np.triu(d < r, k=1))
    assert g.n_vertices == n
    k = g.n_undirected
    assert np.array_equal(g.src[:k].numpy(), lo)
    assert np.array_equal(g.dst[:k].numpy(), hi)
    assert np.array_equal(g.w[:k].numpy(), d[lo, hi].astype(np.float32))


def test_edge_count_near_the_analytic_expectation():
    cfg = {"scale": 16, "radius_factor": 0.55}
    n = 1 << 16
    want = _expected_edges(n, rgg.radius(n, 0.55))
    assert want == pytest.approx(343259, abs=1)
    got = rgg.generate(cfg, 1, "cpu").n_undirected
    assert abs(got - want) <= 0.01 * want


def test_edge_list_layout_and_seed():
    g = rgg.generate(RGG, 5, "cpu")
    k = g.n_undirected
    lo, hi = g.src[:k], g.dst[:k]
    assert torch.equal(g.src[k:], hi) and torch.equal(g.dst[k:], lo)
    assert torch.equal(g.w[k:], g.w[:k])
    assert bool((lo < hi).all())
    key = lo * g.n_vertices + hi
    assert bool((key[1:] > key[:-1]).all())          # ascending, no repeat
    assert g.w.dtype == torch.float32 and bool((g.w > 0).all())
    again = rgg.generate(RGG, 5, "cpu")
    assert torch.equal(again.src, g.src) and torch.equal(again.w, g.w)
    assert not torch.equal(rgg.generate(RGG, 6, "cpu").w[:k].sum(),
                           g.w[:k].sum())
