"""Host substrate parity: graphs, generators, partitioners and padded
``PartitionedGraph`` arrays of the port are bit-identical to the JAX
package's for the same inputs and seeds."""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.graphgen as RG
import repro_torch.core as T
import repro_torch.graphgen as TG
from repro.core.subgraph import ShapePolicy as RShapePolicy
from repro_torch.core.subgraph import ShapePolicy as TShapePolicy

GENERATORS = [
    ("kronecker", lambda m: m.kronecker_graph(10, seed=7)),
    ("kronecker_weighted", lambda m: m.kronecker_graph(9, seed=3,
                                                       weighted=True)),
    ("powerlaw", lambda m: m.powerlaw_graph(1000, seed=5, weighted=True)),
    ("powerlaw_undirected", lambda m: m.powerlaw_graph(800, seed=2,
                                                       undirected=True)),
    ("grid", lambda m: m.grid_graph(32, weighted=True, seed=9)),
    ("ring", lambda m: m.ring_graph(500, weighted=True, seed=1)),
    ("random", lambda m: m.random_graph(600, 2400, seed=4, weighted=True)),
]


def _graph_arrays(g):
    return dict(n=g.n_vertices, src=g.src, dst=g.dst, w=g.weights,
                directed=g.directed, out=g.out_degrees(), inn=g.in_degrees(),
                iso=g.isolated_vertices())


def _assert_same(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, (what, k)
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"{what}.{k}")
            assert np.asarray(x).dtype == np.asarray(y).dtype, (what, k)
        else:
            assert x == y, (what, k, x, y)


@pytest.mark.parametrize("name,make", GENERATORS,
                         ids=[g[0] for g in GENERATORS])
def test_generators_bit_identical(name, make):
    _assert_same(_graph_arrays(make(RG)), _graph_arrays(make(TG)), name)


def _pg_arrays(pg):
    d = {f.name: getattr(pg, f.name) for f in dataclasses.fields(pg)
         if f.name != "edge_layouts"}
    return d


@pytest.mark.parametrize("partitioner", ["cdbh", "rh-vc", "grid", "range",
                                         "rh-ec", "greedy-ec"])
@pytest.mark.parametrize("n_parts", [4, 6])
def test_partitioned_graph_bit_identical(partitioner, n_parts):
    rg = RG.powerlaw_graph(900, seed=5, weighted=True).as_undirected()
    tg = TG.powerlaw_graph(900, seed=5, weighted=True).as_undirected()
    np.testing.assert_array_equal(
        R.PARTITIONERS[partitioner](rg, n_parts, seed=1),
        T.PARTITIONERS[partitioner](tg, n_parts, seed=1))
    _assert_same(_pg_arrays(R.partition_and_build(rg, n_parts, partitioner)),
                 _pg_arrays(T.partition_and_build(tg, n_parts, partitioner)),
                 partitioner)


@pytest.mark.parametrize("policy", [dict(), dict(growth=1.5, headroom=1.2,
                                                 pad_multiple=16)])
def test_bucketed_build_bit_identical(policy):
    from repro.core.subgraph import build_partitioned_graph as rbuild
    from repro_torch.core.subgraph import build_partitioned_graph as tbuild
    rg = RG.kronecker_graph(10, seed=7)
    tg = TG.kronecker_graph(10, seed=7)
    part = T.PARTITIONERS["cdbh"](tg, 8)
    _assert_same(_pg_arrays(rbuild(rg, part, 8,
                                   shape_policy=RShapePolicy(**policy))),
                 _pg_arrays(tbuild(tg, part, 8,
                                   shape_policy=TShapePolicy(**policy))),
                 "bucketed")


def test_shape_policy_and_metrics_match():
    for kw in (dict(), dict(growth=1.3, headroom=1.1, pad_multiple=4),
               dict(growth=1.0)):
        rp, tp = RShapePolicy(**kw), TShapePolicy(**kw)
        for n in (0, 1, 7, 8, 9, 100, 1000, 12345):
            assert rp.bucket(n) == tp.bucket(n)
            assert rp.slot_capacity(n) == tp.slot_capacity(n)
    rg = RG.kronecker_graph(9, seed=2)
    tg = TG.kronecker_graph(9, seed=2)
    rm = R.partition_metrics(R.partition_and_build(rg, 8))
    tm = T.partition_metrics(T.partition_and_build(tg, 8))
    assert dataclasses.asdict(rm) == dataclasses.asdict(tm)
    assert str(rm) == str(tm)


@pytest.mark.parametrize("n,hi,dtype", [(0, 1, np.int64), (1, 1, np.int64),
                                        (5000, 40, np.int32),
                                        (200_000, 1 << 40, np.int64)])
def test_unique_sorted_equals_np_unique(n, hi, dtype):
    """The port's sort-based ``unique_sorted`` gives ``np.unique``'s sorted
    distinct values and dtype (the layouts, builders and EBV use it)."""
    from repro_torch.core.graph import unique_sorted
    a = np.random.default_rng(n).integers(-hi, hi, n).astype(dtype)
    got, want = unique_sorted(a), np.unique(a)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
