"""The algorithm suite through the port's ``GraphSession`` against the JAX
package's: vertex labels laid out array for array, array params uploaded
to the session's device, the runner cache and warm memory keyed like the
reference's (two MSBFS root sets share one runner and not one warm entry),
BFS / MSBFS / triangles on every edge backend, graph simulation through a
session, and the harness's fresh-vs-incremental check per warm polarity
(MSBFS under inserts, k-core under deletes) with both packages driven by
the same delta schedule."""
import numpy as np
import pytest
import torch

import repro.algos as RA
import repro.core as R
import repro.graphgen as RG
import repro_torch.algos as TA
import repro_torch.core as T
from harness import _drop_pairs, _undirected_pairs, canonicalize
from repro.algos.gsim import make_gsim as r_make_gsim
from repro.core import EngineConfig as RCfg
from repro.session import GraphSession as RSession
from repro_torch.algos.gsim import make_gsim as t_make_gsim
from repro_torch.core import EngineConfig as TCfg
from repro_torch.core.engine import params_to_device
from repro_torch.session import GraphSession as TSession

QADJ = np.array([[0, 1, 1], [0, 0, 1], [0, 0, 0]], np.int32)
QLABEL = np.array([0, 1, 2], np.int32)


def _pair(n, seed):
    """The same canonical power-law graph from each package."""
    rg = canonicalize(RG.powerlaw_graph(n, seed=seed))
    tg = T.Graph(rg.n_vertices, rg.src.copy(), rg.dst.copy())
    return rg, tg


@pytest.mark.parametrize("part", ["cdbh", "rh-vc", "range"])
def test_set_vertex_labels_matches_reference(part):
    rg, tg = _pair(300, 3)
    labels = np.random.default_rng(1).integers(0, 5, rg.n_vertices)
    rpg = R.partition_and_build(rg, 5, part)
    tpg = T.partition_and_build(tg, 5, part)
    rpg.set_vertex_labels(labels.astype(np.int32))
    tpg.set_vertex_labels(labels)
    assert tpg.vlabel.dtype == np.int32 == rpg.vlabel.dtype
    np.testing.assert_array_equal(tpg.vlabel, rpg.vlabel)
    sgs = T.engine._device_subgraph(tpg, "cpu")
    np.testing.assert_array_equal(sgs.vlabel.numpy(), rpg.vlabel)


def test_params_to_device_keeps_structure_and_dtypes():
    p = {"a": np.arange(3, dtype=np.int32), "b": [np.ones(2), 7],
         "c": torch.zeros(2, dtype=torch.int64), "d": np.float64(2.5),
         "e": np.asarray(4)}
    out = params_to_device(p, torch.device("cpu"))
    assert isinstance(out["a"], torch.Tensor) and out["a"].dtype == \
        torch.int32
    assert out["b"][0].dtype == torch.float64 and out["b"][1] == 7
    assert out["c"].dtype == torch.int64
    assert out["d"] == 2.5 and not isinstance(out["d"], torch.Tensor)
    assert not isinstance(out["e"], torch.Tensor)


def test_array_params_reach_the_session_device():
    """Array leaves arrive in ``init`` as tensors on the session's device
    with their dtype, and the result equals the plain numpy-params run."""
    seen = {}

    class Probe(TA.MultiSourceBFS):
        def init(self, sg, params, ec):
            seen.update({k: (type(v), v.device, v.dtype)
                         for k, v in params.items()})
            return super().init(sg, params, ec)

    _, tg = _pair(200, 1)
    sess = TSession.from_graph(tg, 4, device="cpu")
    roots = np.array([0, 5, 9], np.int32)
    got, _ = sess.query(Probe(payload=3), {"sources": roots,
                                           "unused": np.ones(2, np.float64)})
    assert seen["sources"] == (torch.Tensor, sess.device, torch.int32)
    assert seen["unused"] == (torch.Tensor, sess.device, torch.float64)
    want, _ = sess.query(*TA.make_msbfs(roots))
    np.testing.assert_array_equal(got, want)


def test_msbfs_roots_share_a_runner_not_a_warm_entry():
    rg, tg = _pair(300, 2)
    rs = RSession.from_graph(rg, 4, "cdbh")
    ts = TSession.from_graph(tg, 4, "cdbh", device="cpu")
    a, b = np.array([0, 7, 11, 40], np.int32), np.array([1, 2, 3, 4],
                                                         np.int32)
    for roots in (a, b, a):
        rprog, rp = RA.make_msbfs(roots)
        tprog, tp = TA.make_msbfs(roots)
        r, rst = rs.query(rprog, rp)
        t, tst = ts.query(tprog, tp)
        np.testing.assert_array_equal(ts.pg.collect(t, fill=np.inf),
                                      rs.pg.collect(r, fill=np.inf))
        assert (tst.supersteps, tst.total_messages) == \
            (rst.supersteps, rst.total_messages)
    assert ts.stats.runner_builds == rs.stats.cache_misses == 1
    assert ts.stats.cache_hits == 2
    assert ts.stats.warm_queries == rs.stats.warm_queries == 1
    assert len(ts._warm) == 2


@pytest.mark.parametrize("eb", ["coo", "pallas_tiles", "pallas_windows"])
def test_kernel_programs_through_sessions(eb):
    rg, tg = _pair(300, 5)
    rs = RSession.from_graph(rg, 4, "cdbh")
    ts = TSession.from_graph(tg, 4, "cdbh", device="cpu")
    pv = np.array([0, 100, 150, 299], np.int32)
    for name, rcase, tcase in (
            ("bfs", (RA.BFS(), {"source": 3}), (TA.BFS(), {"source": 3})),
            ("msbfs", RA.make_msbfs(pv), TA.make_msbfs(pv)),
            ("triangles", RA.make_triangles(pv), TA.make_triangles(pv))):
        r, rst = rs.query(*rcase, warm=False, cfg=RCfg(edge_backend=eb))
        t, tst = ts.query(*tcase, warm=False, cfg=TCfg(edge_backend=eb))
        np.testing.assert_array_equal(ts.pg.collect(t), rs.pg.collect(r),
                                      err_msg=name)
        assert (tst.supersteps, tst.total_messages, tst.processed_edges,
                tst.edge_backend) == (rst.supersteps, rst.total_messages,
                                      rst.processed_edges, eb), name
        assert len(tst.partition_sweeps) == ts.pg.n_parts
        assert int(np.dot(tst.partition_sweeps, ts.pg.edges_per_part)) == \
            tst.processed_edges


def test_gsim_through_sessions():
    rg, tg = _pair(300, 6)
    labels = np.random.default_rng(2).integers(0, 3, rg.n_vertices)
    rpg = R.partition_and_build(rg, 4, "cdbh")
    tpg = T.partition_and_build(tg, 4, "cdbh")
    rpg.set_vertex_labels(labels.astype(np.int32))
    tpg.set_vertex_labels(labels)
    rs, ts = RSession(rpg), TSession(tpg, device="cpu")
    assert ts.shape_key == rs.shape_key and ts.shape_key[-1]
    r, rst = rs.query(*r_make_gsim(QADJ, QLABEL))
    t, tst = ts.query(*t_make_gsim(QADJ, QLABEL))
    np.testing.assert_array_equal(tpg.collect(t), rpg.collect(r))
    assert (tst.supersteps, tst.total_messages) == \
        (rst.supersteps, rst.total_messages)
    assert tpg.collect(t).sum() > 0


@pytest.mark.parametrize("algo", ["msbfs", "kcore2", "kcore3"])
def test_fresh_vs_incremental(algo):
    """The harness's streaming check on both packages: a delta schedule of
    the program's ``warm_under`` polarity; after every flush the port's
    warm answer equals its cold recompute and the reference's warm answer,
    in no more supersteps than cold and in the reference's count."""
    rg, tg = _pair(300, 8)
    pv = np.array([0, 100, 150, 299], np.int32)
    if algo == "msbfs":
        rmake, tmake = (lambda: RA.make_msbfs(pv)), (lambda: TA.make_msbfs(pv))
    else:
        k = int(algo[-1])
        rmake, tmake = (lambda: RA.make_kcore(k)), (lambda: TA.make_kcore(k))
    polarity = tmake()[0].warm_under
    assert polarity == rmake()[0].warm_under == \
        ("inserts" if algo == "msbfs" else "deletes")
    rng = np.random.default_rng(0)
    pairs = _undirected_pairs(rg)
    moved = [pairs[i] for i in rng.choice(len(pairs), len(pairs) // 5,
                                          replace=False)]
    chunks = [moved[i::2] for i in range(2)]
    if polarity == "inserts":
        rbase = _drop_pairs(rg, set(moved))
        tbase = T.Graph(rbase.n_vertices, rbase.src.copy(), rbase.dst.copy())
    else:
        rbase, tbase = rg, tg
    rs = RSession.from_graph(rbase, 4, "cdbh")
    ts = TSession.from_graph(tbase, 4, "cdbh", device="cpu")
    fill = np.inf if algo == "msbfs" else 0
    rs.query(*rmake())
    ts.query(*tmake())
    for chunk in chunks:
        s = np.array([p[0] for p in chunk] + [p[1] for p in chunk], np.int64)
        d = np.array([p[1] for p in chunk] + [p[0] for p in chunk], np.int64)
        for sess in (rs, ts):
            if polarity == "inserts":
                sess.update(adds=(s, d, np.ones(len(s), np.float32)))
            else:
                sess.update(deletes=(s, d))
            sess.flush()
        rw, rwst = rs.query(*rmake(), warm=True)
        tw, twst = ts.query(*tmake(), warm=True)
        tc, tcst = ts.query(*tmake(), warm=False)
        got_w = ts.pg.collect(tw, fill=fill)
        np.testing.assert_array_equal(got_w, ts.pg.collect(tc, fill=fill))
        np.testing.assert_array_equal(got_w, rs.pg.collect(rw, fill=fill))
        assert twst.supersteps <= tcst.supersteps
        assert (twst.supersteps, twst.total_messages) == \
            (rwst.supersteps, rwst.total_messages)
    assert ts.stats.warm_queries == rs.stats.warm_queries == len(chunks)
