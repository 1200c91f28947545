"""Session parity: the port's read-only ``GraphSession`` against the JAX
package's on the same graph — collected results of SSSP, CC and PageRank,
a warm repeat of an SSSP query, and the runner cache's contract (a repeated
query builds nothing)."""
import numpy as np
import pytest

import repro.algos as RA
import repro.graphgen as RG
import repro_torch.algos as TA
import repro_torch.graphgen as TG
from repro.core import EngineConfig as RCfg
from repro.session import GraphSession as RSession
from repro_torch.core import EngineConfig as TCfg
from repro_torch.session import GraphSession as TSession

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def sessions():
    rs = RSession.from_graph(RG.kronecker_graph(10, seed=7), 8, "cdbh")
    ts = TSession.from_graph(TG.kronecker_graph(10, seed=7), 8, "cdbh",
                             device="cpu")
    return rs, ts


def test_same_partitioned_graph_and_shapes(sessions):
    rs, ts = sessions
    assert rs.shape_key == ts.shape_key
    assert rs.slot_capacity == ts.slot_capacity
    for name in ("gvid", "esrc", "edst", "ew", "slot", "is_master"):
        np.testing.assert_array_equal(getattr(rs.pg, name),
                                      getattr(ts.pg, name))


@pytest.mark.parametrize("eb", ["coo", "pallas_tiles", "pallas_windows"])
def test_query_parity_with_warm_repeat(sessions, eb):
    rs, ts = sessions
    rcfg, tcfg = RCfg(edge_backend=eb), TCfg(edge_backend=eb)
    n = rs.pg.n_vertices
    for rprog, tprog, params, exact in (
            (RA.SSSP(), TA.SSSP(), {"source": 5}, True),
            (RA.ConnectedComponents(), TA.ConnectedComponents(), None, True),
            (RA.PageRank(), TA.PageRank(), {"n_vertices": n}, False)):
        r, rst = rs.query(rprog, params, warm=False, cfg=rcfg)
        t, tst = ts.query(tprog, params, warm=False, cfg=tcfg)
        rc = rs.pg.collect(r, fill=rprog.identity)
        tc = ts.pg.collect(t, fill=tprog.identity)
        assert tc.dtype == rc.dtype
        if exact:
            np.testing.assert_array_equal(tc, rc)
            assert (tst.supersteps, tst.total_messages,
                    tst.processed_edges) == (rst.supersteps,
                                             rst.total_messages,
                                             rst.processed_edges)
        else:
            np.testing.assert_allclose(tc, rc, **TOL)
        assert tst.edge_backend == eb
    # warm repeat of the SSSP query: both restart from the remembered result
    r, rst = rs.query(RA.SSSP(), {"source": 5}, warm=True, cfg=rcfg)
    t, tst = ts.query(TA.SSSP(), {"source": 5}, warm=True, cfg=tcfg)
    np.testing.assert_array_equal(ts.pg.collect(t), rs.pg.collect(r))
    assert (tst.supersteps, tst.total_messages) == \
        (rst.supersteps, rst.total_messages)


def test_repeated_query_reuses_runner():
    g = TG.kronecker_graph(9, seed=1)
    sess = TSession.from_graph(g, 4, device="cpu")
    sess.query(TA.SSSP(), {"source": 0})
    builds = sess.stats.runner_builds
    _, st = sess.query(TA.SSSP(), {"source": 0})      # warm repeat
    _, st2 = sess.query(TA.SSSP(), {"source": np.int64(9)})   # new value
    _, st3 = sess.query(TA.SSSP(), {"source": 3}, warm=False)
    assert sess.stats.runner_builds == builds
    assert st.compile_time == st2.compile_time == st3.compile_time == 0.0
    assert sess.stats.warm_queries == 1 and sess.stats.cache_hits == 3
    sess.query(TA.SSSP(), {"source": 0}, cfg=TCfg(mode="vc"))
    assert sess.stats.runner_builds == builds + 1       # new config key
    assert sess.stats.uploads == 1


def test_warm_true_requires_a_result_and_monotone_program():
    sess = TSession.from_graph(TG.ring_graph(64), 2, device="cpu")
    with pytest.raises(ValueError, match="no previous converged result"):
        sess.query(TA.SSSP(), {"source": 0}, warm=True)
    with pytest.raises(ValueError, match="not monotone"):
        sess.query(TA.PageRank(), {"n_vertices": 64}, warm=True)


def test_trace_query_delegates_to_run_sim(sessions):
    rs, ts = sessions
    r, rst = rs.query(RA.ConnectedComponents(), warm=False,
                      cfg=RCfg(trace=True))
    t, tst = ts.query(TA.ConnectedComponents(), warm=False,
                      cfg=TCfg(trace=True))
    np.testing.assert_array_equal(t, r)
    assert tst.messages_per_step == rst.messages_per_step


def test_lru_bounds():
    sess = TSession.from_graph(TG.ring_graph(64), 2, device="cpu",
                               max_runners=1, max_warm_entries=1)
    sess.query(TA.SSSP(), {"source": 0})
    sess.query(TA.ConnectedComponents())
    assert sess.stats.cache_evictions_lru == 1
    assert sess.stats.warm_evictions == 1
    assert len(sess._runners) == 1 and len(sess._warm) == 1
