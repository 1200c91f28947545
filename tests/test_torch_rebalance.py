"""The port's load monitor and online rebalancer against the JAX package's:
the monitor's gauge and trigger sequence on the same observations, equal
migration plans, bit-identical host arrays and ``remap_state`` after a
migration, and sessions driven by one script side by side — ``rebalance()``
with query parity and warm survival per program, ``rebalance="auto"``
firing at the same flush under churn, and an EBV session rebalanced and
then deleting through its router's pair table."""
import numpy as np
import pytest

import repro.algos as RA
import repro.graphgen as RG
import repro_torch.algos as TA
import repro_torch.graphgen as TG
from repro.core import build_partitioned_graph as rbuild
from repro.partition import monitor as RM
from repro.partition import rebalance as RR
from repro.session import GraphSession as RSession
from repro.stream.ingest import StreamContext as RContext
from repro_torch.core import build_partitioned_graph as tbuild
from repro_torch.core import partition_metrics
from repro_torch.partition import monitor as TM
from repro_torch.partition import rebalance as TR
from repro_torch.partition.ebv import RelocationOverlay
from repro_torch.session import GraphSession as TSession
from repro_torch.stream.ingest import StreamContext as TContext

TOL = dict(rtol=1e-5, atol=1e-5)
PG_ARRAYS = ("gvid", "vmask", "esrc", "edst", "ew", "emask", "slot",
             "is_frontier", "out_deg", "in_deg", "is_master")
RS_FIELDS = ("n_moved", "parts_from", "parts_to", "replicas_created",
             "imbalance_before", "imbalance_after", "v_max_before",
             "v_max_after", "e_max_before", "e_max_after", "n_slots_before",
             "n_slots_after")
PROGRAMS = {
    "sssp": (lambda: RA.SSSP(), lambda: TA.SSSP(), {"source": 0}),
    "cc": (lambda: RA.ConnectedComponents(),
           lambda: TA.ConnectedComponents(), None),
    "bfs": (lambda: RA.BFS(), lambda: TA.BFS(), {"source": 0}),
    "kcore": (lambda: RA.make_kcore(2)[0], lambda: TA.make_kcore(2)[0],
              "kcore"),
    "pagerank": (lambda: RA.PageRank(), lambda: TA.PageRank(), "pagerank"),
}


def _skewed(n_v=1500, P=4, hot=0.7, seed=5):
    """A deliberately imbalanced partition in both packages: most edges on
    part 0 (``tests/test_rebalance.py``'s fixture), with a pure-hash
    context each."""
    rg = RG.powerlaw_graph(n_v, alpha=2.2, avg_degree=6, seed=seed)
    tg = TG.powerlaw_graph(n_v, alpha=2.2, avg_degree=6, seed=seed)
    idx = np.arange(rg.src.size)
    part = np.where(idx % 10 < int(hot * 10), 0,
                    idx % (P - 1) + 1).astype(np.int32)
    deg = np.zeros(rg.n_vertices, np.int64)
    return (rg, tg, rbuild(rg, part, P), tbuild(tg, part, P),
            RContext("rh-vc", P, 0, rg.n_vertices, deg.copy()),
            TContext("rh-vc", P, 0, tg.n_vertices, deg.copy()))


def assert_same_pg(rpg, tpg, where=""):
    for name in ("n_parts", "n_vertices", "n_edges", "n_slots", "v_max",
                 "e_max"):
        assert getattr(rpg, name) == getattr(tpg, name), (where, name)
    for name in PG_ARRAYS:
        np.testing.assert_array_equal(getattr(rpg, name),
                                      getattr(tpg, name),
                                      err_msg=f"{where} {name}")


def assert_same_plan(a, b):
    assert sorted(a.moves) == sorted(b.moves)
    for p in a.moves:
        np.testing.assert_array_equal(a.moves[p][0], b.moves[p][0])
        np.testing.assert_array_equal(a.moves[p][1], b.moves[p][1])
    assert (a.imbalance_before, a.imbalance_after, a.edges_considered) == \
        (b.imbalance_before, b.imbalance_after, b.edges_considered)


def assert_same_rebalance(rrs, trs, where=""):
    for name in RS_FIELDS:
        assert getattr(rrs, name) == getattr(trs, name), (where, name)
    np.testing.assert_array_equal(rrs.remap, trs.remap, err_msg=where)


# --------------------------------------------------------------------------- #
# monitor
# --------------------------------------------------------------------------- #
class _FakePG:
    def __init__(self, epp, P=4, slots=8, frontier=()):
        self.edges_per_part = np.asarray(epp)
        self.vmask = np.zeros((P, slots), bool)
        self.is_frontier = np.zeros((P, slots), bool)
        for p, n in enumerate(frontier):
            self.vmask[p, :n] = self.is_frontier[p, :n] = True


class _St:
    def __init__(self, t=None, flops=None):
        self.partition_sweep_time = t or []
        self.partition_flops = flops or []


def test_monitor_gauge_and_trigger_sequence_equal_reference():
    _, _, rpg, tpg, _, _ = _skewed()
    hot, cool = _FakePG([100, 10, 10, 10], frontier=(8, 2, 2, 1)), \
        _FakePG([33, 33, 32, 32], frontier=(4, 4, 4, 4))
    events = ([("g", hot)] * 3 + [("q", _St([4.0, 1.0, 1.0, 2.0]))]
              + [("g", hot), ("n", None), ("g", hot), ("g", hot),
                 ("q", _St(flops=[9, 1, 1, 1])), ("g", cool), ("g", hot),
                 ("g", hot), ("q", _St([2.0, 2.0, 2.0, 2.0]))]
              + [("real", None)] * 3)
    cfg = dict(high=1.5, low=1.15, patience=2, ema=0.5, w_frontier=0.25)
    r, t = RM.LoadMonitor(RM.MonitorConfig(**cfg)), \
        TM.LoadMonitor(TM.MonitorConfig(**cfg))
    trace = []
    for kind, x in events:
        for m, pg in ((r, rpg), (t, tpg)):
            if kind == "g":
                m.observe_graph(x)
            elif kind == "real":
                m.observe_graph(pg)
            elif kind == "q":
                m.observe_query(x)
            elif m.should_rebalance():
                m.notify_rebalanced()
        assert r.signals() == t.signals(), (kind, len(trace))
        assert r.should_rebalance() == t.should_rebalance()
        np.testing.assert_array_equal(r.blended_loads(4), t.blended_loads(4))
        trace.append((t.gauge, t.should_rebalance()))
    assert (r.triggers, r.observations) == (t.triggers, t.observations)
    assert t.triggers == 1 and any(s for _, s in trace)
    assert TM.LoadMonitor().blended_loads(4) is None


# --------------------------------------------------------------------------- #
# planner + executor
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("target,frac,loads", [
    (1.05, 0.5, None), (1.0, 0.01, None), (1.2, 0.25, None),
    (1.05, 0.5, [1.0, 3.0, 0.5, 0.5])])
def test_plan_rebalance_equal(target, frac, loads):
    _, _, rpg, tpg, _, _ = _skewed()
    want = RR.plan_rebalance(rpg, target=target, max_fraction=frac,
                             loads=loads)
    got = TR.plan_rebalance(tpg, target=target, max_fraction=frac,
                            loads=loads)
    assert_same_plan(want, got)
    assert got.n_moves > 0
    assert got.n_moves <= int(frac * int(tpg.emask.sum()))


def test_execute_rebalance_host_arrays_and_remap_state_equal():
    rg, tg, rpg, tpg, rctx, tctx = _skewed(n_v=800)
    rplan = RR.plan_rebalance(rpg, target=1.0, max_fraction=0.5)
    tplan = TR.plan_rebalance(tpg, target=1.0, max_fraction=0.5)
    moved = []
    for p, (idx, dst_part) in tplan.moves.items():
        m = tpg.emask[p]
        moved.append((tpg.gvid[p][tpg.esrc[p][m]][idx],
                      tpg.gvid[p][tpg.edst[p][m]][idx], dst_part))
    tag = np.where(tpg.vmask, tpg.gvid, -1).astype(np.float64)
    rrs = RR.execute_rebalance(rpg, rctx, rplan)
    trs = TR.execute_rebalance(tpg, tctx, tplan)
    assert_same_rebalance(rrs, trs)
    assert_same_pg(rpg, tpg, "after the migration")
    for fill in (np.float64(np.inf), np.float64(-1.0)):
        np.testing.assert_array_equal(rrs.remap_state(tag, fill),
                                      trs.remap_state(tag, fill))
    assert trs.imbalance_after < trs.imbalance_before
    # the pure-hash context got a relocation overlay: moved pairs route to
    # their destination for deletes and re-adds, like the reference's
    assert isinstance(tctx.router_state, RelocationOverlay)
    for gs, gd, dst_part in moved:
        np.testing.assert_array_equal(tctx.route_deletes(gs, gd), dst_part)
        np.testing.assert_array_equal(tctx.route_adds(gd, gs),
                                      rctx.route_adds(gd, gs))
    probe = (np.arange(0, 700, 7), np.arange(700, 0, -7))
    np.testing.assert_array_equal(tctx.route(*probe), rctx.route(*probe))
    with pytest.raises(ValueError, match="StreamContext"):
        TR.execute_rebalance(tpg, None, tplan)


# --------------------------------------------------------------------------- #
# sessions side by side
# --------------------------------------------------------------------------- #
def _params(key, n_vertices):
    if key == "pagerank":
        return {"n_vertices": n_vertices}
    if key == "kcore":
        return TA.make_kcore(2)[1]
    return key


def _query(rs, ts, name, warm, where):
    rmake, tmake, key = PROGRAMS[name]
    rp, tp = rmake(), tmake()
    params = _params(key, ts.pg.n_vertices)
    rparams = RA.make_kcore(2)[1] if key == "kcore" else params
    r, rst = rs.query(rp, rparams, warm=warm)
    t, tst = ts.query(tp, params, warm=warm)
    r = np.asarray(r)
    if tp.delta_based:
        np.testing.assert_allclose(t, r, err_msg=where, **TOL)
    else:
        np.testing.assert_array_equal(t, r, err_msg=where)
        assert (tst.supersteps, tst.total_messages) == \
            (rst.supersteps, rst.total_messages), where
        assert tst.partition_flops == rst.partition_flops, where
    return t, tst


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_session_rebalance_parity_and_warm_survival(name):
    _, _, rpg, tpg, rctx, tctx = _skewed(n_v=1000)
    rs = RSession(rpg, ctx=rctx, rebalance="manual")
    ts = TSession(tpg, ctx=tctx, rebalance="manual", device="cpu")
    cold, st0 = _query(rs, ts, name, False, "cold")
    before = ts.pg.collect(cold)
    rrs = rs.rebalance(target=1.0)
    trs = ts.rebalance(target=1.0)
    assert trs is not None and trs.n_moved > 0
    assert_same_rebalance(rrs, trs)
    assert_same_pg(rs.pg, ts.pg, "after rebalance")
    assert ts.stats.rebalances == rs.stats.rebalances == 1
    warm, st1 = _query(rs, ts, name, "auto", "after rebalance")
    if name == "pagerank":
        np.testing.assert_allclose(ts.pg.collect(warm), before, **TOL)
    else:
        np.testing.assert_array_equal(ts.pg.collect(warm), before)
        assert st1.supersteps <= st0.supersteps
    assert ts.stats.warm_queries == rs.stats.warm_queries
    # the structural signals agree; the sweep-time one is each host's
    assert {k: v for k, v in ts.monitor.signals().items()
            if k != "sweep_time" and k != "gauge"} == \
        {k: v for k, v in rs.monitor.signals().items()
         if k != "sweep_time" and k != "gauge"}
    assert len(ts.stats.partition_sweep_time) == ts.pg.n_parts
    # repeated triggers converge until the graph sits under the target
    for _ in range(6):
        a, b = rs.rebalance(target=1.2), ts.rebalance(target=1.2)
        assert (a is None) == (b is None)
        if b is None:
            break
        assert_same_rebalance(a, b)
    assert ts.rebalance(target=1.2) is None
    assert partition_metrics(ts.pg).imbalance <= 1.2 * 1.05


def test_session_rebalance_validation():
    g = TG.powerlaw_graph(300, alpha=2.2, avg_degree=4, seed=0)
    with pytest.raises(ValueError, match="rebalance"):
        TSession.from_graph(g, 2, "cdbh", rebalance="sometimes",
                            device="cpu")
    from repro_torch.core import partition_and_build
    sess = TSession(partition_and_build(g, 2, "cdbh"), device="cpu")
    with pytest.raises(ValueError, match="rebalance"):
        sess.rebalance()


def test_session_auto_rebalance_under_churn_same_flush():
    """Streaming churn on a skewed partition trips the gauge at the same
    flush in both packages, exactly once, with the same imbalance after."""
    _, _, rpg, tpg, rctx, tctx = _skewed(n_v=1200, hot=0.8, seed=9)
    cfg = dict(high=1.5, low=1.15, patience=2)
    rmon = RM.LoadMonitor(RM.MonitorConfig(**cfg))
    tmon = TM.LoadMonitor(TM.MonitorConfig(**cfg))
    rs = RSession(rpg, ctx=rctx, rebalance="auto", monitor=rmon)
    ts = TSession(tpg, ctx=tctx, rebalance="auto", monitor=tmon,
                  device="cpu")
    imb0 = partition_metrics(tpg).imbalance
    assert imb0 > 2.0
    rng = np.random.default_rng(3)
    fired = []
    for step in range(4):
        adds = (rng.integers(0, 1200, 50), rng.integers(0, 1200, 50))
        rs.update(adds=adds)
        ts.update(adds=adds)
        rs.flush()
        ts.flush()
        assert (ts.stats.rebalances, tmon.triggers) == \
            (rs.stats.rebalances, rmon.triggers), step
        assert ts.stats.load_imbalance == rs.stats.load_imbalance, step
        assert_same_pg(rs.pg, ts.pg, f"flush {step}")
        fired.append(ts.stats.rebalances)
    assert fired[-1] == 1 and tmon.triggers == 1
    assert partition_metrics(ts.pg).imbalance < imb0
    _, st = _query(rs, ts, "cc", False, "after churn")
    assert len(st.partition_edge_counts) == ts.pg.n_parts
    assert ts.stats.partition_edge_counts == st.partition_edge_counts


def test_session_ebv_end_to_end_rebalance_then_deletes():
    """EBV sessions: a manual rebalance keeps the router state consistent
    (resync), so deletes of original edges still find their copies."""
    rg = RG.powerlaw_graph(1000, alpha=2.2, avg_degree=5, seed=7)
    tg = TG.powerlaw_graph(1000, alpha=2.2, avg_degree=5, seed=7)
    rs = RSession.from_graph(rg, 4, "ebv", rebalance="manual")
    ts = TSession.from_graph(tg, 4, "ebv", rebalance="manual", device="cpu")
    assert_same_pg(rs.pg, ts.pg, "ebv build")
    r0, _ = _query(rs, ts, "cc", False, "before")
    rrs, trs = rs.rebalance(target=1.0), ts.rebalance(target=1.0)
    assert (rrs is None) == (trs is None)
    if trs is not None:
        assert_same_rebalance(rrs, trs)
    for name in ("replicas", "edge_load", "replica_load"):
        np.testing.assert_array_equal(getattr(rs.ctx.router_state, name),
                                      getattr(ts.ctx.router_state, name))
    rs.update(deletes=(rg.src[:100], rg.dst[:100]))
    ts.update(deletes=(tg.src[:100], tg.dst[:100]))
    rs.flush()
    ts.flush()
    assert int(ts.pg.emask.sum()) == tg.src.size - 100
    assert_same_pg(rs.pg, ts.pg, "after deletes")
    r1, _ = _query(rs, ts, "cc", False, "after deletes")
    assert ts.pg.collect(r1).shape == ts.pg.collect(r0).shape
