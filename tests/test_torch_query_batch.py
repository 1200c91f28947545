"""Micro-batching parity: ``query_batch`` of a JAX ``GraphSession`` and of
the port's, on the same graph, per edge backend (the reference's Pallas
kernels in interpret mode), lane by lane — results, supersteps, messages
and per-partition work bit-identical for SSSP and CC, PageRank within
rtol = atol = 1e-5, ``batch_size`` equal — plus the batched runners'
``sweeps[B, P]`` against each other, warm starts per lane, the edge cases
(fan-out, structure mismatch, B = 0, B = 1, trace), and one scripted run of
a ``SessionPool`` with a ``MicroBatcher`` whose ``SessionStats`` counters
equal the reference's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.algos as RA
import repro.graphgen as RG
import repro_torch.algos as TA
import repro_torch.graphgen as TG
from repro.core import EngineConfig as RCfg
from repro.core import partition_and_build as rpartition
from repro.core.engine import _device_subgraph as rdevice
from repro.core.engine import _layout_block_from as rlayout
from repro.core.engine import make_sim_runner as rmake
from repro.serving import BatchPolicy as RPolicy
from repro.serving import MicroBatcher as RBatcher
from repro.serving import ResultCache as RResultCache
from repro.serving import SessionPool as RPool
from repro.session import GraphSession as RSession
from repro_torch.core import EngineConfig as TCfg
from repro_torch.core import partition_and_build as tpartition
from repro_torch.core.engine import _device_subgraph as tdevice
from repro_torch.core.engine import _layout_block_from as tlayout
from repro_torch.core.engine import make_sim_runner as tmake
from repro_torch.serving import BatchPolicy as TPolicy
from repro_torch.serving import MicroBatcher as TBatcher
from repro_torch.serving import ResultCache as TResultCache
from repro_torch.serving import SessionPool as TPool
from repro_torch.session import GraphSession as TSession

TOL = dict(rtol=1e-5, atol=1e-5)
EDGE_BACKENDS = ["coo", "pallas_tiles", "pallas_windows", "auto"]
# SessionStats fields the tests hold equal, under the port's name -> the
# reference's. Left out: compile_time_total (build vs
# XLA compile seconds), runner_cache_bytes (runner_nbytes' shape estimate
# vs XLA's memory_analysis), partition_sweep_time (host clock) and the
# port's own host_syncs.
COUNTERS = {
    "queries": "queries", "cache_hits": "cache_hits",
    "runner_builds": "cache_misses", "warm_queries": "warm_queries",
    "flushes": "flushes", "compactions": "compactions",
    "uploads": "uploads", "cache_evictions_lru": "cache_evictions_lru",
    "cache_evictions_shape": "cache_evictions_shape",
    "warm_evictions": "warm_evictions",
    "warm_cache_bytes": "warm_cache_bytes",
    "warm_remaps_applied": "warm_remaps_applied",
    "device_launches": "device_launches", "batches": "batches",
    "batched_queries": "batched_queries",
    "result_cache_l1_hits": "result_cache_l1_hits",
    "result_cache_l2_hits": "result_cache_l2_hits",
    "result_cache_misses": "result_cache_misses",
    "rebalances": "rebalances", "load_imbalance": "load_imbalance",
    "partition_edge_counts": "partition_edge_counts",
    "tile_density_min": "tile_density_min",
    "tile_density_mean": "tile_density_mean",
    "tile_density_max": "tile_density_max"}


@dataclasses.dataclass
class RFixedPageRank(RA.PageRank):
    """PageRank with the vertex count as a field: a leafless, non-monotone
    program (its lanes fan out from one query)."""
    n: int = 1

    def init(self, sg, params, ec):
        return super().init(sg, {"n_vertices": self.n}, ec)


@dataclasses.dataclass
class TFixedPageRank(TA.PageRank):
    n: int = 1

    def init(self, sg, params, ec):
        return super().init(sg, {"n_vertices": self.n}, ec)


@pytest.fixture(autouse=True)
def _isolated_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("DRONE_AUTOTUNE_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def graphs():
    rg = RG.powerlaw_graph(400, seed=7, weighted=True).as_undirected()
    tg = TG.powerlaw_graph(400, seed=7, weighted=True).as_undirected()
    return rg, tg


def _sessions(graphs, eb, **kw):
    rg, tg = graphs
    return (RSession.from_graph(rg, 4, "cdbh", cfg=RCfg(edge_backend=eb),
                                **kw),
            TSession.from_graph(tg, 4, "cdbh", cfg=TCfg(edge_backend=eb),
                                device="cpu", **kw))


def _same_lane(r, t, tag, exact=True):
    (ra, rst), (ta, tst) = r, t
    ra = np.asarray(ra)
    if exact:
        np.testing.assert_array_equal(ta, ra, err_msg=tag)
        assert ta.dtype == ra.dtype, tag
        assert (tst.supersteps, tst.total_messages, tst.processed_edges) \
            == (rst.supersteps, rst.total_messages, rst.processed_edges), tag
        # per-partition sweeps times per-partition work per sweep
        assert tst.partition_flops == rst.partition_flops, tag
    else:
        np.testing.assert_allclose(ta, ra, err_msg=tag, **TOL)
    assert tst.batch_size == rst.batch_size, tag
    assert tst.edge_backend == rst.edge_backend, tag


def _assert_counters(rst, tst, where):
    for tname, rname in COUNTERS.items():
        assert getattr(tst, tname) == getattr(rst, rname), \
            (where, tname, getattr(tst, tname), getattr(rst, rname))


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("eb", EDGE_BACKENDS)
def test_batch_lanes_equal_reference_and_singletons(graphs, eb):
    rs, ts = _sessions(graphs, eb)
    n = ts.pg.n_vertices
    first = {}
    for name, rp, tp, plist, exact in (
            ("sssp", RA.SSSP(), TA.SSSP(),
             [{"source": s} for s in (0, 5, 17)], True),
            ("cc", RA.ConnectedComponents(), TA.ConnectedComponents(),
             [None, None], True),
            ("pagerank", RA.PageRank(), TA.PageRank(),
             [{"n_vertices": n}] * 2, False)):
        singles = [ts.query(tp, p, warm=False) for p in plist]
        first[name] = singles[0][0]
        for p in plist:
            rs.query(rp, p, warm=False)
        rout = rs.query_batch(rp, plist, warm=False)
        tout = ts.query_batch(tp, plist, warm=False)
        assert len(tout) == len(plist)
        for i, (r, t) in enumerate(zip(rout, tout)):
            tag = f"{eb} {name} lane {i}"
            _same_lane(r, t, tag, exact)
            assert t[1].batch_size == len(plist), tag
            if exact:
                np.testing.assert_array_equal(t[0], singles[i][0],
                                              err_msg=tag)
                assert (t[1].supersteps, t[1].total_messages,
                        t[1].partition_sweeps) == \
                    (singles[i][1].supersteps, singles[i][1].total_messages,
                     singles[i][1].partition_sweeps), tag
            else:
                np.testing.assert_allclose(t[0], singles[i][0], **TOL)
    # B = 3 padded to the 4-lane bucket: a 4-lane batch builds nothing
    builds = ts.stats.runner_builds
    rs.query_batch(RA.SSSP(), [{"source": s} for s in range(4)], warm=False)
    out4 = ts.query_batch(TA.SSSP(), [{"source": s} for s in range(4)],
                          warm=False)
    assert ts.stats.runner_builds == builds
    np.testing.assert_array_equal(out4[0][0], first["sssp"])
    _assert_counters(rs.stats, ts.stats, eb)
    assert len(ts._runners) == len(rs._runners)


@pytest.mark.parametrize("eb", ["coo", "pallas_windows"])
def test_batched_runner_sweeps_equal_reference(graphs, eb):
    """The two packages' batched runners on one partitioned graph: results
    [B, ...], supersteps [B], messages [B] and sweeps [B, P] equal."""
    rg, tg = graphs
    rpg, tpg = rpartition(rg, 4, "cdbh"), tpartition(tg, 4, "cdbh")
    sources = [0, 9, 33]
    rp, tp = RA.SSSP(), TA.SSSP()
    rcfg, tcfg = RCfg(edge_backend=eb), TCfg(edge_backend=eb)
    ident = np.full((len(sources), rpg.n_parts, rpg.v_max, 1), np.inf,
                    np.float32)
    rrun = rmake(rp, rcfg, rpg.n_slots, warm_start=True, batch=True)
    trun = tmake(tp, tcfg, tpg.n_slots, warm_start=True, batch=True)
    rargs = (rdevice(rpg),)
    tlay = None
    if eb != "coo":
        rargs += (rlayout(rpg.ensure_edge_layouts(), rpg, rp, eb),)
        tlay = tlayout(tpg.ensure_edge_layouts(), tpg, tp, eb, "cpu")
    rargs += ({"source": jnp.asarray(sources, jnp.int32)},
              jnp.asarray(ident))
    rres, rsteps, rmsgs, rsweeps = rrun(*rargs)
    tres, tsteps, tmsgs, tsweeps, syncs = trun(
        tdevice(tpg, "cpu"), tlay, [{"source": s} for s in sources],
        torch.from_numpy(ident))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(rres))
    np.testing.assert_array_equal(tsteps, np.asarray(rsteps))
    np.testing.assert_array_equal(tmsgs, np.asarray(rmsgs))
    np.testing.assert_array_equal(tsweeps, np.asarray(rsweeps))
    assert tsweeps.shape == (len(sources), tpg.n_parts) and syncs > 0


def test_warm_lanes_equal_reference(graphs):
    rs, ts = _sessions(graphs, "coo")
    for s in (0, 5):
        rs.query(RA.SSSP(), {"source": s})
        ts.query(TA.SSSP(), {"source": s})
    rng = np.random.default_rng(3)
    src = rng.integers(0, ts.pg.n_vertices, 20)
    dst = rng.integers(0, ts.pg.n_vertices, 20)
    w = rng.uniform(1, 5, 20).astype(np.float32)
    for sess in (rs, ts):
        sess.update(adds=(src, dst, w))
        sess.flush()
    plist = [{"source": s} for s in (0, 5, 11)]
    rout = rs.query_batch(RA.SSSP(), plist)
    tout = ts.query_batch(TA.SSSP(), plist)
    for i, (r, t) in enumerate(zip(rout, tout)):
        _same_lane(r, t, f"warm lane {i}")
    rs.query(RA.SSSP(), {"source": 0}, warm=False)
    cold = ts.query(TA.SSSP(), {"source": 0}, warm=False)
    np.testing.assert_array_equal(tout[0][0], cold[0])
    assert tout[0][1].supersteps <= cold[1].supersteps
    assert ts.stats.warm_queries == rs.stats.warm_queries == 2
    for sess, prog in ((rs, RA.SSSP()), (ts, TA.SSSP())):
        with pytest.raises(ValueError, match="warm=True"):
            sess.query_batch(prog, [{"source": 0}, {"source": 77}],
                             warm=True)
    _assert_counters(rs.stats, ts.stats, "warm lanes")


def test_edge_cases_equal_reference(graphs):
    rs, ts = _sessions(graphs, "coo")
    n = ts.pg.n_vertices
    # leafless lanes of a non-monotone program: one singleton, fanned out
    rout = rs.query_batch(RFixedPageRank(n=n), [None] * 3)
    tout = ts.query_batch(TFixedPageRank(n=n), [None] * 3)
    assert len(tout) == 3
    for i, (r, t) in enumerate(zip(rout, tout)):
        _same_lane(r, t, f"fan-out lane {i}", exact=False)
        assert t[1].batch_size == 3
    assert ts.stats.device_launches == rs.stats.device_launches == 1
    assert ts.stats.batches == rs.stats.batches == 0
    # CC is monotone: its leafless lanes run as a batch
    ts.query_batch(TA.ConnectedComponents(), [None, None])
    rs.query_batch(RA.ConnectedComponents(), [None, None])
    assert ts.stats.batches == rs.stats.batches == 1
    for sess, prog in ((rs, RA.SSSP()), (ts, TA.SSSP())):
        with pytest.raises(ValueError, match="structure"):
            sess.query_batch(prog, [{"source": 0}, {"bad": 1}])
        with pytest.raises(ValueError, match="structure"):
            sess.query_batch(prog, [{"source": 0},
                                    {"source": np.array([1], np.int32)}])
        assert sess.query_batch(prog, []) == []
        with pytest.raises(ValueError, match="trace"):
            sess.query_batch(prog, [{"source": 0}, {"source": 1}],
                             cfg=(RCfg if sess is rs else TCfg)(trace=True))
    # B = 1 is a plain query
    r1 = rs.query_batch(RA.SSSP(), [{"source": 3}], warm=False)
    t1 = ts.query_batch(TA.SSSP(), [{"source": 3}], warm=False)
    _same_lane(r1[0], t1[0], "B = 1")
    assert t1[0][1].batch_size == 1
    _assert_counters(rs.stats, ts.stats, "edge cases")


def test_pool_and_batcher_script_counters_equal_reference(graphs):
    """One scripted run of a pool (two tenants, a shared result cache) and
    a batcher through both packages: every lane equal, and the pool's,
    the batcher's and each session's counters equal."""
    rg, tg = graphs
    rg2 = RG.powerlaw_graph(400, seed=8, weighted=True).as_undirected()
    tg2 = TG.powerlaw_graph(400, seed=8, weighted=True).as_undirected()
    clock = [0.0]

    def script(pool, bat, A, g, g2):
        a = pool.open("a", g, n_parts=4)
        b = pool.open("b", g2, n_parts=4)
        out = [pool.query("a", A.SSSP(), {"source": 0}, warm=False),
               pool.query("b", A.SSSP(), {"source": 0}, warm=False)]
        futs = [bat.submit(A.SSSP(), {"source": s}, tenant="a",
                           warm=False) for s in (1, 2, 3)]
        futs += [bat.submit(A.ConnectedComponents(), None, tenant="b")
                 for _ in range(2)]
        clock[0] = 1.0
        bat.poll()
        futs.append(bat.submit(A.SSSP(), {"source": 2}, tenant="a",
                               warm=False))           # fast path
        futs += [bat.submit(A.PageRank(), {"n_vertices": g.n_vertices},
                            tenant="a") for _ in range(2)]
        bat.flush()
        out += [f.result(timeout=60) for f in futs]
        a.update(adds=(np.array([0, 1]), np.array([7, 9]),
                       np.array([1.5, 2.5], np.float32)))
        out += pool.query_batch("a", A.SSSP(),
                                [{"source": s} for s in (1, 2, 3)])
        pool.close("b")
        return out, b.stats

    rpool = RPool(result_cache=RResultCache())
    tpool = TPool(result_cache=TResultCache(), device="cpu")
    rbat = RBatcher(rpool, RPolicy(max_batch=4, max_delay=0.5),
                    clock=lambda: clock[0])
    tbat = TBatcher(tpool, TPolicy(max_batch=4, max_delay=0.5),
                    clock=lambda: clock[0])
    rout, rb = script(rpool, rbat, RA, rg, rg2)
    clock[0] = 0.0
    tout, tb = script(tpool, tbat, TA, tg, tg2)
    assert len(tout) == len(rout) == 13
    for i, (r, t) in enumerate(zip(rout, tout)):
        _same_lane(r, t, f"scripted request {i}",
                   exact=i not in (8, 9))            # 8, 9: PageRank
        assert (t[1].result_cache_tier, t[1].queue_time) == \
            (r[1].result_cache_tier, r[1].queue_time), i
    _assert_counters(rpool.session("a").stats, tpool.session("a").stats,
                     "tenant a")
    _assert_counters(rb, tb, "tenant b")
    rst, tst = rpool.stats(), tpool.stats()
    for k in ("entries", "hits", "misses", "evictions"):
        assert tst["runner_cache"][k] == rst["runner_cache"][k], k
    assert dataclasses.asdict(tst["result_cache"]) == \
        dataclasses.asdict(rst["result_cache"])
    assert dataclasses.asdict(tbat.stats) == dataclasses.asdict(rbat.stats)
    assert tbat.stats.degraded == 0 and tbat.stats.fast_path_hits == 1
    rpool.close_all()
    tpool.close_all()
