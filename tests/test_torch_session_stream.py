"""Session streaming parity: a JAX ``GraphSession`` and the port's, driven
by the same ``update``/``push``/``flush``/``compact`` script, compared query
by query on SSSP, CC and PageRank for each edge backend — results,
supersteps, messages and per-partition work bit-identical (PageRank allclose
at rtol = atol = 1e-5), warm-auto supersteps equal, and the sessions'
runner builds, shape evictions, uploads, flushes, compactions and warm
remaps equal the reference's compile and eviction counts."""
import copy
import dataclasses

import numpy as np
import pytest

import repro.algos as RA
import repro.graphgen as RG
import repro.stream as RS
import repro_torch.algos as TA
import repro_torch.graphgen as TG
import repro_torch.stream as TS
from repro.core import EngineConfig as RCfg
from repro.session import GraphSession as RSession
from repro_torch.core import EngineConfig as TCfg
from repro_torch.session import GraphSession as TSession

TOL = dict(rtol=1e-5, atol=1e-5)
# session counters of the port and the reference's name for each
COUNTERS = {"queries": "queries", "cache_hits": "cache_hits",
            "runner_builds": "cache_misses", "warm_queries": "warm_queries",
            "flushes": "flushes", "compactions": "compactions",
            "uploads": "uploads",
            "cache_evictions_shape": "cache_evictions_shape",
            "cache_evictions_lru": "cache_evictions_lru",
            "warm_evictions": "warm_evictions",
            "warm_remaps_applied": "warm_remaps_applied"}


def _graphs(n, seed):
    rg = RG.powerlaw_graph(n, seed=seed, weighted=True).as_undirected()
    tg = TG.powerlaw_graph(n, seed=seed, weighted=True).as_undirected()
    return rg, tg


def _queries(n_vertices):
    return [("sssp", RA.SSSP(), TA.SSSP(), {"source": 0}, "auto"),
            ("sssp_cold", RA.SSSP(), TA.SSSP(), {"source": 0}, False),
            ("cc", RA.ConnectedComponents(), TA.ConnectedComponents(), None,
             "auto"),
            ("pagerank", RA.PageRank(), TA.PageRank(),
             {"n_vertices": n_vertices}, "auto")]


def assert_same_query(rs, ts, where):
    """Every query of ``_queries`` on both sessions agrees."""
    out = {}
    for name, rp, tp, params, warm in _queries(rs.pg.n_vertices):
        r, rst = rs.query(rp, params, warm=warm)
        t, tst = ts.query(tp, params, warm=warm)
        tag = f"{where} {name}"
        assert tst.edge_backend == rst.edge_backend, tag
        if rp.delta_based:
            np.testing.assert_allclose(t, r, err_msg=tag, **TOL)
        else:
            np.testing.assert_array_equal(t, r, err_msg=tag)
            assert t.dtype == r.dtype, tag
            assert (tst.supersteps, tst.total_messages,
                    tst.processed_edges) == (rst.supersteps,
                                             rst.total_messages,
                                             rst.processed_edges), tag
            # per-partition sweeps times per-partition work per sweep
            assert tst.partition_flops == rst.partition_flops, tag
        out[name] = (t, tst)
    # warm-auto and cold agree on the value (warm is only faster)
    np.testing.assert_array_equal(out["sssp"][0], out["sssp_cold"][0])
    return out


def assert_same_counters(rs, ts, where):
    for tname, rname in COUNTERS.items():
        assert getattr(ts.stats, tname) == getattr(rs.stats, rname), \
            (where, tname, getattr(ts.stats, tname),
             getattr(rs.stats, rname))
    assert ts.shape_key == rs.shape_key, where
    assert len(ts._runners) == len(rs._runners), where
    assert len(ts._warm) == len(rs._warm), where
    for name in ("gvid", "esrc", "edst", "ew", "slot", "is_master"):
        np.testing.assert_array_equal(getattr(rs.pg, name),
                                      getattr(ts.pg, name), err_msg=where)


def _crossing_edges(sess, rng, dim):
    """Just enough new edges, all routed to the fullest partition, to push
    its edge count (``dim="e"``) or its member count (``dim="v"``, through
    brand-new ids) one past the current padded capacity."""
    pg, ctx = sess.pg, sess.ctx
    V = pg.n_vertices
    if dim == "e":
        p = int(np.argmax(pg.edges_per_part))
        need = pg.e_max - int(pg.edges_per_part[p]) + 1
        src, dst = rng.integers(0, V, 40 * need), rng.integers(0, V, 40 * need)
    else:
        p = int(np.argmax(pg.vertices_per_part))
        need = pg.v_max - int(pg.vertices_per_part[p]) + 1
        src = np.arange(V, V + 40 * need)      # a new id routes by its hash
        dst = rng.integers(0, V, src.shape[0])
    ctx = copy.deepcopy(ctx)
    ctx.grow(int(src.max()) + 1)
    mine = ctx.route(src, dst) == p
    src, dst = src[mine], dst[mine]
    # distinct pairs: the session's buffer merges repeated ones
    _, first = np.unique(src * (4 * V) + dst, return_index=True)
    keep = np.sort(first)[:need]
    src, dst = src[keep], dst[keep]
    assert src.shape[0] == need
    return src, dst, rng.uniform(1, 9, need).astype(np.float32)


def _both(rs, ts, fn):
    """Apply the same mutation to both sessions (``fn(sess, stream_mod)``)
    and return both results."""
    return fn(rs, RS), fn(ts, TS)


@pytest.mark.parametrize("eb,n", [("coo", 2000), ("pallas_windows", 2000),
                                  ("pallas_tiles", 500)])
def test_update_flush_compact_script(eb, n):
    rg, tg = _graphs(n, 21)
    kw = dict(max_buffer_edges=64)
    rs = RSession.from_graph(rg, 4, "cdbh", cfg=RCfg(edge_backend=eb), **kw)
    ts = TSession.from_graph(tg, 4, "cdbh", cfg=TCfg(edge_backend=eb),
                             device="cpu", **kw)
    assert_same_query(rs, ts, "initial")
    assert_same_counters(rs, ts, "initial")
    rng = np.random.default_rng(4)
    V, E = rg.n_vertices, rg.n_edges

    # 1. an in-bucket insert batch, flushed by hand: warm entries survive
    s, d = rng.integers(0, V, 40), rng.integers(0, V, 40)
    w = rng.uniform(1, 9, 40).astype(np.float32)
    rst, tst = _both(rs, ts, lambda x, m: (x.update(adds=(s, d, w)),
                                           x.flush())[1])
    assert tst.n_added == rst.n_added == 40 and tst.warm_start_safe
    out = assert_same_query(rs, ts, "insert")
    assert out["sssp"][1].supersteps <= out["sssp_cold"][1].supersteps
    assert_same_counters(rs, ts, "insert")

    # 2. single-edge updates past the buffer bound: auto-flushes, and the
    # query flushes the tail
    for i in range(150):
        a, b = (int(x) for x in rng.integers(0, V, 2))
        _both(rs, ts, lambda x, m: x.update(adds=([a], [b], [1.5])))
    assert ts.buffer.stats.auto_flushes == rs.buffer.stats.auto_flushes > 1
    assert len(ts.buffer) == len(rs.buffer)
    assert_same_query(rs, ts, "auto-flush")
    assert_same_counters(rs, ts, "auto-flush")

    # 3. a batch across the e_max bucket into the fullest partition, then
    # 4. new ids across the v_max bucket, through a whole EdgeDelta
    key0 = ts.shape_key
    big = _crossing_edges(ts, rng, "e")
    _both(rs, ts, lambda x, m: x.push(m.EdgeDelta(*big)))
    assert_same_query(rs, ts, "e_max growth")
    assert ts.shape_key[2] > key0[2]
    grow = _crossing_edges(ts, rng, "v")
    _both(rs, ts, lambda x, m: x.update(adds=grow))
    assert_same_query(rs, ts, "v_max growth")
    assert ts.shape_key[1] > key0[1]
    assert_same_counters(rs, ts, "growth")
    assert ts.stats.cache_evictions_shape > 0

    # 5. a delete batch: every warm entry of the 'inserts' polarity goes
    pick = rng.random(rg.n_edges) < 0.3
    rst, tst = _both(rs, ts, lambda x, m: (
        x.update(deletes=(rg.src[pick], rg.dst[pick])), x.flush())[1])
    assert tst.n_deleted == rst.n_deleted > 0 and not tst.warm_start_safe
    assert len(ts._warm) == 0
    assert_same_query(rs, ts, "delete")
    assert_same_counters(rs, ts, "delete")

    # 6. compact: warm results ride the remap chain
    rcs, tcs = _both(rs, ts, lambda x, m: x.compact())
    for f in dataclasses.fields(rcs):
        np.testing.assert_array_equal(getattr(tcs, f.name),
                                      getattr(rcs, f.name))
    out = assert_same_query(rs, ts, "compact")
    assert_same_counters(rs, ts, "compact")
    assert ts.stats.warm_remaps_applied > 0
    assert out["sssp"][1].supersteps <= out["sssp_cold"][1].supersteps


def test_kernel_queries_after_flush_use_rebuilt_device_lists():
    """The device list a kernel query uploads after a flush is a new object
    built from the patched geometry; queries see the mutated graph."""
    rg, tg = _graphs(800, 3)
    ts = TSession.from_graph(tg, 4, "cdbh", device="cpu")
    rs = RSession.from_graph(rg, 4, "cdbh")
    for eb in ("pallas_windows", "pallas_tiles"):
        ts.query(TA.SSSP(), {"source": 1}, cfg=TCfg(edge_backend=eb))
    lay = ts.pg.edge_layouts
    before = dict(lay._device)
    assert before
    # an edge into vertex 5 from a brand-new vertex far from everything
    new = rg.n_vertices
    for x in (rs, ts):
        x.update(adds=([1, new], [new, 5], [0.25, 0.25]))
        x.flush()
    assert not lay._device or ts.pg.edge_layouts is not lay
    for eb in ("pallas_windows", "pallas_tiles"):
        t, _ = ts.query(TA.SSSP(), {"source": 1}, warm=False,
                        cfg=TCfg(edge_backend=eb))
        r, _ = rs.query(RA.SSSP(), {"source": 1}, warm=False,
                        cfg=RCfg(edge_backend=eb))
        np.testing.assert_array_equal(t, r)
        assert ts.pg.collect(t, fill=np.inf)[new] == np.float32(0.25)
    after = ts.pg.edge_layouts._device
    assert all(after[k] is not v for k, v in before.items() if k in after)


def test_from_edge_log_parity(tmp_path):
    rg, tg = _graphs(1500, 9)
    RS.write_edge_log(rg, str(tmp_path / "log"), chunk_size=2048)
    rs = RSession.from_edge_log(str(tmp_path / "log"), 4, "cdbh")
    ts = TSession.from_edge_log(str(tmp_path / "log"), 4, "cdbh",
                                device="cpu")
    assert ts.ingest_stats.n_edges == rs.ingest_stats.n_edges
    assert ts.ingest_stats.peak_stream_bytes == \
        rs.ingest_stats.peak_stream_bytes
    assert ts.slot_capacity == rs.slot_capacity
    assert_same_query(rs, ts, "from_edge_log")
    s = np.arange(0, 40)
    for x in (rs, ts):
        x.update(adds=(s, s[::-1] + 7, np.full(40, 2.0, np.float32)))
    assert_same_query(rs, ts, "from_edge_log update")
    assert_same_counters(rs, ts, "from_edge_log")


def test_flush_returns_last_auto_flush_and_readonly_refuses():
    rg, tg = _graphs(600, 2)
    ts = TSession.from_graph(tg, 4, "cdbh", device="cpu",
                             max_buffer_edges=8)
    assert ts.flush() is None
    ts.update(adds=(np.arange(8), np.arange(8) + 1))
    st = ts.flush()                    # the threshold already flushed
    assert st is ts.buffer.last_flush and st.n_added == 8
    ro = TSession(ts.pg, device="cpu")
    for call in (lambda: ro.update(adds=([0], [1])), ro.flush, ro.compact,
                 lambda: ro.push(TS.EdgeDelta())):
        with pytest.raises(ValueError, match="StreamContext"):
            call()
    with pytest.raises(TypeError, match="push"):
        ts.update(adds=TS.EdgeDelta())


def test_slot_capacity_bucketed_exactly_when_mutable():
    """The reference's rule: a session with a mutation buffer builds runners
    on the bucketed slot count, a read-only one on the exact count."""
    rg, tg = _graphs(1500, 5)
    for part in ("cdbh", "greedy-ec"):
        rs = RSession.from_graph(rg, 4, part)
        ts = TSession.from_graph(tg, 4, part, device="cpu")
        assert (ts.buffer is None) == (rs.buffer is None) == \
            (part == "greedy-ec")
        assert ts.slot_capacity == rs.slot_capacity
        assert ts.shape_key == rs.shape_key
    ro = TSession(ts.pg, shape_policy=ts.shape_policy, device="cpu")
    assert ro.slot_capacity == ro.pg.n_slots
