"""Serving layer of the port (``repro_torch.serving``), the JAX package's
``tests/test_serving.py`` without its shard_map and retrace-guard parts:
canonical params, cross-tenant runner sharing, fair eviction (the same
script through both packages' ``RunnerCache`` evicts the same keys in the
same order), the pool's lifecycle and session bound, ``close()``, the
tiered result cache (no launches on a hit, version invalidation, batch
all-hit, TTL per store, result keys that separate what the reference's
separate), and the batcher (coalescing, ``max_delay`` and deadlines on a
fake clock, the result-cache fast path, a pool, the per-lane replay of a
failed batch, the pump thread, concurrent submits)."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

import repro.algos as RA
from repro.core import EngineConfig as RCfg
from repro.serving import RunnerCache as RRunnerCache
from repro.serving import RunnerEntry as RRunnerEntry
from repro.serving import canonical_params as rcanonical
from repro.serving import result_key as rresult_key
from repro_torch.algos import SSSP, ConnectedComponents, PageRank
from repro_torch.core import EngineConfig
from repro_torch.graphgen import powerlaw_graph
from repro_torch.serving import (BatchPolicy, DictStore, FileStore,
                                 MicroBatcher, RedisStore, ResultCache,
                                 RunnerCache, RunnerEntry, SessionPool,
                                 canonical_params, params_struct_key,
                                 result_key)
from repro_torch.session import GraphSession


@pytest.fixture(scope="module")
def g():
    return powerlaw_graph(400, seed=7, weighted=True).as_undirected()


@pytest.fixture(scope="module")
def g2():
    # other content, same size: lands in the same shape bucket as g
    return powerlaw_graph(400, seed=8, weighted=True).as_undirected()


def _session(g, **kw):
    return GraphSession.from_graph(g, 4, "cdbh", device="cpu", **kw)


# --------------------------------------------------------------------------- #
# cache keys
# --------------------------------------------------------------------------- #
def test_param_dtype_drift_builds_one_runner(g):
    sess = _session(g)
    sess.query(SSSP(), {"source": 0}, warm=False)
    for p in (1, np.int32(2), np.int64(3), np.array(4),
              np.array(5, dtype=np.int32)):
        _, st = sess.query(SSSP(), {"source": p}, warm=False)
        assert st.compile_time == 0.0
    assert sess.stats.runner_builds == 1
    assert len(sess._runners) == 1


def test_canonical_params_scalar_normalization():
    variants = [{"source": 3}, {"source": np.int32(3)},
                {"source": np.int64(3)}, {"source": np.array(3)}]
    assert len({params_struct_key(canonical_params(v))
                for v in variants}) == 1
    assert len({params_struct_key(canonical_params({"x": v}))
                for v in (0.5, np.float32(0.5), np.float64(0.5),
                          np.array(0.5))}) == 1
    # ndim >= 1 leaves keep their dtype (the caller's choice)
    ai = canonical_params({"v": np.zeros(4, np.int32)})
    af = canonical_params({"v": np.zeros(4, np.float32)})
    assert params_struct_key(ai) != params_struct_key(af)
    # an int beyond int32 keeps int64, as the reference's does
    wide = canonical_params({"s": 2**40})["s"]
    assert wide.dtype == np.int64
    assert str(np.asarray(rcanonical({"s": 3})["s"]).dtype) == \
        canonical_params({"s": 3})["s"].dtype.name
    assert canonical_params(None) == {}


def test_result_key_separates_what_the_reference_separates():
    """Pairs of requests get equal keys in the port exactly when they get
    equal keys in the reference."""
    base = ("t", 0, "sssp", {"source": 3}, "coo")
    variants = [
        base,
        ("t", 0, "sssp", {"source": np.int64(3)}, "coo"),
        ("t", 0, "sssp", {"source": np.array(3)}, "coo"),
        ("u", 0, "sssp", {"source": 3}, "coo"),
        ("t", 1, "sssp", {"source": 3}, "coo"),
        ("t", 0, "sssp", {"source": 4}, "coo"),
        ("t", 0, "sssp", {"source": 3.0}, "coo"),
        ("t", 0, "sssp", {"src": 3}, "coo"),
        ("t", 0, "sssp", [3], "coo"),
        ("t", 0, "cc", None, "coo"),
        ("t", 0, "cc", {}, "coo"),
        ("t", 0, "sssp", {"source": 3}, "pallas_windows"),
        ("t", 0, "pr7", {"n_vertices": 5}, "coo"),
        ("t", 0, "pr6", {"n_vertices": 5}, "coo"),
    ]
    progs = {"sssp": (RA.SSSP(), SSSP()),
             "cc": (RA.ConnectedComponents(), ConnectedComponents()),
             "pr7": (RA.PageRank(tol=1e-7), PageRank(tol=1e-7)),
             "pr6": (RA.PageRank(tol=1e-6), PageRank(tol=1e-6))}

    def keys(side):
        out = []
        for tenant, ver, prog, params, eb in variants:
            p = progs[prog][side]
            if side == 0:
                out.append(rresult_key(tenant, ver, p, rcanonical(params),
                                       RCfg(edge_backend=eb)))
            else:
                out.append(result_key(tenant, ver, p,
                                      canonical_params(params),
                                      EngineConfig(edge_backend=eb)))
        return out

    rk, tk = keys(0), keys(1)
    n = len(variants)
    for i in range(n):
        for j in range(n):
            assert (rk[i] == rk[j]) == (tk[i] == tk[j]), \
                (variants[i], variants[j])


# --------------------------------------------------------------------------- #
# the runner cache shared across tenants
# --------------------------------------------------------------------------- #
def test_cross_tenant_single_build(g, g2):
    pool = SessionPool(max_runners=8, device="cpu")
    a = pool.open("a", g, n_parts=4)
    b = pool.open("b", g2, n_parts=4)
    assert a.shape_key == b.shape_key, "fixtures must share a bucket"
    a.query(SSSP(), {"source": 0}, warm=False)
    rb, st = b.query(SSSP(), {"source": 5}, warm=False)
    assert st.compile_time == 0.0
    assert pool.runner_cache.misses == 1 and pool.runner_cache.hits == 1
    # tenant b's answer is for tenant b's graph
    ref, _ = _session(g2).query(SSSP(), {"source": 5}, warm=False)
    np.testing.assert_array_equal(rb, ref)
    [entry] = pool.runner_cache.entries.values()
    assert entry.owners == {"a", "b"} and entry.nbytes > 0
    assert a.cache_info()[0]["owners"] == ["a", "b"]
    pool.close_all()


def _fairness_script(cache_cls, entry_cls):
    """An insert / lookup script over three owners on a 3-slot cache;
    returns the cache's keys after every step and the per-owner evicted
    pins."""
    cache = cache_cls(max_entries=3)
    trace = []
    steps = [("insert", "b1", "b"), ("insert", "a1", "a"),
             ("insert", "a2", "a"), ("insert", "a3", "a"),
             ("lookup", "b1", "c"), ("insert", "c1", "c"),
             ("lookup", "a2", "b"), ("insert", "a4", "a"),
             ("insert", "b2", "b"), ("lookup", "zz", "a"),
             ("insert", "c2", "c"), ("insert", "a5", "a")]
    for op, key, owner in steps:
        if op == "insert":
            cache.insert(key, entry_cls(compiled=object(), shape_key=(),
                                        program="P"), owner)
        else:
            cache.lookup(key, owner)
        trace.append(list(cache.keys()))
    pins = {o: (s.hits, s.misses, s.evicted_pins)
            for o, s in sorted(cache.by_owner.items())}
    return trace, pins, (cache.hits, cache.misses, cache.evictions)


def test_eviction_fairness_matches_reference():
    assert _fairness_script(RunnerCache, RunnerEntry) == \
        _fairness_script(RRunnerCache, RRunnerEntry)
    # and the flooding owner lost its own oldest entry first
    cache = RunnerCache(max_entries=3)
    for key, owner in (("b1", "b"), ("a1", "a"), ("a2", "a"), ("a3", "a")):
        cache.insert(key, RunnerEntry(compiled=object(), shape_key=(),
                                      program="P"), owner)
    assert "b1" in cache and "a1" not in cache
    assert cache.by_owner["a"].evicted_pins == 1
    assert cache.by_owner["b"].evicted_pins == 0


def test_eviction_fairness_sessions(g, g2):
    pool = SessionPool(max_runners=2, device="cpu")
    a = pool.open("a", g, n_parts=4)
    b = pool.open("b", g2, n_parts=4)
    b.query(SSSP(), {"source": 0}, warm=False)
    for tol in (1e-5, 1e-6, 1e-7):      # tenant a floods the 2-slot cache
        a.query(PageRank(tol=tol), {"n_vertices": g.n_vertices}, warm=False)
    misses = pool.runner_cache.misses
    b.query(SSSP(), {"source": 1}, warm=False)
    assert pool.runner_cache.misses == misses
    assert pool.stats()["runner_cache"]["by_owner"]["b"].evicted_pins == 0
    assert a.stats.cache_evictions_lru == 2
    pool.close_all()


def test_runner_byte_bound_evicts(g):
    """``runner_nbytes`` bills every runner, so a byte bound evicts: a
    batched runner weighs its padded lane count times a singleton."""
    sess = _session(g, max_runner_bytes=1)
    sess.query(SSSP(), {"source": 0})
    one = sess.stats.runner_cache_bytes
    P, v, slots = sess.pg.n_parts, sess.pg.v_max, sess.slot_capacity
    assert one == (3 * P * v + slots + 1) * 4
    sess.query(ConnectedComponents())
    assert sess.stats.cache_evictions_lru == 1 and len(sess._runners) == 1
    sess.max_runner_bytes = None
    sess.query_batch(SSSP(), [{"source": s} for s in range(3)], warm=False)
    assert [e["nbytes"] for e in sess.cache_info()] == [one, 4 * one]
    assert sess.stats.runner_cache_bytes == 5 * one


def test_pool_lifecycle(g, g2):
    pool = SessionPool(max_runners=8, device="cpu")
    a = pool.open("a", g, n_parts=4)
    b = pool.open("b", g2, n_parts=4)
    a.query(SSSP(), {"source": 0}, warm=False)
    b.query(SSSP(), {"source": 0}, warm=False)
    # closing one tenant keeps the shared entry for the other
    pool.close("a")
    assert a.closed and "a" not in pool
    [entry] = pool.runner_cache.entries.values()
    assert entry.owners == {"b"}
    misses = pool.runner_cache.misses
    b.query(SSSP(), {"source": 2}, warm=False)
    assert pool.runner_cache.misses == misses
    pool.close("b")
    assert len(pool.runner_cache) == 0 and len(pool) == 0
    with pytest.raises(ValueError, match="exactly one"):
        pool.open("b", g, pg=a.pg)
    c = pool.open("c", pg=b.pg)
    assert c.device.type == "cpu" and pool.query(
        "c", SSSP(), {"source": 0})[0].shape == b.pg.vmask.shape
    with pytest.raises(ValueError, match="already"):
        pool.open("c", g)
    with pytest.raises(KeyError):
        pool.session("nobody")
    pool.close_all()
    # a mesh is every session's (the shard_map backend;
    # tests/test_torch_session_shard.py serves a pool on one)
    mesh = object()
    assert SessionPool(mesh=mesh, device="cpu").mesh is mesh


def test_pool_max_sessions_lru(g):
    with SessionPool(max_sessions=2, device="cpu") as pool:
        a = pool.open("a", g, n_parts=4)
        pool.open("b", g, n_parts=4)
        pool.open("c", g, n_parts=4)          # closes a (LRU)
        assert a.closed
        assert pool.tenants == ["b", "c"]
        assert pool.sessions_closed == 1
        pool.session("b")                     # b is now the most recent
        pool.open("d", g, n_parts=4)
        assert pool.tenants == ["b", "d"]
    assert len(pool) == 0


# --------------------------------------------------------------------------- #
# close() and the context manager
# --------------------------------------------------------------------------- #
def test_session_close(g):
    sess = _session(g)
    sess.query(SSSP(), {"source": 0})
    sess.close()
    assert sess.closed
    assert sess._device_graph is None
    assert len(sess._runners) == 0 and not sess._warm
    for fn in (lambda: sess.query(SSSP(), {"source": 0}),
               lambda: sess.query_batch(SSSP(), [{"source": 0}]),
               lambda: sess.update(adds=([0], [1], [1.0])),
               lambda: sess.flush(),
               lambda: sess.compact(),
               lambda: sess.rebalance(),
               lambda: sess.device_graph()):
        with pytest.raises(RuntimeError, match="closed"):
            fn()
    sess.close()                              # idempotent
    with _session(g) as s2:
        s2.query(SSSP(), {"source": 0})
    assert s2.closed


# --------------------------------------------------------------------------- #
# the tiered result cache
# --------------------------------------------------------------------------- #
def test_result_cache_zero_launches_and_invalidation(g):
    rc = ResultCache(store=DictStore())
    sess = _session(g, result_cache=rc, tenant="t")
    r1, st1 = sess.query(SSSP(), {"source": 0})
    assert st1.result_cache_tier == "miss"
    launches = sess.stats.device_launches
    r2, st2 = sess.query(SSSP(), {"source": 0})
    assert st2.result_cache_tier == "l1"
    assert sess.stats.device_launches == launches, "a hit ran the runner"
    assert st2.compile_time == 0.0 and st2.supersteps == st1.supersteps
    np.testing.assert_array_equal(r1, r2)
    rc.clear_l1()                             # L2 promotion
    r3, st3 = sess.query(SSSP(), {"source": 0})
    assert st3.result_cache_tier == "l2"
    assert sess.stats.device_launches == launches
    np.testing.assert_array_equal(r1, r3)
    # a deleting flush moves the graph version: old entries unreachable
    sess.update(deletes=(g.src[:4], g.dst[:4]))
    sess.flush()
    _, st4 = sess.query(SSSP(), {"source": 0})
    assert st4.result_cache_tier == "miss"
    assert sess.stats.device_launches == launches + 1
    _, st5 = sess.query(SSSP(), {"source": 0})
    assert st5.result_cache_tier == "l1"
    assert sess.stats.result_cache_l1_hits == 2
    assert sess.stats.result_cache_l2_hits == 1
    _, st6 = sess.query(SSSP(), {"source": 0}, use_result_cache=False)
    assert st6.result_cache_tier == "" and \
        sess.stats.device_launches == launches + 2
    sess.close()


def test_result_cache_batch_all_hit(g):
    sess = _session(g, result_cache=ResultCache(), tenant="t")
    plist = [{"source": i} for i in range(3)]
    out1 = sess.query_batch(SSSP(), plist, warm=False)
    launches = sess.stats.device_launches
    out2 = sess.query_batch(SSSP(), plist, warm=False)
    assert sess.stats.device_launches == launches
    for (r1, _), (r2, st2) in zip(out1, out2):
        assert st2.result_cache_tier == "l1" and st2.batch_size == 3
        np.testing.assert_array_equal(r1, r2)
    # a partial hit runs the whole batch
    out3 = sess.query_batch(SSSP(), [{"source": 0}, {"source": 9}],
                            warm=False)
    assert sess.stats.device_launches == launches + 1
    assert all(st.result_cache_tier == "miss" for _, st in out3)
    assert sess.stats.result_cache_misses == 3 + 2
    sess.close()


def test_result_cache_ttl_and_stores(tmp_path):
    now = [0.0]
    rc = ResultCache(ttl=10.0, store=DictStore(clock=lambda: now[0]),
                     clock=lambda: now[0])
    rc.put("k", dict(results=np.arange(4.0), supersteps=3))
    val, tier = rc.get("k")
    assert tier == "l1" and val["supersteps"] == 3
    now[0] = 11.0                              # past the TTL in both tiers
    val, tier = rc.get("k")
    assert tier == "miss" and val is None
    assert rc.stats.expirations == 1 and len(rc.store) == 0

    fs = FileStore(str(tmp_path), clock=lambda: now[0])
    rc2 = ResultCache(store=fs)
    blob = dict(results=np.arange(6, dtype=np.float32).reshape(2, 3),
                supersteps=5, edge_backend="coo")
    rc2.put("x", blob)
    rc2.clear_l1()
    val, tier = rc2.get("x")
    assert tier == "l2"
    np.testing.assert_array_equal(val["results"], blob["results"])
    assert val["results"].dtype == np.float32
    assert val["supersteps"] == 5 and val["edge_backend"] == "coo"
    before = (rc2.stats.l1_hits, rc2.stats.l2_hits)
    assert rc2.peek("x") == "l1"               # peek bills nothing
    assert (rc2.stats.l1_hits, rc2.stats.l2_hits) == before
    assert rc2.peek("missing") is None
    # a FileStore entry past its TTL is deleted on access
    fs.put("y", b"data", ttl=5.0)
    assert fs.get("y") == b"data"
    now[0] = 20.0
    assert fs.get("y") is None and not (tmp_path / "y.npz").exists()

    rc3 = ResultCache(max_entries=2)
    for i in range(3):
        rc3.put(f"k{i}", dict(results=np.zeros(1)))
    assert len(rc3) == 2 and rc3.stats.l1_evictions == 1
    rc4 = ResultCache(max_entries=None, max_bytes=16)
    for i in range(3):
        rc4.put(f"k{i}", dict(results=np.zeros(1)))
    assert len(rc4) == 2 and rc4.l1_bytes == 16


class _FakeRedis:
    """get / set(ex=) / delete over a dict, expiring on a fake clock."""

    def __init__(self, clock):
        self.d, self.clock, self.ex_seen = {}, clock, []

    def get(self, key):
        hit = self.d.get(key)
        if hit is None or (hit[1] is not None and self.clock() >= hit[1]):
            return None
        return hit[0]

    def set(self, key, data, ex=None):
        self.ex_seen.append(ex)
        self.d[key] = (data, None if ex is None else self.clock() + ex)

    def delete(self, key):
        self.d.pop(key, None)


def test_redis_store_on_a_fake_client(monkeypatch):
    now = [0.0]
    client = _FakeRedis(lambda: now[0])
    rc = ResultCache(ttl=2.4, store=RedisStore(client),
                     clock=lambda: now[0])
    rc.put("k", dict(results=np.arange(3, dtype=np.int32), supersteps=2))
    rc.clear_l1()
    val, tier = rc.get("k")
    assert tier == "l2" and val["results"].dtype == np.int32
    assert client.ex_seen == [2]               # whole seconds, at least 1
    rc.invalidate("k")
    assert rc.get("k") == (None, "miss")
    RedisStore(client).put("n", b"x")
    assert client.ex_seen[-1] is None and client.get("n") == b"x"
    monkeypatch.setitem(sys.modules, "redis", None)
    with pytest.raises(ImportError, match="redis"):
        RedisStore.from_url("redis://localhost:6379/0")


# --------------------------------------------------------------------------- #
# the admission queue
# --------------------------------------------------------------------------- #
def test_batcher_coalescing(g):
    sess = _session(g)
    bat = MicroBatcher(sess, BatchPolicy(max_batch=3, max_delay=0.005))
    futs = [bat.submit(SSSP(), {"source": i}, warm=False) for i in range(3)]
    # the third submit filled the group: launched inline, one batch
    assert all(f.done() for f in futs)
    assert bat.stats.launched_batches == 1 and bat.stats.batched_requests == 3
    assert sess.stats.batches == 1
    for i, f in enumerate(futs):
        res, st = f.result(timeout=1)
        ref, _ = sess.query(SSSP(), {"source": i}, warm=False)
        np.testing.assert_array_equal(res, ref)
        assert st.batch_size == 3 and st.queue_time >= 0.0


def test_batcher_max_delay_and_deadline(g):
    now = [0.0]
    sess = _session(g)
    bat = MicroBatcher(sess, BatchPolicy(max_batch=8, max_delay=1.0),
                       clock=lambda: now[0])
    f1 = bat.submit(SSSP(), {"source": 0}, warm=False)
    assert bat.poll() == 0 and not f1.done()   # not due yet
    now[0] = 1.5
    assert bat.poll() == 1                     # waited past max_delay
    _, st = f1.result(timeout=1)
    assert st.batch_size == 1 and st.queue_time == 1.5
    assert bat.stats.launched_singletons == 1
    # a deadline forces the launch early
    f2 = bat.submit(SSSP(), {"source": 1}, warm=False, deadline=now[0] + 0.5)
    assert bat.poll() == 1 and f2.done()
    # incompatible structures coalesce into separate groups
    f3 = bat.submit(SSSP(), {"source": 2}, warm=False)
    f4 = bat.submit(SSSP(), {"source": np.array([3], np.int32)},
                    warm=False)
    assert bat.pending == 2
    assert bat.flush() == 2
    assert f3.done() and f4.done()
    f4.result(timeout=1)


def test_batcher_fast_path_and_pool(g, g2):
    pool = SessionPool(result_cache=ResultCache(), device="cpu")
    pool.open("a", g, n_parts=4)
    pool.open("b", g2, n_parts=4)
    with MicroBatcher(pool, BatchPolicy(max_batch=2)) as bat:
        fa = bat.submit(SSSP(), {"source": 0}, tenant="a")
        fb = bat.submit(SSSP(), {"source": 0}, tenant="b")
        # different sessions, different groups; stop() flushes both
    ra, _ = fa.result(timeout=1)
    rb, _ = fb.result(timeout=1)
    assert not np.array_equal(ra, rb)          # per-tenant graphs
    # the repeat is answered from the result cache, without queueing
    f2 = bat.submit(SSSP(), {"source": 0}, tenant="a")
    assert f2.done() and bat.stats.fast_path_hits == 1
    res, st = f2.result(timeout=1)
    assert st.result_cache_tier == "l1" and st.queue_time == 0.0
    np.testing.assert_array_equal(ra, res)
    # a buffered mutation disables the fast path (the query would flush)
    pool.session("a").update(adds=([0], [9], [1.0]))
    f3 = bat.submit(SSSP(), {"source": 0}, tenant="a")
    assert not f3.done() and bat.stats.fast_path_hits == 1
    bat.flush()
    assert f3.result(timeout=1)[1].result_cache_tier == "miss"
    pool.close_all()


def test_batcher_replays_a_failed_batch_per_lane(g, monkeypatch):
    """A batch launch that fails replays each lane alone through
    ``query``; a lane that fails again gets its own error."""
    sess = _session(g)
    bat = MicroBatcher(sess, BatchPolicy(max_batch=8))

    def broken(*a, **k):
        raise RuntimeError("batch launch failed")

    monkeypatch.setattr(sess, "query_batch", broken)
    futs = [bat.submit(SSSP(), {"source": s}, warm=False) for s in (0, 1)]
    assert bat.flush() == 1
    for s, f in zip((0, 1), futs):
        ref, _ = _session(g).query(SSSP(), {"source": s}, warm=False)
        np.testing.assert_array_equal(f.result(timeout=1)[0], ref)
    assert bat.stats.degraded == 2 and bat.stats.launched_batches == 0
    # a lane whose own query fails too gets that error on its future
    monkeypatch.setattr(sess, "query", broken)
    f = bat.submit(SSSP(), {"source": 0}, warm=False)
    bat.flush()
    with pytest.raises(RuntimeError, match="batch launch failed"):
        f.result(timeout=1)
    assert bat.stats.degraded == 2


def test_batcher_pump_thread(g):
    sess = _session(g)
    bat = MicroBatcher(sess, BatchPolicy(max_batch=64, max_delay=0.01))
    bat.start()
    try:
        futs = [bat.submit(SSSP(), {"source": s}, warm=False)
                for s in range(3)]
        results = [f.result(timeout=60) for f in futs]
    finally:
        bat.stop()
    assert bat._thread is None and bat.pending == 0
    for s, (res, st) in enumerate(results):
        ref, _ = sess.query(SSSP(), {"source": s}, warm=False)
        np.testing.assert_array_equal(res, ref)
    assert bat.stats.submitted == 3


def test_batcher_concurrent_submits_lose_nothing(g):
    """More submitting threads than cores, a short switch interval: every
    request is counted, queued once and answered."""
    sess = _session(g)
    bat = MicroBatcher(sess, BatchPolicy(max_batch=10**6, max_delay=60.0))
    n_threads, per_thread = 16, 5
    futs = [[] for _ in range(n_threads)]

    def work(i):
        for k in range(per_thread):
            futs[i].append(bat.submit(ConnectedComponents(), None))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert time.monotonic() - t0 < 120
    finally:
        sys.setswitchinterval(old)
    total = n_threads * per_thread
    assert bat.stats.submitted == total and bat.pending == total
    assert bat.flush() == 1
    ref, _ = sess.query(ConnectedComponents())
    for f in (f for fs in futs for f in fs):
        np.testing.assert_array_equal(f.result(timeout=60)[0], ref)
    assert dataclasses.asdict(bat.stats)["batched_requests"] == total
