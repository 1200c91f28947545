"""The port's warm-result memory on the CPU (``GraphSession._remember``):
each converged result of a monotone program is kept as one owned block, and
its global array is gathered on first read under the membership the result
was remembered in. That array equals ``pg.collect(res)`` taken at remember
time, through ``query`` and ``query_batch``, across an insert-only flush
and a compaction; writes into a returned result never reach the warm seed;
``SessionStats.warm_collects`` counts the gathers; the memory's bytes and
evictions are those of a global array held from the start."""
import numpy as np
import pytest

import repro_torch.algos as TA
import repro_torch.graphgen as TG
from repro_torch.core import EngineConfig
from repro_torch.core.subgraph import ShapePolicy
from repro_torch.session import GraphSession

#: program, params of query i; SSSP has K = 1, MultiSourceBFS K = 4
PROGRAMS = {
    "sssp": (TA.SSSP(), lambda i: {"source": i}),
    "msbfs": (TA.MultiSourceBFS(payload=4),
              lambda i: {"sources": np.arange(i, i + 4, dtype=np.int32)}),
}


def _session(**kw):
    return GraphSession.from_graph(TG.kronecker_graph(8, seed=3), 4, "cdbh",
                                   device="cpu", **kw)


def _collected(sess, prog, res):
    return sess.pg.collect(res, fill=prog.identity)


def _last_entries(sess, n):
    return list(sess._warm.values())[-n:]


def _insert_edges(sess, n=40, seed=0):
    """An insert-only flush among the graph's vertices."""
    rng = np.random.default_rng(seed)
    nv = sess.pg.n_vertices
    sess.update(adds=(rng.integers(0, nv, n), rng.integers(0, nv, n),
                      np.full(n, 0.5, np.float32)))
    st = sess.flush()
    assert st.warm_start_safe
    return st


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("batched", [False, True], ids=["query", "batch"])
def test_global_values_equal_the_collect_at_remember(name, batched):
    prog, params = PROGRAMS[name]
    sess = _session()
    plist = [params(i) for i in (3, 17)]
    if batched:
        results = [r for r, _ in sess.query_batch(prog, plist)]
    else:
        results = [sess.query(prog, p)[0] for p in plist]
    want = [_collected(sess, prog, r) for r in results]
    entries = _last_entries(sess, len(plist))
    assert sess.stats.warm_collects == 0            # cold queries gather none
    for i, (e, w) in enumerate(zip(entries, want)):
        got = e.global_values
        assert got.dtype == w.dtype and got.shape == w.shape
        np.testing.assert_array_equal(got, w)
        assert e.global_values is got               # built once
        assert sess.stats.warm_collects == i + 1


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_writes_into_a_result_do_not_reach_the_seed(name):
    prog, params = PROGRAMS[name]
    sess = _session()
    p = params(5)
    res, _ = sess.query(prog, p)                    # cold, remembered
    cold = res.copy()
    (entry,) = _last_entries(sess, 1)
    block = entry.device_block.copy()
    res[...] = 0                                    # a seed of zeros
    np.testing.assert_array_equal(entry.device_block, block)
    np.testing.assert_array_equal(entry.global_values,
                                  _collected(sess, prog, cold))
    again, st = sess.query(prog, p)
    assert sess.stats.warm_queries == 1
    np.testing.assert_array_equal(again, cold)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("first_read", ["property", "warm_query"])
def test_global_values_survive_flush_and_compaction(name, first_read):
    """The first read comes after the layout moved twice: straight from the
    property (the block is still as remembered), or through a warm query,
    whose replay of the remaps gathers the array before it moves the
    block."""
    prog, params = PROGRAMS[name]
    sess = _session()
    p = params(7)
    res, _ = sess.query(prog, p)
    want = _collected(sess, prog, res)
    (entry,) = _last_entries(sess, 1)
    _insert_edges(sess)
    sess.compact()
    if first_read == "warm_query":
        warm, _ = sess.query(prog, p)
        assert sess.stats.warm_queries == 1
        assert sess.stats.warm_remaps_applied == 2
        assert sess.stats.warm_collects == 1
    np.testing.assert_array_equal(entry.global_values, want)
    assert sess.stats.warm_collects == 1
    if first_read == "property":
        warm, _ = sess.query(prog, p)
        assert sess.stats.warm_queries == 1
    cold, _ = sess.query(prog, p, warm=False)
    np.testing.assert_array_equal(_collected(sess, prog, warm),
                                  _collected(sess, prog, cold))


def test_warm_collects_count_trace_and_shape_fallback_reads():
    prog, params = PROGRAMS["sssp"]
    sess = _session(shape_policy=ShapePolicy.exact())
    for i in range(4):
        sess.query(prog, params(i))
    assert sess.stats.warm_collects == 0
    trace = EngineConfig(trace=True)
    for i in (0, 0, 1):                             # one gather per entry
        sess.query(prog, params(i), cfg=trace)
    assert sess.stats.warm_collects == 2
    # the shape fallback: an entry whose block the remap log did not bring
    # to the graph's new capacity is rebuilt from its global array
    res, _ = sess.query(prog, params(9))
    want = _collected(sess, prog, res)
    (entry,) = _last_entries(sess, 1)
    v0, nv = sess.pg.v_max, sess.pg.n_vertices
    n = 3 * v0
    sess.update(adds=(np.zeros(n, np.int64), 1 + np.arange(n) % (nv - 1),
                      np.full(n, 0.5, np.float32)))
    sess.flush()
    assert sess.pg.v_max != v0
    entry.device_epoch = sess._warm_epoch           # the replay skipped
    warm, _ = sess.query(prog, params(9))
    assert sess.stats.warm_queries == 1
    assert sess.stats.warm_collects == 3
    np.testing.assert_array_equal(entry.global_values, want)
    cold, _ = sess.query(prog, params(9), warm=False)
    np.testing.assert_array_equal(_collected(sess, prog, warm),
                                  _collected(sess, prog, cold))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_warm_bytes_and_evictions_charge_both_arrays(name):
    """Bytes per entry: the block plus the global array, built or not; a
    bound of two entries' bytes keeps two and evicts the rest."""
    prog, params = PROGRAMS[name]
    probe = _session()
    res, _ = probe.query(prog, params(0))
    one = res.nbytes + _collected(probe, prog, res).nbytes
    assert probe.stats.warm_cache_bytes == one
    sess = _session(max_warm_bytes=2 * one)
    for i in range(5):
        sess.query(prog, params(i))
    assert len(sess._warm) == 2 and sess.stats.warm_evictions == 3
    assert sess.stats.warm_cache_bytes == 2 * one
    assert sess.stats.warm_collects == 0
