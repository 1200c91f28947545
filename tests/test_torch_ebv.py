"""The port's EBV router against the JAX package's: one-shot assignments
bit-identical at P = 4 and 16 on a power-law graph and kron-10, chunked
routing equal to one-shot, a checkpoint of either package resumed in the
other continuing bit-identically, pair-sticky placement, exact delete
routing, a non-mutating preview, id-space growth and the two-tier pair
table, and an ``"ebv"`` stream (ingest, then one ``EdgeDelta``) whose host
arrays are bit-identical to the reference's."""
import numpy as np
import pytest

import repro.graphgen as RG
import repro.stream as RS
import repro_torch.graphgen as TG
import repro_torch.stream as TS
from repro.core import PARTITIONERS as RPARTITIONERS
from repro.core import build_partitioned_graph as rbuild
from repro.partition import ebv as RE
from repro_torch.core import PARTITIONERS as TPARTITIONERS
from repro_torch.core import build_partitioned_graph as tbuild
from repro_torch.core import partition_metrics
from repro_torch.core.partition import (STREAM_ROUTERS, StatefulRouterSpec,
                                        is_stateful_router)
from repro_torch.partition import ebv as TE

PG_ARRAYS = ("gvid", "vmask", "esrc", "edst", "ew", "emask", "slot",
             "is_frontier", "out_deg", "in_deg", "is_master")
STATE = ("replicas", "edge_load", "replica_load")


def _graphs(kind, seed=0):
    if kind == "powerlaw":
        return (RG.powerlaw_graph(4000, alpha=2.1, avg_degree=8, seed=seed),
                TG.powerlaw_graph(4000, alpha=2.1, avg_degree=8, seed=seed))
    return RG.kronecker_graph(10, seed=seed), TG.kronecker_graph(10, seed=seed)


def assert_same_state(r, t, where=""):
    for name in STATE:
        a, b = getattr(r, name), getattr(t, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {name}")
        assert a.dtype == b.dtype, (where, name)
    assert (r.total_edges, r.n_vertices, r.n_parts, r.seed) == \
        (t.total_edges, t.n_vertices, t.n_parts, t.seed), where
    rk, rp = r.table.snapshot()
    tk, tp = t.table.snapshot()
    np.testing.assert_array_equal(rk, tk, err_msg=f"{where} table keys")
    np.testing.assert_array_equal(rp, tp, err_msg=f"{where} table parts")


def assert_same_pg(rpg, tpg, where=""):
    for name in ("n_parts", "n_vertices", "n_edges", "n_slots", "v_max",
                 "e_max"):
        assert getattr(rpg, name) == getattr(tpg, name), (where, name)
    for name in PG_ARRAYS:
        np.testing.assert_array_equal(getattr(rpg, name),
                                      getattr(tpg, name),
                                      err_msg=f"{where} {name}")


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["powerlaw", "kron10"])
@pytest.mark.parametrize("P", [4, 16])
def test_ebv_vertex_cut_bit_identical(kind, P):
    rg, tg = _graphs(kind)
    want = RE.ebv_vertex_cut(rg, P, seed=1)
    out = []
    got = TE.ebv_vertex_cut(tg, P, seed=1, state_out=out)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(TPARTITIONERS["ebv"](tg, P, seed=1),
                                  RPARTITIONERS["ebv"](rg, P, seed=1))
    ref = RE.EBVRouterState(P, rg.n_vertices, seed=1)
    ref.route_adds(rg.src, rg.dst)
    assert_same_state(ref, out[0], f"{kind} P={P}")
    # and the built graph the session serves
    assert_same_pg(rbuild(rg, want, P), tbuild(tg, got, P))


def test_ebv_registered_as_stateful_router():
    entry = STREAM_ROUTERS["ebv"]
    assert isinstance(entry, StatefulRouterSpec) and is_stateful_router(entry)
    assert entry.factory_module == "repro_torch.partition.ebv"
    assert not is_stateful_router(STREAM_ROUTERS["rh-vc"])
    st = entry.make_state(4, 100, seed=3)
    assert isinstance(st, TE.EBVRouterState)
    assert (st.n_parts, st.seed) == (4, 3)


def test_chunked_route_adds_equals_one_shot():
    """Routing the stream in chunks places every edge where one call does
    (chunk boundaries fall inside mini-blocks and duplicate runs)."""
    _, tg = _graphs("powerlaw", seed=2)
    one = TE.EBVRouterState(6, tg.n_vertices, seed=0)
    want = one.route_adds(tg.src, tg.dst)
    bounds = [0, 1, 300, 777, 4096, 10_000, tg.src.size]
    two = TE.EBVRouterState(6, tg.n_vertices, seed=0)
    got = np.concatenate([two.route_adds(tg.src[a:b], tg.dst[a:b])
                          for a, b in zip(bounds[:-1], bounds[1:])])
    # the reference's chunked routing is the contract: compare to it
    ref = RE.EBVRouterState(6, tg.n_vertices, seed=0)
    rgot = np.concatenate([ref.route_adds(tg.src[a:b], tg.dst[a:b])
                           for a, b in zip(bounds[:-1], bounds[1:])])
    np.testing.assert_array_equal(got, rgot)
    assert_same_state(ref, two, "chunked")
    assert want.shape == got.shape
    assert partition_metrics(tbuild(tg, got, 6)).imbalance <= 1.2


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_packages(direction):
    rg, tg = _graphs("powerlaw", seed=3)
    cut = rg.src.size // 2
    R, T = (RE.EBVRouterState, TE.EBVRouterState)
    src_cls, dst_cls = (R, T) if direction == "jax_to_port" else (T, R)
    a = src_cls(4, rg.n_vertices, seed=0)
    a.route_adds(rg.src[:cut], rg.dst[:cut])
    blob = a.checkpoint()
    b = dst_cls.from_checkpoint(blob)
    assert sorted(blob) == sorted(b.checkpoint())
    pa = a.route_adds(rg.src[cut:], rg.dst[cut:])
    pb = b.route_adds(rg.src[cut:], rg.dst[cut:])
    np.testing.assert_array_equal(pa, pb)
    assert_same_state(a, b, direction)
    np.testing.assert_array_equal(a.route_deletes(rg.src[:99], rg.dst[:99]),
                                  b.route_deletes(rg.src[:99], rg.dst[:99]))


def test_sticky_pairs_deletes_preview_and_growth():
    rg = RG.random_graph(300, 4000, seed=2, undirected=True)
    tg = TG.random_graph(300, 4000, seed=2, undirected=True)
    r = RE.EBVRouterState(7, 300, cfg=RE.EBVConfig(block=64))
    t = TE.EBVRouterState(7, 300, cfg=TE.EBVConfig(block=64))
    part = t.route_adds(tg.src, tg.dst)
    np.testing.assert_array_equal(part, r.route_adds(rg.src, rg.dst))
    lut = {}
    for s, d, p in zip(tg.src.tolist(), tg.dst.tolist(), part.tolist()):
        assert lut.setdefault((min(s, d), max(s, d)), p) == p, (s, d)
    # a later re-add in the other direction sticks to the recorded part
    np.testing.assert_array_equal(t.route_adds(tg.dst[:50], tg.src[:50]),
                                  part[:50])
    r.route_adds(rg.dst[:50], rg.src[:50])
    # deletes: exact from the table in either direction; unknown pairs
    # fall back to the seeded hash, like the reference's
    np.testing.assert_array_equal(t.route_deletes(tg.dst, tg.src), part)
    miss = (np.array([280, 281]), np.array([282, 283]))
    np.testing.assert_array_equal(t.route_deletes(*miss),
                                  r.route_deletes(*miss))
    # preview and deletes never mutate the state
    before = t.checkpoint()
    prev = t.route_preview(np.arange(0, 250, 3), np.arange(250, 0, -3))
    np.testing.assert_array_equal(
        prev, r.route_preview(np.arange(0, 250, 3), np.arange(250, 0, -3)))
    t.route_deletes(tg.src[:500], tg.dst[:500])
    after = t.checkpoint()
    for k in before:
        np.testing.assert_array_equal(np.asarray(before[k]),
                                      np.asarray(after[k]), err_msg=k)
    # ids past the declared space grow the replica table
    g1 = t.route_adds(np.array([400]), np.array([451]))
    np.testing.assert_array_equal(g1, r.route_adds(np.array([400]),
                                                   np.array([451])))
    assert t.n_vertices == 452
    np.testing.assert_array_equal(t.route_deletes(tg.src, tg.dst), part)
    assert_same_state(r, t, "after growth")


def test_pair_table_two_tier():
    t, r = TE._PairTable(), RE._PairTable()
    k1 = TE.pair_keys(np.arange(10), np.arange(10) + 100)
    np.testing.assert_array_equal(
        k1, RE.pair_keys(np.arange(10), np.arange(10) + 100))
    for tab in (t, r):
        tab.put(k1, np.arange(10, dtype=np.int32) % 3)
    np.testing.assert_array_equal(t.get(k1), np.arange(10) % 3)
    t.merge()
    assert len(t.overlay) == 0 and len(t) == 10
    # the overlay wins over the base, before and after a merge
    for tab in (t, r):
        tab.put(k1[:4], np.full(4, 2, np.int32))
    np.testing.assert_array_equal(t.get(k1[:4]), [2, 2, 2, 2])
    t.merge()
    np.testing.assert_array_equal(t.get(k1), r.get(k1))
    for a, b in zip(t.snapshot(), r.snapshot()):
        np.testing.assert_array_equal(a, b)
    assert t.get(TE.pair_keys(np.array([7]), np.array([999])))[0] == -1
    # a merge triggered by size keeps the last value of each key
    big = TE.pair_keys(np.arange(TE._MERGE_AT), np.arange(TE._MERGE_AT) + 1)
    t.put(big, np.ones(big.size, np.int32))
    assert not t.overlay
    np.testing.assert_array_equal(t.get(big[:3]), [1, 1, 1])


def test_ebv_stream_ingest_and_delta_bit_identical(tmp_path):
    """One edge log through ``streaming_ingest(..., "ebv")`` in both
    packages, then one EdgeDelta (deletes of resident pairs, re-adds and
    new pairs with new ids): host arrays and router states equal after
    each step."""
    rg, _ = _graphs("powerlaw", seed=5)
    log = str(tmp_path / "log")
    RS.write_edge_log(rg, log, chunk_size=512)
    rpg, rctx, _ = RS.streaming_ingest(log, 4, "ebv", seed=0)
    tpg, tctx, _ = TS.streaming_ingest(log, 4, "ebv", seed=0)
    assert isinstance(tctx.router_state, TE.EBVRouterState)
    assert_same_pg(rpg, tpg, "ingest")
    assert_same_state(rctx.router_state, tctx.router_state, "ingest")
    assert partition_metrics(tpg).imbalance <= 1.2

    rng = np.random.default_rng(9)
    n = rg.n_vertices
    add_s = np.concatenate([rg.src[:64], rng.integers(0, n + 40, 200)])
    add_d = np.concatenate([rg.dst[:64], rng.integers(0, n + 40, 200)])
    w = rng.random(add_s.size).astype(np.float32) + 0.5
    kw = dict(del_src=rg.src[:64], del_dst=rg.dst[:64], add_src=add_s,
              add_dst=add_d, add_w=w)
    rst = RS.apply_delta(rpg, rctx, RS.EdgeDelta(**kw))
    tst = TS.apply_delta(tpg, tctx, TS.EdgeDelta(**kw))
    assert (tst.n_added, tst.n_deleted) == (rst.n_added, rst.n_deleted)
    assert_same_pg(rpg, tpg, "delta")
    assert_same_state(rctx.router_state, tctx.router_state, "delta")
    # deletes of resident pairs find them through the pair table
    n0 = tpg.n_edges
    tst = TS.apply_delta(tpg, tctx, TS.EdgeDelta(del_src=rg.src[100:164],
                                                 del_dst=rg.dst[100:164]))
    assert tst.n_deleted == 64 and tpg.n_edges == n0 - 64
