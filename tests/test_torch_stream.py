"""Streaming parity: the port's ``repro_torch.stream`` against the JAX
package's ``repro.stream`` on the same inputs — edge logs written by each
package and read by the other, ``streaming_ingest`` for every pure router,
one ``EdgeDelta`` sequence applied through both (every ``PartitionedGraph``
array, every ``DeltaStats`` field, the remap, the ``EdgeLayouts`` host
arrays and the tile realizations bit-identical after each step, and the
port's device lists rebuilt from the patched geometry), ``compact``,
``remap_state``, ``DeltaBuffer`` coalescing, and BSP checkpoints written by
one engine and resumed by the other."""
import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import repro.algos as RA
import repro.graphgen as RG
import repro.stream as RS
import repro_torch.algos as TA
import repro_torch.graphgen as TG
import repro_torch.stream as TS
from repro.core import EngineConfig as RCfg
from repro.core import partition_and_build as rbuild_pg
from repro.core import run_sim as rrun
from repro.core.subgraph import ShapePolicy as RPolicy
from repro.core.subgraph import _pad_to as rpad_to
from repro.core.subgraph import recompute_frontier as rrecompute
from repro_torch.core import EngineConfig as TCfg
from repro_torch.core import run_sim as trun
from repro_torch.core.layouts import build_edge_layouts as tbuild_lay
from repro_torch.core.partition import STREAM_ROUTERS
from repro_torch.core.subgraph import ShapePolicy as TPolicy
from repro_torch.core.subgraph import _pad_to as tpad_to
from repro_torch.core.subgraph import recompute_frontier as trecompute
from repro_torch.interop import partitioned_graph_from_arrays

PG_ARRAYS = ("gvid", "vmask", "esrc", "edst", "ew", "emask", "slot",
             "is_frontier", "out_deg", "in_deg", "is_master",
             "frontier_gvid")
PG_SCALARS = ("n_parts", "n_vertices", "n_edges", "n_slots", "v_max",
              "e_max")
LAYOUT_ARRAYS = ("tile_dst", "tile_src", "n_tiles", "edge_tile", "edge_r",
                 "edge_c", "eslot", "ldst", "bwin", "n_blocks")
LAYOUT_SCALARS = ("n_parts", "v_max", "e_max", "t_max", "b_max",
                  "block_edges", "n_dst_tiles", "n_src_tiles", "n_windows")
REALIZATIONS = [("min_plus", "weight", np.float32),    # SSSP
                ("min_plus", "zero", np.int32),        # CC
                ("plus_times", "one", np.float32)]     # PageRank
ROUTERS = sorted(STREAM_ROUTERS)


def assert_same_pg(rpg, tpg, where=""):
    for name in PG_SCALARS:
        assert getattr(rpg, name) == getattr(tpg, name), (where, name)
    for name in PG_ARRAYS:
        r, t = getattr(rpg, name), getattr(tpg, name)
        np.testing.assert_array_equal(r, t, err_msg=f"{where} {name}")
        assert r.dtype == t.dtype, (where, name)
    assert (rpg.edge_part is None) == (tpg.edge_part is None), where
    assert (rpg.edge_layouts is None) == (tpg.edge_layouts is None), where


def assert_same_layouts(rpg, tpg, where=""):
    rl, tl = rpg.edge_layouts, tpg.edge_layouts
    for name in LAYOUT_SCALARS:
        assert getattr(rl, name) == getattr(tl, name), (where, name)
    for name in LAYOUT_ARRAYS:
        r, t = getattr(rl, name), getattr(tl, name)
        np.testing.assert_array_equal(r, t, err_msg=f"{where} {name}")
        assert r.dtype == t.dtype, (where, name)
    assert sorted(rl._tiles) == sorted(tl._tiles), where
    for key in rl._tiles:
        np.testing.assert_array_equal(rl._tiles[key], tl._tiles[key],
                                      err_msg=f"{where} tiles {key}")
        np.testing.assert_array_equal(rl._filled[key], tl._filled[key])
        assert rl._density[key] == tl._density[key], (where, key)


def assert_same_stats(rst, tst, where=""):
    """Every field of the reference's stats dataclass, remap included."""
    for f in dataclasses.fields(rst):
        r, t = getattr(rst, f.name), getattr(tst, f.name)
        if isinstance(r, np.ndarray) or isinstance(t, np.ndarray):
            np.testing.assert_array_equal(r, t, err_msg=f"{where} {f.name}")
            assert r.dtype == t.dtype, (where, f.name)
        else:
            assert r == t, (where, f.name, r, t)


def assert_same_plan(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def _port_pg(rpg):
    """The port's copy of a reference PartitionedGraph."""
    return partitioned_graph_from_arrays(
        {f.name: getattr(rpg, f.name) for f in dataclasses.fields(rpg)})


def _graphs(n, seed, weighted=True):
    """The same power-law graph from each package (undirected when
    weighted; an unweighted one keeps ``weight=None``)."""
    rg = RG.powerlaw_graph(n, seed=seed, weighted=weighted)
    tg = TG.powerlaw_graph(n, seed=seed, weighted=weighted)
    if weighted:
        rg, tg = rg.as_undirected(), tg.as_undirected()
    np.testing.assert_array_equal(rg.src, tg.src)
    return rg, tg


# --------------------------------------------------------------------------- #
# edge log: each package reads the other's, and the files are the same bytes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_edge_log_cross_package(tmp_path, writer, weighted):
    rg, tg = _graphs(600, 2, weighted=weighted)
    wmod, rmod = (RS, TS) if writer == "jax" else (TS, RS)
    g = rg if writer == "jax" else tg
    meta = wmod.write_edge_log(g, str(tmp_path / "a"), chunk_size=777)
    rd = rmod.EdgeLogReader(str(tmp_path / "a"))
    assert dataclasses.astuple(rd.meta) == dataclasses.astuple(meta)
    s, d, w = rd.read_all()
    np.testing.assert_array_equal(s, g.src)
    np.testing.assert_array_equal(d, g.dst)
    if weighted:
        np.testing.assert_array_equal(w, g.weight)
    else:
        assert w is None
    chunks = list(rd.chunks())
    assert [c[0].shape[0] for c in chunks] == \
        [777] * (g.n_edges // 777) + ([g.n_edges % 777] if g.n_edges % 777
                                      else [])
    # the other package writes byte-identical files for the same edges
    other = TS if writer == "jax" else RS
    other.write_edge_log(rg if writer == "port" else tg,
                         str(tmp_path / "b"), chunk_size=777)
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "a", tmp_path / "b",
                                           names, shallow=False)
    assert not mismatch and not errors


def test_edge_log_writer_appends_and_widens_id_space(tmp_path):
    """Misaligned appends, a declared id space that is too small: the port's
    writer produces the reference's chunks and manifest."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 500, 5000)
    dst = rng.integers(0, 500, 5000)
    w = rng.uniform(0, 1, 5000).astype(np.float32)
    for mod, name in ((RS, "r"), (TS, "t")):
        with mod.EdgeLogWriter(str(tmp_path / name), chunk_size=999,
                               weighted=True, n_vertices=100) as wr:
            for lo in range(0, 5000, 1303):
                wr.append(src[lo:lo + 1303], dst[lo:lo + 1303],
                          w[lo:lo + 1303])
    names = sorted(os.listdir(tmp_path / "r"))
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "r", tmp_path / "t",
                                           names, shallow=False)
    assert not mismatch and not errors
    assert TS.EdgeLogReader(str(tmp_path / "t")).meta.n_vertices == \
        int(max(src.max(), dst.max())) + 1


# --------------------------------------------------------------------------- #
# streaming ingest
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("router", ROUTERS)
def test_streaming_ingest_parity(tmp_path, router):
    rg, _ = _graphs(2000, 11)
    RS.write_edge_log(rg, str(tmp_path / "log"), chunk_size=4096)
    rpg, rctx, rst = RS.streaming_ingest(str(tmp_path / "log"), 6, router,
                                         seed=3)
    tpg, tctx, tst = TS.streaming_ingest(str(tmp_path / "log"), 6, router,
                                         seed=3)
    assert_same_pg(rpg, tpg, router)
    for name in ("partitioner", "n_parts", "seed", "n_vertices",
                 "routing_n_vertices"):
        assert getattr(rctx, name) == getattr(tctx, name), name
    np.testing.assert_array_equal(rctx.routing_degrees, tctx.routing_degrees)
    for name in ("n_edges", "n_chunks", "chunk_size", "spill_chunk_size",
                 "peak_stream_bytes", "stream_bound_bytes",
                 "peak_assemble_bytes"):
        assert getattr(rst, name) == getattr(tst, name), name
    src = np.arange(0, rg.n_vertices, 7, dtype=np.int64)
    dst = src[::-1].copy()
    for fn in ("route", "route_adds", "route_deletes"):
        np.testing.assert_array_equal(getattr(rctx, fn)(src, dst),
                                      getattr(tctx, fn)(src, dst))


def test_streaming_ingest_refuses_stateful_and_unknown_routers(tmp_path):
    """A stateful router streams through the state ingest builds; a bare
    context without one refuses to route, and an unknown router is
    refused outright."""
    rg, _ = _graphs(300, 1)
    RS.write_edge_log(rg, str(tmp_path / "log"), chunk_size=1024)
    _, ctx, _ = TS.streaming_ingest(str(tmp_path / "log"), 4, "ebv")
    assert ctx.router_state is not None
    bare = TS.StreamContext("ebv", 4, 0, rg.n_vertices,
                            np.zeros(rg.n_vertices, np.int64))
    with pytest.raises(ValueError, match="stateful"):
        bare.route(np.array([1]), np.array([2]))
    with pytest.raises(ValueError, match="streamable"):
        TS.streaming_ingest(str(tmp_path / "log"), 4, "greedy-ec")


# --------------------------------------------------------------------------- #
# one EdgeDelta sequence through both packages
# --------------------------------------------------------------------------- #
def _delta_script(g, rng):
    """Inserts, deletes (resident and not), a same-batch add+delete, id
    growth, then growth across an e_max bucket and across a v_max bucket."""
    n, E = g.n_vertices, g.n_edges

    def adds(k, lo, hi):
        return dict(add_src=rng.integers(lo, hi, k),
                    add_dst=rng.integers(lo, hi, k),
                    add_w=rng.uniform(1, 9, k).astype(np.float32))

    pick = rng.choice(E, 60, replace=False)
    steps = [
        ("insert", adds(80, 0, n)),
        ("delete", dict(del_src=np.concatenate([g.src[pick], [0, 1]]),
                        del_dst=np.concatenate([g.dst[pick], [n - 1, n - 2]]))),
        ("add+delete", dict(add_src=[g.src[0], 3], add_dst=[g.dst[0], 4],
                            add_w=np.array([7.5, 2.0], np.float32),
                            del_src=[g.src[0], 3], del_dst=[g.dst[0], 4])),
        ("id growth", adds(40, n - 20, n + 30)),
        ("e_max bucket", adds(2 * E, 0, n + 30)),
        ("v_max bucket", adds(3 * n, n + 30, 4 * n)),
    ]
    return steps


@pytest.mark.parametrize("policy", [dict(), dict(growth=1.0,
                                                  bucket_slots=False)],
                         ids=["bucketed", "exact"])
def test_delta_sequence_bit_identical(policy):
    rg, tg = _graphs(900, 5)
    rpol, tpol = RPolicy(**policy), TPolicy(**policy)
    from repro.core import build_partitioned_graph as rbuild
    from repro.core.partition import cdbh_vertex_cut as rcdbh
    from repro_torch.core import build_partitioned_graph as tbuild
    from repro_torch.core.partition import cdbh_vertex_cut as tcdbh
    rpg = rbuild(rg, rcdbh(rg, 4), 4, shape_policy=rpol)
    tpg = tbuild(tg, tcdbh(tg, 4), 4, shape_policy=tpol)
    rctx = RS.StreamContext("cdbh", 4, 0, rg.n_vertices, rg.total_degrees())
    tctx = TS.StreamContext("cdbh", 4, 0, tg.n_vertices, tg.total_degrees())
    rpg.ensure_edge_layouts(shape_policy=rpol)
    tpg.ensure_edge_layouts(shape_policy=tpol)

    moved = set()
    for name, kw in _delta_script(rg, np.random.default_rng(9)):
        # every realization is live, so a patch refreshes their rows
        for sr, ev, dt in REALIZATIONS:
            rpg.edge_layouts.tile_values(rpg, sr, ev, dt)
            tpg.edge_layouts.tile_values(tpg, sr, ev, dt)
        assert_same_layouts(rpg, tpg, f"before {name}")
        lay = tpg.edge_layouts
        stale = {k: lay.device_tiles(tpg, sr, ev, dt, "cpu")
                 for k, (sr, ev, dt) in enumerate(REALIZATIONS)}
        stale["w"] = lay.device_windows("cpu")
        shapes = (tpg.v_max, tpg.e_max, lay.t_max, lay.b_max)
        rst = RS.apply_delta(rpg, rctx, RS.EdgeDelta(**kw),
                             shape_policy=rpol)
        tst = TS.apply_delta(tpg, tctx, TS.EdgeDelta(**kw),
                             shape_policy=tpol)
        assert_same_stats(rst, tst, name)
        assert_same_pg(rpg, tpg, name)
        assert_same_layouts(rpg, tpg, name)
        new = tpg.edge_layouts
        if new.shape_key("pallas_tiles") != (
                "tiles", shapes[2], -(-shapes[0] // 128),
                -(-shapes[0] // 128)):
            moved.add("t_max")
        moved.update(n for n, a, b in (("v_max", shapes[0], tpg.v_max),
                                       ("e_max", shapes[1], tpg.e_max))
                     if a != b)
        # the device lists were dropped: the kernels' next inputs describe
        # the patched geometry, exactly as a fresh build's do
        assert new is not lay or not lay._device, name
        fresh = tbuild_lay(tpg, tpol)
        for k, (sr, ev, dt) in enumerate(REALIZATIONS):
            got = new.device_tiles(tpg, sr, ev, dt, "cpu")
            want = fresh.device_tiles(tpg, sr, ev, dt, "cpu")
            assert got is not stale[k]
            for a, b in zip(got[:3], want[:3]):
                assert torch.equal(a, b), (name, sr, ev)
            assert_same_plan(got.plan, want.plan)
        gw, ww = new.device_windows("cpu"), fresh.device_windows("cpu")
        assert gw is not stale["w"]
        for a, b in zip(gw[:3], ww[:3]):
            assert torch.equal(a, b), name
        assert_same_plan(gw.plan, ww.plan)
        # remap_state carries a live block across the patch
        state = np.random.default_rng(1).random(
            (4, shapes[0], 2)).astype(np.float32)
        np.testing.assert_array_equal(rst.remap_state(state, -1.0),
                                      tst.remap_state(state, -1.0))
    assert {"v_max", "e_max"} <= moved
    if policy:      # bucketed: layout capacities crossed a bucket too
        assert "t_max" in moved


def test_empty_delta_and_refused_inputs():
    rg, tg = _graphs(300, 6)
    rpg = rbuild_pg(rg, 4)
    tpg = _port_pg(rpg)
    rctx = RS.StreamContext("cdbh", 4, 0, rg.n_vertices, rg.total_degrees())
    tctx = TS.StreamContext("cdbh", 4, 0, tg.n_vertices, tg.total_degrees())
    rst = RS.apply_delta(rpg, rctx, RS.EdgeDelta())
    tst = TS.apply_delta(tpg, tctx, TS.EdgeDelta())
    assert_same_stats(rst, tst)
    state = np.ones((4, tpg.v_max), np.float32)
    np.testing.assert_array_equal(tst.remap_state(state, 0.0), state)
    with pytest.raises(ValueError):
        TS.EdgeDelta(add_src=[0, 1], add_dst=[1])
    with pytest.raises(ValueError):
        TS.compact(tpg, TS.StreamContext("cdbh", 3, 0, tg.n_vertices,
                                         tg.total_degrees()))


# --------------------------------------------------------------------------- #
# compaction
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_layouts", [False, True])
def test_compact_parity_and_remap_state(with_layouts):
    rg, tg = _graphs(1200, 8)
    pol = dict(growth=2.0)
    from repro.core import build_partitioned_graph as rbuild
    from repro.core.partition import cdbh_vertex_cut as rcdbh
    rpg = rbuild(rg, rcdbh(rg, 4), 4, shape_policy=RPolicy(**pol))
    tpg = _port_pg(rpg)
    rctx = RS.StreamContext("cdbh", 4, 0, rg.n_vertices, rg.total_degrees())
    tctx = TS.StreamContext("cdbh", 4, 0, tg.n_vertices, tg.total_degrees())
    if with_layouts:
        rpg.ensure_edge_layouts(shape_policy=RPolicy(**pol))
        tpg.ensure_edge_layouts(shape_policy=TPolicy(**pol))
        tpg.edge_layouts.device_windows("cpu")
    old_lay = tpg.edge_layouts
    # delete-heavy traffic: 70% of the edges go
    pick = np.random.default_rng(2).random(rg.n_edges) < 0.7
    kw = dict(del_src=rg.src[pick], del_dst=rg.dst[pick])
    RS.apply_delta(rpg, rctx, RS.EdgeDelta(**kw), shape_policy=RPolicy(**pol))
    TS.apply_delta(tpg, tctx, TS.EdgeDelta(**kw), shape_policy=TPolicy(**pol))
    v_before = tpg.v_max
    rcs = RS.compact(rpg, rctx, shape_policy=RPolicy(**pol))
    tcs = TS.compact(tpg, tctx, shape_policy=TPolicy(**pol))
    assert_same_stats(rcs, tcs)
    assert tcs.n_evicted > 0 and tcs.shrunk == rcs.shrunk
    assert_same_pg(rpg, tpg)
    if with_layouts:
        assert_same_layouts(rpg, tpg)
        assert tpg.edge_layouts is not old_lay
        assert not tpg.edge_layouts._device
    state = np.random.default_rng(3).integers(
        0, 100, (4, v_before, 3)).astype(np.int32)
    np.testing.assert_array_equal(rcs.remap_state(state, -7),
                                  tcs.remap_state(state, -7))


def test_recompute_frontier_and_pad_to_parity():
    rg, _ = _graphs(500, 4)
    rpg = rbuild_pg(rg, 4)
    tpg = _port_pg(rpg)
    # drop one partition's members: fresh slots and masters
    for pg in (rpg, tpg):
        pg.vmask[1, 5:] = False
    rrecompute(rpg)
    trecompute(tpg)
    assert_same_pg(rpg, tpg)
    a = np.arange(12, dtype=np.int32).reshape(4, 3)
    np.testing.assert_array_equal(rpad_to(a, 7, -1), tpad_to(a, 7, -1))


# --------------------------------------------------------------------------- #
# DeltaBuffer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bounds", [dict(max_edges=48),
                                    dict(max_edges=None, max_parts=3)],
                         ids=["max_edges", "max_parts"])
def test_delta_buffer_coalescing_parity(bounds):
    rg, tg = _graphs(800, 3)
    rpg = rbuild_pg(rg, 4)
    tpg = _port_pg(rpg)
    rctx = RS.StreamContext("cdbh", 4, 0, rg.n_vertices, rg.total_degrees())
    tctx = TS.StreamContext("cdbh", 4, 0, tg.n_vertices, tg.total_degrees())
    rbuf = RS.DeltaBuffer(rpg, rctx, **bounds)
    tbuf = TS.DeltaBuffer(tpg, tctx, **bounds)
    rng = np.random.default_rng(4)
    n = rg.n_vertices
    for i in range(400):
        s, t = (int(x) for x in rng.integers(0, n + 10, 2))
        op = rng.random()
        for buf, mod in ((rbuf, RS), (tbuf, TS)):
            if op < 0.45:
                buf.add(s, t, np.float32(1 + i % 5))
            elif op < 0.55:          # repeated pair: merges in the buffer
                buf.add(s % 7, 1 + s % 5, 3.0)
            elif op < 0.9:
                buf.delete(s, t)
            else:                    # a whole producer batch
                buf.push(mod.EdgeDelta(add_src=[s], add_dst=[t],
                                       add_w=np.array([2.0], np.float32),
                                       del_src=[t], del_dst=[s]))
        assert len(rbuf) == len(tbuf) and \
            rbuf.pending_parts == tbuf.pending_parts
    rst, tst = rbuf.flush(), tbuf.flush()
    assert (rst is None) == (tst is None)
    assert dataclasses.astuple(rbuf.stats) == dataclasses.astuple(tbuf.stats)
    assert rbuf.stats.auto_flushes >= 1 and rbuf.stats.coalesced > 0
    assert_same_stats(rbuf.last_flush, tbuf.last_flush)
    assert_same_pg(rpg, tpg)


# --------------------------------------------------------------------------- #
# BSP checkpoints across the two engines
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("algo", ["sssp", "cc", "pagerank"])
def test_checkpoint_resumes_across_engines(tmp_path, writer, algo):
    rg, _ = _graphs(400, 12)
    rpg = rbuild_pg(rg, 4)
    tpg = _port_pg(rpg)
    rprog, tprog, params = {
        "sssp": (RA.SSSP(), TA.SSSP(), {"source": 0}),
        "cc": (RA.ConnectedComponents(), TA.ConnectedComponents(), None),
        "pagerank": (RA.PageRank(), TA.PageRank(),
                     {"n_vertices": rg.n_vertices})}[algo]
    d = str(tmp_path / "ckpt")
    r_full, r_st = rrun(rprog, rpg, params,
                        RCfg(trace=True, checkpoint_every=1,
                             checkpoint_dir=d if writer == "jax" else None))
    t_full, t_st = trun(tprog, tpg, params,
                        TCfg(trace=True, checkpoint_every=1,
                             checkpoint_dir=d if writer == "port" else None),
                        device="cpu")
    assert sorted(os.listdir(d)) == [
        f"bsp_{s:06d}.npz" for s in range(1, r_st.supersteps + 1)]
    # resume from before the last superstep: the job finishes as the
    # uninterrupted one did (a checkpoint of the halting superstep resumes
    # into one more, empty, superstep in both engines)
    ck = os.path.join(d, "bsp_000001.npz")
    r_res, r_rst = rrun(rprog, rpg, params, RCfg(trace=True),
                        resume_from=ck)
    t_res, t_rst = trun(tprog, tpg, params, TCfg(trace=True),
                        resume_from=ck, device="cpu")
    assert t_rst.supersteps == r_rst.supersteps == r_st.supersteps
    if algo == "pagerank":
        np.testing.assert_allclose(t_res, r_res, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t_res, r_full, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(t_res, r_res)
        np.testing.assert_array_equal(t_res, r_full)
        np.testing.assert_array_equal(t_full, r_full)
        assert t_rst.messages_per_step == r_rst.messages_per_step == \
            r_st.messages_per_step[1:]
        assert t_rst.total_messages == r_rst.total_messages
    last = os.path.join(d, f"bsp_{r_st.supersteps:06d}.npz")
    _, r_last = rrun(rprog, rpg, params, RCfg(trace=True), resume_from=last)
    _, t_last = trun(tprog, tpg, params, TCfg(trace=True), resume_from=last,
                     device="cpu")
    assert t_last.supersteps == r_last.supersteps == r_st.supersteps + 1


def test_resume_needs_trace_mode(tmp_path):
    tpg = _port_pg(rbuild_pg(_graphs(200, 1)[0], 4))
    with pytest.raises(ValueError, match="trace"):
        trun(TA.SSSP(), tpg, {"source": 0}, TCfg(),
             resume_from=str(tmp_path / "x.npz"), device="cpu")
