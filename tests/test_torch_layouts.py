"""Edge-layout parity: the port's stacked ``EdgeLayouts`` — geometry and
the realized tiles of the three programs' (semiring, edge_values, dtype)
keys — are bit-identical to the JAX package's, and the device tensors hold
the same values."""
import dataclasses

import numpy as np
import torch
import pytest

import repro.core as R
import repro.graphgen as RG
from repro.core.layouts import build_edge_layouts as rbuild
from repro.core.subgraph import ShapePolicy as RShapePolicy
from repro_torch.core.layouts import build_edge_layouts as tbuild
from repro_torch.core.subgraph import ShapePolicy as TShapePolicy
from repro_torch.interop import partitioned_graph_from_arrays

GEOMETRY = ("tile_dst", "tile_src", "n_tiles", "edge_tile", "edge_r",
            "edge_c", "eslot", "ldst", "bwin", "n_blocks")
REALIZATIONS = [("min_plus", "weight", np.float32),    # SSSP
                ("min_plus", "zero", np.int32),        # CC
                ("plus_times", "one", np.float32)]     # PageRank


def _pgs(graph, partitioner, n_parts):
    rpg = R.partition_and_build(graph, n_parts, partitioner)
    tpg = partitioned_graph_from_arrays(
        {f.name: getattr(rpg, f.name) for f in dataclasses.fields(rpg)})
    return rpg, tpg


@pytest.mark.parametrize("case", [
    ("powerlaw-cdbh", lambda: RG.powerlaw_graph(900, seed=5, weighted=True)
     .as_undirected(), "cdbh", 4, {}),
    ("grid-range", lambda: RG.grid_graph(40, weighted=True, seed=9),
     "range", 4, {}),
    ("kron-cdbh-bucketed", lambda: RG.kronecker_graph(10, seed=7), "cdbh",
     8, dict(growth=2.0)),
], ids=lambda c: c[0])
def test_edge_layouts_bit_identical(case):
    _, make, partitioner, n_parts, policy = case
    rpg, tpg = _pgs(make(), partitioner, n_parts)
    rl = rbuild(rpg, RShapePolicy(**policy) if policy
                else RShapePolicy.exact())
    tl = tbuild(tpg, TShapePolicy(**policy) if policy
                else TShapePolicy.exact())
    for name in ("t_max", "b_max", "block_edges", "n_dst_tiles",
                 "n_src_tiles", "n_windows"):
        assert getattr(rl, name) == getattr(tl, name), name
    for name in GEOMETRY:
        r, t = getattr(rl, name), getattr(tl, name)
        np.testing.assert_array_equal(r, t, err_msg=name)
        assert r.dtype == t.dtype, name
    for kind in ("pallas_tiles", "pallas_windows"):
        assert rl.shape_key(kind) == tl.shape_key(kind)
        np.testing.assert_array_equal(rl.flops_per_sweep(kind, 1),
                                      tl.flops_per_sweep(kind, 1))
    for semiring, ev, dt in REALIZATIONS:
        r = rl.tile_values(rpg, semiring, ev, dt)
        t = tl.tile_values(tpg, semiring, ev, dt)
        assert r.dtype == t.dtype
        np.testing.assert_array_equal(r, t, err_msg=f"{semiring}/{ev}")
        assert rl.density(rpg, semiring, ev, dt) == \
            tl.density(tpg, semiring, ev, dt)
        np.testing.assert_array_equal(
            rl.partition_density(rpg, semiring, ev, dt),
            tl.partition_density(tpg, semiring, ev, dt))
        # the device list is the reference's real tiles, ids offset by
        # partition
        blk = tl.device_tiles(tpg, semiring, ev, dt, "cpu")
        np.testing.assert_array_equal(blk.tiles.numpy(),
                                      _compact(r, rl.n_tiles))
        np.testing.assert_array_equal(
            blk.tile_dst.numpy(), _compact(rl.tile_dst, rl.n_tiles,
                                           rl.n_dst_tiles))
        np.testing.assert_array_equal(
            blk.tile_src.numpy(), _compact(rl.tile_src, rl.n_tiles,
                                           rl.n_src_tiles))
    wb = tl.device_windows("cpu")
    Be = rl.block_edges
    np.testing.assert_array_equal(wb.ldst.numpy(),
                                  _compact(rl.ldst, rl.n_blocks * Be))
    np.testing.assert_array_equal(
        wb.bwin.numpy(), _compact(rl.bwin, rl.n_blocks, rl.n_windows))
    # every real edge lands in the compact buffer row that holds the same
    # local dst as its reference slot; padding edges on the dump row
    real = rl.eslot >= 0
    row0 = (np.cumsum(rl.n_blocks) - rl.n_blocks) * Be
    slot = wb.slot.numpy().reshape(rl.eslot.shape)
    np.testing.assert_array_equal(slot[real],
                                  (rl.eslot + row0[:, None])[real])
    assert (slot[~real] == int(rl.n_blocks.sum()) * Be).all()


def _compact(a, counts, offset=0):
    """The first ``counts[p]`` entries of each row ``a[p]``, plus
    ``p * offset``, concatenated over p."""
    return np.concatenate([a[p, :counts[p]] + p * offset
                           for p in range(a.shape[0])])


def test_ensure_edge_layouts_caches_and_sticks_to_policy():
    rpg, tpg = _pgs(RG.kronecker_graph(9, seed=2), "cdbh", 4)
    lay = tpg.ensure_edge_layouts(shape_policy=TShapePolicy())
    assert tpg.ensure_edge_layouts() is lay
    ref = rpg.ensure_edge_layouts(shape_policy=RShapePolicy())
    assert (lay.t_max, lay.b_max) == (ref.t_max, ref.b_max)
    assert lay.device_windows("cpu") is lay.device_windows("cpu")


@pytest.mark.parametrize("case", [
    ("powerlaw-cdbh", lambda: RG.powerlaw_graph(900, seed=5, weighted=True)
     .as_undirected(), "cdbh", 4, {}),
    ("kron-cdbh-bucketed", lambda: RG.kronecker_graph(10, seed=7), "cdbh",
     8, dict(growth=2.0)),
], ids=lambda c: c[0])
def test_compact_device_lists(case):
    """The device lists hold exactly the real tiles / blocks, stay sorted,
    cover every dst row / window, and their chunk plans cover them."""
    _, make, partitioner, n_parts, policy = case
    _, tpg = _pgs(make(), partitioner, n_parts)
    tl = tbuild(tpg, TShapePolicy(**policy) if policy
                else TShapePolicy.exact())
    P = tl.n_parts
    if policy:       # the bucketed layout pads: compaction drops something
        assert tl.t_max * P > tl.n_tiles.sum()
        assert tl.b_max * P > tl.n_blocks.sum()
    tb = tl.device_tiles(tpg, "min_plus", "weight", np.float32, "cpu")
    wb = tl.device_windows("cpu")
    for ids, n, n_rows, plan in (
            (tb.tile_dst, tl.n_tiles.sum(), P * tl.n_dst_tiles, tb.plan),
            (wb.bwin, tl.n_blocks.sum(), P * tl.n_windows, wb.plan)):
        ids = ids.numpy()
        assert ids.shape == (n,)
        assert (np.diff(ids) >= 0).all()
        np.testing.assert_array_equal(np.unique(ids), np.arange(n_rows))
        assert (plan.n_items, plan.n_rows) == (n, n_rows)
    assert tb.tiles.shape == (tl.n_tiles.sum(), 128, 128)
    assert wb.ldst.shape == (tl.n_blocks.sum() * tl.block_edges,)
    assert wb.slot.shape == (P * tl.e_max,)


# --------------------------------------------------------------------------- #
# edge-sharded geometry (shard_map with edge_axes): no process group needed
# --------------------------------------------------------------------------- #
SHARD_GEOMETRY = ("tile_dst", "tile_src", "edge_tile", "edge_r", "edge_c",
                  "eslot", "ldst", "bwin", "n_tiles", "n_blocks")


def _same_sharded(rpg, tpg, S, where):
    rl, tl = rpg.edge_layouts, tpg.edge_layouts
    rg, tg = rl._sharded_geometry(rpg, S), tl._sharded_geometry(tpg, S)
    for k in SHARD_GEOMETRY:
        np.testing.assert_array_equal(tg[k], rg[k], err_msg=f"{where} {k}")
        assert tg[k].dtype == rg[k].dtype, (where, k)
    assert (tg["t_loc"], tg["b_loc"]) == (rg["t_loc"], rg["b_loc"]), where
    assert tl._shard_caps == rl._shard_caps, where
    for b in ("pallas_tiles", "pallas_windows"):
        assert tl.shape_key(b, n_shards=S, pg=tpg) == \
            rl.shape_key(b, n_shards=S, pg=rpg), (where, b)
        for K in (1, 3):
            np.testing.assert_array_equal(
                tl.flops_per_sweep(b, K, n_shards=S, pg=tpg),
                rl.flops_per_sweep(b, K, n_shards=S, pg=rpg),
                err_msg=f"{where} {b} K={K}")
    return tg


def _shard_products(tpg, S):
    """Per partition: the plain tile and window min-products over each
    shard's device list, and over the partition's unsharded list."""
    from repro_torch.kernels.bsp_spmv import bsp_spmv
    from repro_torch.kernels.segment_combine import segment_combine_windowed
    lay = tpg.edge_layouts
    Se, nst = tpg.e_max // S, lay.n_src_tiles
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.uniform(0, 9, (nst * 128, 1))
                            .astype(np.float32))
    for p in range(tpg.n_parts):
        full = lay.device_tiles(tpg, "min_plus", "weight", np.float32, "cpu",
                                parts=[p])
        want = bsp_spmv(full.tiles, full.tile_dst, full.tile_src,
                        vals.reshape(nst, 128, 1), n_dst_tiles=lay.n_dst_tiles,
                        semiring="min_plus")
        fw = lay.device_windows("cpu", parts=[p])
        esrc = torch.from_numpy(tpg.esrc[p].astype(np.int64))
        msgs = vals[esrc] + torch.from_numpy(tpg.ew[p])[:, None]
        buf = torch.full((fw.ldst.shape[0] + 1, 1), float("inf"))
        buf.index_copy_(0, fw.slot, msgs)
        want_w = segment_combine_windowed(buf[:-1], fw.ldst, fw.bwin,
                                          n_windows=lay.n_windows,
                                          combiner="min")
        got = got_w = None
        for s in range(S):
            tb = lay.device_tiles_sharded(tpg, "min_plus", "weight",
                                          np.float32, S, "cpu", p, s)
            out = bsp_spmv(tb.tiles, tb.tile_dst, tb.tile_src,
                           vals.reshape(nst, 128, 1),
                           n_dst_tiles=lay.n_dst_tiles, semiring="min_plus")
            got = out if got is None else torch.minimum(got, out)
            wb = lay.device_windows_sharded(tpg, S, "cpu", p, s)
            cols = slice(s * Se, (s + 1) * Se)
            m = msgs[cols]
            b = torch.full((wb.ldst.shape[0] + 1, 1), float("inf"))
            b.index_copy_(0, wb.slot, m)
            ow = segment_combine_windowed(b[:-1], wb.ldst, wb.bwin,
                                          n_windows=lay.n_windows,
                                          combiner="min")
            got_w = ow if got_w is None else torch.minimum(got_w, ow)
        assert torch.equal(got, want), p
        assert torch.equal(got_w, want_w), p


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_geometry_bit_identical(S):
    """``_sharded_geometry``, the sharded ``shape_key`` and
    ``flops_per_sweep`` equal the reference's array for array, before and
    after a flush that grows the per-shard caps; the flush drops the
    sharded geometry and device lists; the per-shard products, min-reduced
    over the shards, equal the partition's product."""
    import repro.stream as RS
    import repro_torch.stream as TS
    from repro.core import build_partitioned_graph as rbuild_pg
    from repro.core.partition import cdbh_vertex_cut as rcdbh
    from repro_torch.core import build_partitioned_graph as tbuild_pg
    from repro_torch.core.partition import cdbh_vertex_cut as tcdbh
    import repro_torch.graphgen as TG
    rg = RG.powerlaw_graph(600, seed=4, weighted=True).as_undirected()
    tg = TG.powerlaw_graph(600, seed=4, weighted=True).as_undirected()
    rpol, tpol = RShapePolicy(), TShapePolicy()
    rpg = rbuild_pg(rg, rcdbh(rg, 4), 4, shape_policy=rpol)
    tpg = tbuild_pg(tg, tcdbh(tg, 4), 4, shape_policy=tpol)
    rpg.ensure_edge_layouts(shape_policy=rpol)
    tpg.ensure_edge_layouts(shape_policy=tpol)
    _same_sharded(rpg, tpg, S, "built")
    lay = tpg.edge_layouts
    _shard_products(tpg, S)
    stale = lay.device_windows_sharded(tpg, S, "cpu", 0, 0)
    caps = dict(lay._shard_caps)

    rctx = RS.StreamContext("cdbh", 4, 0, rg.n_vertices, rg.total_degrees())
    tctx = TS.StreamContext("cdbh", 4, 0, tg.n_vertices, tg.total_degrees())
    # every resident pair seven times again: the same partitions (so v_max
    # stays), eight times the edges (so e_max and the block caps grow)
    w = np.random.default_rng(11).uniform(1, 9, 7 * rg.n_edges)
    kw = dict(add_src=np.tile(rg.src, 7), add_dst=np.tile(rg.dst, 7),
              add_w=w.astype(np.float32))
    RS.apply_delta(rpg, rctx, RS.EdgeDelta(**kw), shape_policy=rpol)
    TS.apply_delta(tpg, tctx, TS.EdgeDelta(**kw), shape_policy=tpol)
    assert tpg.edge_layouts is lay and not lay._shard_geom
    _same_sharded(rpg, tpg, S, "after the flush")
    grown = [a - b for a, b in zip(lay._shard_caps[S], caps[S])]
    assert min(grown) >= 0 and max(grown) > 0, (lay._shard_caps, caps)
    assert lay.device_windows_sharded(tpg, S, "cpu", 0, 0) is not stale
    _shard_products(tpg, S)


def test_sharded_geometry_with_empty_shards():
    """A skewed placement leaves the small partitions' last edge shards
    without an edge: their lists are coverage fillers only (one tile per
    dst tile row, one block per window), equal to the reference's, and the
    min over the shards' products still equals the partition's."""
    import repro_torch.graphgen as TG
    from repro.core import build_partitioned_graph as rbuild_pg
    from repro_torch.core import build_partitioned_graph as tbuild_pg
    rg = RG.powerlaw_graph(600, seed=4, weighted=True).as_undirected()
    tg = TG.powerlaw_graph(600, seed=4, weighted=True).as_undirected()
    idx = np.arange(rg.n_edges)
    part = np.where(idx % 10 < 7, 0, idx % 3 + 1).astype(np.int32)
    rpg = rbuild_pg(rg, part.copy(), 4)
    tpg = tbuild_pg(tg, part.copy(), 4)
    rpg.ensure_edge_layouts()
    tpg.ensure_edge_layouts()
    S = 4
    geom = _same_sharded(rpg, tpg, S, "skewed")
    lay = tpg.edge_layouts
    Se = tpg.e_max // S
    empty = [(p, s) for p in range(4) for s in range(S)
             if not tpg.emask[p, s * Se:(s + 1) * Se].any()]
    assert len(empty) >= 3, empty
    for p, s in empty:
        assert (geom["n_tiles"][p, s], geom["n_blocks"][p, s]) == \
            (lay.n_dst_tiles, lay.n_windows)
        tb = lay.device_tiles_sharded(tpg, "min_plus", "weight", np.float32,
                                      S, "cpu", p, s)
        assert torch.equal(tb.tile_dst, torch.arange(lay.n_dst_tiles,
                                                     dtype=torch.int32))
        assert bool((tb.tiles == float("inf")).all())
        wb = lay.device_windows_sharded(tpg, S, "cpu", p, s)
        assert bool((wb.slot == wb.ldst.shape[0]).all())
    _shard_products(tpg, S)


def test_drop_sharded_keeps_unsharded_lists():
    """``shard_counts`` reads the sharded geometry's counts and caps;
    ``drop_sharded`` drops the geometry and every sharded device list, and
    keeps the grow-only caps and the unsharded lists."""
    import repro_torch.graphgen as TG
    from repro_torch.core import build_partitioned_graph as tbuild_pg
    from repro_torch.core.partition import cdbh_vertex_cut as tcdbh
    tg = TG.powerlaw_graph(600, seed=4, weighted=True).as_undirected()
    tpg = tbuild_pg(tg, tcdbh(tg, 4), 4)
    lay = tpg.ensure_edge_layouts()
    S = 2
    counts = lay.shard_counts(tpg, S)
    geom = lay._sharded_geometry(tpg, S)
    for k in ("n_tiles", "n_blocks", "t_loc", "b_loc"):
        np.testing.assert_array_equal(counts[k], geom[k], err_msg=k)
    full_t = lay.device_tiles(tpg, "min_plus", "weight", np.float32, "cpu")
    full_w = lay.device_windows("cpu", parts=[1])
    shard_t = lay.device_tiles_sharded(tpg, "min_plus", "weight",
                                       np.float32, S, "cpu", 1, 1)
    shard_w = lay.device_windows_sharded(tpg, S, "cpu", 1, 0)
    caps = dict(lay._shard_caps)
    lay.drop_sharded()
    assert not lay._shard_geom and lay._shard_caps == caps
    assert lay.device_tiles(tpg, "min_plus", "weight", np.float32,
                            "cpu") is full_t
    assert lay.device_windows("cpu", parts=[1]) is full_w
    again_t = lay.device_tiles_sharded(tpg, "min_plus", "weight",
                                       np.float32, S, "cpu", 1, 1)
    again_w = lay.device_windows_sharded(tpg, S, "cpu", 1, 0)
    assert again_t is not shard_t and again_w is not shard_w
    assert torch.equal(again_t.tiles, shard_t.tiles)
    assert torch.equal(again_w.slot, shard_w.slot)
