"""Edge-layout parity: the port's stacked ``EdgeLayouts`` — geometry and
the realized tiles of the three programs' (semiring, edge_values, dtype)
keys — are bit-identical to the JAX package's, and the device tensors hold
the same values."""
import dataclasses

import numpy as np
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
