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
        blk = tl.device_tiles(tpg, semiring, ev, dt, "cpu")
        np.testing.assert_array_equal(blk.tiles.numpy(), t)
        np.testing.assert_array_equal(blk.tile_dst.numpy(), rl.tile_dst)
    wb = tl.device_windows("cpu")
    for name in ("eslot", "ldst", "bwin"):
        np.testing.assert_array_equal(getattr(wb, name).numpy(),
                                      getattr(rl, name))


def test_ensure_edge_layouts_caches_and_sticks_to_policy():
    rpg, tpg = _pgs(RG.kronecker_graph(9, seed=2), "cdbh", 4)
    lay = tpg.ensure_edge_layouts(shape_policy=TShapePolicy())
    assert tpg.ensure_edge_layouts() is lay
    ref = rpg.ensure_edge_layouts(shape_policy=RShapePolicy())
    assert (lay.t_max, lay.b_max) == (ref.t_max, ref.b_max)
    assert lay.device_windows("cpu") is lay.device_windows("cpu")
