"""Kernel parity: the port's plain versions (what its kernel wrappers run on
CPU tensors) against the JAX package's Pallas kernels in interpret mode, on
the case grid of tests/test_kernels.py. min_plus / min / max must be
bit-exact (float32 and int32); plus_times / sum allclose at
rtol = atol = 1e-5, because fp32 sums run in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.bsp_spmv import bsp_spmv as rbsp
from repro.kernels.segment_combine import segment_combine_windowed as rseg
from repro_torch.graphgen import powerlaw_graph
from repro_torch.kernels import bsp_spmv as tb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_combine as ts
from repro_torch.kernels.ref import combine_identity, tile_pad_identity

TM = TN = W = 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand_tiles(rng, T, n_dst, n_src, semiring, dtype, density=0.3):
    tiles = np.full((T, TM, TN), tile_pad_identity(semiring, dtype), dtype)
    mask = rng.random((T, TM, TN)) < density
    if np.dtype(dtype) == np.int32:
        tiles[mask] = rng.integers(0, 50, size=int(mask.sum()))
    else:
        tiles[mask] = rng.uniform(0.1, 5.0, size=int(mask.sum()))
    tile_dst = np.sort(rng.integers(0, n_dst, size=T).astype(np.int32))
    tile_dst[:n_dst] = np.arange(n_dst)
    tile_dst = np.sort(tile_dst)
    tile_src = rng.integers(0, n_src, size=T).astype(np.int32)
    return tiles, tile_dst, tile_src


def _check(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("semiring,dtype", [("plus_times", np.float32),
                                            ("min_plus", np.float32),
                                            ("min_plus", np.int32)])
@pytest.mark.parametrize("T,n_dst,n_src,K", [
    (4, 2, 2, 1), (9, 3, 2, 4), (16, 4, 4, 8), (5, 5, 1, 128),
])
def test_bsp_spmv_matches_pallas(semiring, dtype, T, n_dst, n_src, K):
    rng = np.random.default_rng(T * 100 + K)
    tiles, td, tsrc = _rand_tiles(rng, T, n_dst, n_src, semiring, dtype)
    if np.dtype(dtype) == np.int32:
        vals = rng.integers(0, 1000, size=(n_src, TN, K)).astype(dtype)
    else:
        vals = rng.uniform(0, 3, size=(n_src, TN, K)).astype(dtype)
    want = rbsp(*(jnp.asarray(a) for a in (tiles, td, tsrc, vals)),
                n_dst_tiles=n_dst, semiring=semiring)
    got = tb.bsp_spmv(*(torch.from_numpy(a) for a in (tiles, td, tsrc, vals)),
                      n_dst_tiles=n_dst, semiring=semiring)
    _check(got.numpy(), want, semiring == "min_plus")


@pytest.mark.parametrize("combiner,dtype", [("sum", np.float32),
                                            ("min", np.float32),
                                            ("max", np.float32),
                                            ("min", np.int32),
                                            ("max", np.int32)])
@pytest.mark.parametrize("E,n_rows,K,Be", [
    (100, 64, 1, 128), (1000, 300, 4, 256), (3000, 500, 8, 512),
    (50, 400, 1, 128),  # many empty windows
])
def test_segment_combine_matches_pallas(combiner, dtype, E, n_rows, K, Be):
    rng = np.random.default_rng(E + K)
    dst = np.sort(rng.integers(0, n_rows, size=E).astype(np.int64))
    if np.dtype(dtype) == np.int32:
        msgs = rng.integers(-50, 50, size=(E, K)).astype(dtype)
    else:
        msgs = rng.uniform(-2, 2, size=(E, K)).astype(dtype)
    lay = rops.window_align_edges(dst, n_rows, block_edges=Be)
    buf = np.full((lay.n_blocks * Be, K), combine_identity(combiner, dtype),
                  dtype)
    buf[lay.edge_slot] = msgs[lay.order]
    want = rseg(jnp.asarray(buf), jnp.asarray(lay.local_dst),
                jnp.asarray(lay.block_window), n_windows=lay.n_windows,
                combiner=combiner)
    got = ts.segment_combine_windowed(
        torch.from_numpy(buf), torch.from_numpy(lay.local_dst),
        torch.from_numpy(lay.block_window), n_windows=lay.n_windows,
        combiner=combiner)
    _check(got.numpy(), want, combiner != "sum")


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("kernel", ["tiles", "windowed"])
def test_spmv_end_to_end_powerlaw(semiring, kernel):
    """The single-partition rig of tests/test_kernels.py: the port's
    ``ops.spmv`` against the reference's on the same power-law graph."""
    g = powerlaw_graph(500, seed=2, weighted=True)
    rng = np.random.default_rng(0)
    vals = rng.uniform(0, 3, size=(g.n_vertices, 2)).astype(np.float32)
    want = rops.spmv(g.src, g.dst, g.weights, vals, g.n_vertices,
                     semiring=semiring, kernel=kernel)
    got = tops.spmv(g.src, g.dst, g.weights, vals, g.n_vertices,
                    semiring=semiring, kernel=kernel, device="cpu")
    _check(got.numpy(), want, semiring == "min_plus")


def test_layout_builders_bit_identical():
    g = powerlaw_graph(700, seed=3, weighted=True)
    for semiring, dtype in (("min_plus", np.float32), ("min_plus", np.int32),
                            ("plus_times", np.float32)):
        r = rops.build_tiles(g.src, g.dst, g.weights, 700, 700, semiring,
                             dtype=dtype)
        t = tops.TileLayout(g.src, g.dst, g.weights, 700, 700, semiring,
                            dtype=dtype)
        for name in ("tiles", "tile_dst", "tile_src"):
            _check(getattr(t, name), getattr(r, name), True)
    r = rops.window_align_edges(g.dst, 700, block_edges=256)
    t = tops.WindowLayout(g.dst, 700, block_edges=256)
    for name in ("order", "block_window", "edge_slot", "local_dst",
                 "pad_mask"):
        _check(getattr(t, name), getattr(r, name), True)


def test_int32_tile_layout_min_label():
    """CC's int32 min_plus through the tile rig with the wrap-safe pad."""
    g = powerlaw_graph(300, seed=9)
    vals = np.arange(300, dtype=np.int32)[:, None]
    want = rops.build_tiles(g.src, g.dst, np.zeros(g.n_edges), 300, 300,
                            "min_plus", dtype=np.int32)(jnp.asarray(vals))
    got = tops.TileLayout(g.src, g.dst, np.zeros(g.n_edges), 300, 300,
                          "min_plus", dtype=np.int32)(torch.from_numpy(vals))
    assert got.dtype == torch.int32
    _check(got.numpy(), want, True)


def test_wrappers_validate_and_count():
    z = torch.zeros
    i32 = torch.int32
    before = (tb.bsp_spmv.launches, ts.segment_combine_windowed.launches)
    with pytest.raises(ValueError, match="float"):
        tb.bsp_spmv(z((1, TM, TN), dtype=i32), z(1, dtype=i32),
                    z(1, dtype=i32), z((1, TN, 1), dtype=i32),
                    n_dst_tiles=1, semiring="plus_times")
    with pytest.raises(ValueError, match="dtype"):
        tb.bsp_spmv(z((1, TM, TN)), z(1, dtype=i32), z(1, dtype=i32),
                    z((1, TN, 1), dtype=i32), n_dst_tiles=1,
                    semiring="min_plus")
    with pytest.raises(ValueError, match="int32"):
        tb.bsp_spmv(z((1, TM, TN)), z(1, dtype=torch.int64),
                    z(1, dtype=i32), z((1, TN, 1)), n_dst_tiles=1)
    with pytest.raises(ValueError, match="float"):
        ts.segment_combine_windowed(z((512, 1), dtype=i32),
                                    z(512, dtype=i32), z(1, dtype=i32),
                                    n_windows=1, combiner="sum")
    with pytest.raises(ValueError, match="B \\* Be"):
        ts.segment_combine_windowed(z((500, 1)), z(512, dtype=i32),
                                    z(1, dtype=i32), n_windows=1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ts.segment_combine_windowed(
            z((512, 1), device="meta"), z(512, dtype=i32, device="meta"),
            z(1, dtype=i32, device="meta"), n_windows=1, combiner="min")
    # CPU tensors run the plain version: the kernel counters never move
    out = tb.bsp_spmv(z((1, TM, TN)), z(1, dtype=i32), z(1, dtype=i32),
                      z((1, TN, 1)), n_dst_tiles=1)
    assert out.shape == (1, TM, 1)
    assert (tb.bsp_spmv.launches,
            ts.segment_combine_windowed.launches) == before
