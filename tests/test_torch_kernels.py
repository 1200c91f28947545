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
from repro_torch.kernels.chunks import build_chunk_plan
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
    plan = ts.plan_windows(z(2, dtype=i32), 1)
    with pytest.raises(ValueError, match="chunk plan covers 2 items"):
        ts.segment_combine_windowed(z((512, 1)), z(512, dtype=i32),
                                    z(1, dtype=i32), n_windows=1, plan=plan)
    with pytest.raises(ValueError, match="chunk plan covers 2 items"):
        tb.bsp_spmv(z((1, TM, TN)), z(1, dtype=i32), z(1, dtype=i32),
                    z((1, TN, 1)), n_dst_tiles=1, plan=plan)
    # CPU tensors run the plain version: the kernel counters never move
    out = tb.bsp_spmv(z((1, TM, TN)), z(1, dtype=i32), z(1, dtype=i32),
                      z((1, TN, 1)), n_dst_tiles=1)
    assert out.shape == (1, TM, 1)
    assert (tb.bsp_spmv.launches,
            ts.segment_combine_windowed.launches) == before


@pytest.mark.parametrize("counts,cap", [
    ([1, 1, 1, 1], 4),                  # one chunk per row, no second pass
    ([3, 0, 9, 1, 0], 4),               # empty rows and a split row
    ([2900] + [1] * 30 + [5, 0, 7], 16),  # the padded layout's heavy row
    ([1000, 3, 1] * 3, 1),              # one item per chunk
    ([37], 37),                         # exactly one full chunk
], ids=["flat", "empty-rows", "skewed", "cap1", "full"])
def test_chunk_plan_covers_in_order(counts, cap):
    rows = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    plan = build_chunk_plan(torch.from_numpy(rows), len(counts), cap)
    ptr = plan.chunk_ptr.numpy()
    crow = plan.chunk_row.numpy()
    slot = plan.chunk_slot.numpy()
    assert ptr[0] == 0 and ptr[-1] == rows.shape[0] == plan.n_items
    size = np.diff(ptr)
    # every item in exactly one chunk, in order, never more than the cap
    assert (size >= 1).all() and (size <= cap).all()
    np.testing.assert_array_equal(np.repeat(crow, size), rows)
    assert (np.diff(crow) >= 0).all()
    # rows with one chunk write directly; the others get consecutive slots
    # in chunk order, which the second pass folds in that order
    n_chunks = np.bincount(crow, minlength=len(counts))
    np.testing.assert_array_equal(slot == -1, n_chunks[crow] == 1)
    split = np.nonzero(n_chunks != 1)[0]
    np.testing.assert_array_equal(plan.split_row.numpy(), split)
    sptr = plan.split_ptr.numpy()
    np.testing.assert_array_equal(np.diff(sptr), n_chunks[split])
    for s, r in enumerate(split):
        np.testing.assert_array_equal(slot[crow == r],
                                      np.arange(sptr[s], sptr[s + 1]))
    assert plan.n_slots == sptr[-1] == int((slot >= 0).sum())


def test_chunk_plan_rejects_unsorted_rows():
    with pytest.raises(ValueError, match="ascend"):
        build_chunk_plan(torch.tensor([0, 2, 1], dtype=torch.int32), 3, 4)
    with pytest.raises(ValueError, match="ascend"):
        build_chunk_plan(torch.tensor([0, 3], dtype=torch.int32), 3, 4)


@pytest.mark.parametrize("kernel", ["tiles", "windowed"])
def test_wrappers_take_a_plan(kernel):
    """A cached plan and none give the same result (the CPU path ignores
    the plan once it has checked that it fits)."""
    rng = np.random.default_rng(5)
    if kernel == "tiles":
        tiles, td, tsrc = _rand_tiles(rng, 12, 3, 2, "min_plus", np.float32)
        vals = rng.uniform(0, 3, size=(2, TN, 2)).astype(np.float32)
        args = [torch.from_numpy(a) for a in (tiles, td, tsrc, vals)]
        plan = tb.plan_tiles(args[1], 3)
        a = tb.bsp_spmv(*args, n_dst_tiles=3, semiring="min_plus")
        b = tb.bsp_spmv(*args, n_dst_tiles=3, semiring="min_plus", plan=plan)
    else:
        dst = np.sort(rng.integers(0, 300, size=900))
        lay = tops.WindowLayout(dst, 300, block_edges=128)
        buf = np.full((lay.n_blocks * 128, 1), np.inf, np.float32)
        buf[lay.edge_slot] = rng.uniform(0, 3, size=(900, 1))
        args = [torch.from_numpy(x)
                for x in (buf, lay.local_dst, lay.block_window)]
        plan = ts.plan_windows(args[2], lay.n_windows)
        a = ts.segment_combine_windowed(*args, n_windows=lay.n_windows,
                                        combiner="min")
        b = ts.segment_combine_windowed(*args, n_windows=lay.n_windows,
                                        combiner="min", plan=plan)
    assert torch.equal(a, b)


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """An edited ``csrc`` header changes the library name of every source
    that includes it, directly or through another header, and no other."""
    from repro_torch.kernels import _build
    (tmp_path / "a.cu").write_text('#include "inner.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text('#include <cstdint>\nint b;\n')
    (tmp_path / "inner.cuh").write_text('#include "leaf.cuh"\n')
    (tmp_path / "leaf.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert {p.name for p in _build._sources_of("a")} == \
        {"a.cu", "inner.cuh", "leaf.cuh"}
    before = (_build.library_path("a"), _build.library_path("b"))
    (tmp_path / "leaf.cuh").write_text("// v2\n")
    after = (_build.library_path("a"), _build.library_path("b"))
    assert after[0] != before[0] and after[1] == before[1]
    assert after[0].name.startswith("liba_")
    # the port's own sources hash the shared header
    monkeypatch.undo()
    for name in _build.SOURCES:
        assert "chunked.cuh" in {p.name for p in _build._sources_of(name)}
