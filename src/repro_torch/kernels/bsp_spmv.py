"""Block-sparse semiring SpMV — the SVHM local-sweep hot loop.

Replaces the JAX package's Pallas TPU kernel ``bsp_spmv``
(src/repro/kernels/bsp_spmv.py, body ``_kernel``) with a hand-written CUDA
kernel for Hopper (``csrc/bsp_spmv.cu``). A partition's adjacency is a list
of dense (TM x TN) = (128 x 128) tiles sorted by (tile_dst, tile_src), every
dst tile row covered at least once, and

    out[d] = (+)_{t: dst(t) = d}  tiles[t] (x) vals[src(t)]

  - ``plus_times``: tile @ vals block, summed (float32 only);
  - ``min_plus``  : min over src columns of tile + vals (float32 or int32;
    int32 tiles pad with ``iinfo.max >> 1`` and values are clamped to it).

Bound on the H100: memory — the kernel reads each tile once,
``T * 128 * 128 * 4`` bytes, and does a few operations per byte. The CUDA
source explains the design: a chunk plan (``kernels/chunks.py``) gives each
CTA at most ``TILE_CHUNK`` tiles of one dst row, quarter tiles stream
through a ring of shared-memory stages on bulk async copies, one warp reads
each tile row as 16-byte vectors and reduces it with a fixed shuffle tree,
and a second pass folds a split row's partials in chunk order — fp32 in a
fixed order, no atomics.

``bsp_spmv`` dispatches by the device of its tensors and nothing else: a
CUDA tensor launches the kernel (or the call raises), a CPU tensor runs
``bsp_spmv_plain``, the plain PyTorch version of the same function.
``bsp_spmv.launches`` counts kernel launches. A caller that multiplies by the
same tile list many times passes its cached ``plan_tiles(tile_dst,
n_dst_tiles)``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunks import ChunkPlan, build_chunk_plan
from repro_torch.kernels.ref import combine_identity, numpy_dtype

__all__ = ["TM", "TN", "TILE_CHUNK", "bsp_spmv", "bsp_spmv_plain",
           "plan_tiles", "SEMIRINGS"]

TM = 128   # dst rows per tile
TN = 128   # src cols per tile
TILE_CHUNK = 4     # tiles per CTA at most (256 KB of float32)
SEMIRINGS = ("plus_times", "min_plus")
_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
_PLAIN_CHUNK = 64        # tiles per step of the plain min_plus product


def _check(tiles, tile_dst, tile_src, vals, n_dst_tiles, semiring):
    if semiring not in SEMIRINGS:
        raise ValueError(f"semiring={semiring!r}: allowed values are "
                         f"{SEMIRINGS}")
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (TM, TN):
        raise ValueError(f"tiles must be [T, {TM}, {TN}], got "
                         f"{tuple(tiles.shape)}")
    if vals.dim() != 3 or vals.shape[1] != TN:
        raise ValueError(f"vals must be [n_src_tiles, {TN}, K], got "
                         f"{tuple(vals.shape)}")
    T = tiles.shape[0]
    for name, ids in (("tile_dst", tile_dst), ("tile_src", tile_src)):
        if ids.dtype != torch.int32 or tuple(ids.shape) != (T,):
            raise ValueError(f"{name} must be int32 [{T}], got "
                             f"{ids.dtype} {tuple(ids.shape)}")
    if tiles.dtype != vals.dtype:
        raise ValueError(f"tiles and vals must share a dtype, got "
                         f"{tiles.dtype} and {vals.dtype}")
    if vals.dtype not in _DTYPE_CODES:
        raise ValueError(f"bsp_spmv takes float32 or int32, got {vals.dtype}")
    if semiring == "plus_times" and not vals.dtype.is_floating_point:
        raise ValueError(
            f"plus_times needs a float dtype, got {vals.dtype}; min_plus is "
            "the integer-friendly semiring")
    devs = {t.device for t in (tiles, tile_dst, tile_src, vals)}
    if len(devs) != 1:
        raise ValueError(f"bsp_spmv inputs lie on several devices: {devs}")
    if n_dst_tiles < 1:
        raise ValueError(f"n_dst_tiles must be >= 1, got {n_dst_tiles}")


def bsp_spmv_plain(tiles, tile_dst, tile_src, vals, *, n_dst_tiles: int,
                   semiring: str = "plus_times") -> torch.Tensor:
    """Plain PyTorch version: the same function in ordinary tensor ops,
    dtype-correct for int32 (the output starts at the combiner identity of
    the value dtype; every dst row is covered, so the first tile's partial
    replaces it)."""
    _check(tiles, tile_dst, tile_src, vals, n_dst_tiles, semiring)
    K = vals.shape[-1]
    dst = tile_dst.long()
    src = tile_src.long()
    if semiring == "plus_times":
        out = torch.zeros((n_dst_tiles, TM, K), dtype=vals.dtype,
                          device=vals.device)
        return out.index_add_(0, dst, torch.bmm(tiles, vals[src]))
    ident = combine_identity("min", numpy_dtype(vals.dtype))
    out = torch.full((n_dst_tiles, TM, K), ident.item(), dtype=vals.dtype,
                     device=vals.device)
    for t0 in range(0, tiles.shape[0], _PLAIN_CHUNK):
        sl = slice(t0, t0 + _PLAIN_CHUNK)
        cand = tiles[sl][:, :, :, None] + vals[src[sl]][:, None, :, :]
        out.index_reduce_(0, dst[sl], cand.amin(dim=2), "amin")
    return out


def plan_tiles(tile_dst: torch.Tensor, n_dst_tiles: int) -> ChunkPlan:
    """The kernel's chunk plan of a dst-sorted tile list: at most
    ``TILE_CHUNK`` tiles of one dst row per CTA."""
    return build_chunk_plan(tile_dst, n_dst_tiles, TILE_CHUNK)


def _lib():
    lib = _build.load("bsp_spmv")
    fn = lib.drone_bsp_spmv
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bsp_spmv_cuda(tiles, tile_dst, tile_src, vals, n_dst_tiles, semiring,
                   plan):
    for name, t in (("tiles", tiles), ("tile_src", tile_src),
                    ("vals", vals)):
        if not t.is_contiguous():
            raise ValueError(f"bsp_spmv: {name} must be contiguous")
    if tiles.data_ptr() % 16:
        raise ValueError("bsp_spmv: tiles must be 16-byte aligned for the "
                         "kernel's bulk copies")
    if plan is None:
        plan = plan_tiles(tile_dst, n_dst_tiles)
    elif plan.chunk_ptr.device != tiles.device:
        raise ValueError(f"bsp_spmv: the plan lies on "
                         f"{plan.chunk_ptr.device}, the input on "
                         f"{tiles.device}")
    K = vals.shape[-1]
    out = torch.empty((n_dst_tiles, TM, K), dtype=vals.dtype,
                      device=vals.device)
    scratch = torch.empty((max(plan.n_slots, 1), TM, K), dtype=vals.dtype,
                          device=vals.device)
    fn = _lib()
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tiles.data_ptr(), tile_src.data_ptr(),
                 plan.chunk_ptr.data_ptr(), plan.chunk_row.data_ptr(),
                 plan.chunk_slot.data_ptr(), plan.n_chunks,
                 plan.split_row.data_ptr(), plan.split_ptr.data_ptr(),
                 plan.n_split, vals.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), K, _DTYPE_CODES[vals.dtype],
                 SEMIRINGS.index(semiring), stream)
    if err != 0:
        raise RuntimeError(f"bsp_spmv kernel launch failed with CUDA error "
                           f"{err}")
    bsp_spmv.launches += 1
    return out


def bsp_spmv(tiles, tile_dst, tile_src, vals, *, n_dst_tiles: int,
             semiring: str = "plus_times",
             plan: Optional[ChunkPlan] = None) -> torch.Tensor:
    """tiles [T,TM,TN], tile_dst/src [T] int32 (dst-major sorted),
    vals [n_src_tiles, TN, K]  ->  [n_dst_tiles, TM, K] (dtype of vals).
    ``plan`` is the kernel's chunk plan of ``tile_dst`` (``plan_tiles``),
    built here when None; the plain version needs none."""
    _check(tiles, tile_dst, tile_src, vals, n_dst_tiles, semiring)
    if plan is not None:
        plan.check(tiles.shape[0], n_dst_tiles, "tiles")
    if vals.device.type == "cuda":
        return _bsp_spmv_cuda(tiles, tile_dst, tile_src, vals, n_dst_tiles,
                              semiring, plan)
    if vals.device.type == "cpu":
        return bsp_spmv_plain(tiles, tile_dst, tile_src, vals,
                              n_dst_tiles=n_dst_tiles, semiring=semiring)
    raise ValueError(f"bsp_spmv runs on CUDA or CPU tensors, got "
                     f"{vals.device}")


bsp_spmv.launches = 0
