"""Windowed segment combine — the reduce-by-destination of the windowed
edge backend.

Replaces the JAX package's Pallas TPU kernel ``segment_combine_windowed``
(src/repro/kernels/segment_combine.py, body ``_kernel``) with a hand-written
CUDA kernel for Hopper (``csrc/segment_combine.cu``). Edge messages come in
blocks of Be edges, each block confined to one 128-row destination window
(``layouts._window_geometry``): blocks ascend by window, every window has at
least one block, padding edges carry the combiner identity, and

    out[w, r] = (+)_{blocks b of window w} (+)_{e in b: ldst[e] == r} msgs[e]

with (+) one of ``sum`` (float32), ``min`` and ``max`` (float32 or int32).

Bound on the H100: memory — ``B * Be * (K + 1) * 4`` bytes read once. The
CUDA source explains the design: a chunk plan (``kernels/chunks.py``) gives
each CTA at most ``BLOCK_CHUNK`` blocks of one window, the blocks stream
through a ring of shared-memory stages on bulk async copies, each warp
reduces runs of equal destination rows with a fixed-shape shuffle scan, and
a second pass folds a split window's partials in chunk order — so ``sum`` is
deterministic and ``min``/``max`` are exact.

``segment_combine_windowed`` dispatches by the device of its tensors and
nothing else: a CUDA tensor launches the kernel (or the call raises), a CPU
tensor runs ``segment_combine_plain``. ``segment_combine_windowed.launches``
counts kernel launches. A caller that reduces the same block list many times
passes its cached ``plan_windows(block_window, n_windows)``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunks import ChunkPlan, build_chunk_plan
from repro_torch.kernels.ref import combine_identity, numpy_dtype

__all__ = ["W", "BLOCK_CHUNK", "segment_combine_windowed",
           "segment_combine_plain", "plan_windows", "COMBINERS"]

W = 128       # output rows per window
BLOCK_CHUNK = 16    # blocks per CTA at most (8,192 edges at Be = 512)
MAX_K = 512         # payload lanes the kernel's shared-memory stages hold
COMBINERS = ("sum", "min", "max")
_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
_REDUCE = {"min": "amin", "max": "amax"}


def _check(msgs, local_dst, block_window, n_windows, combiner):
    if combiner not in COMBINERS:
        raise ValueError(f"combiner={combiner!r}: allowed values are "
                         f"{COMBINERS}")
    if msgs.dtype not in _DTYPE_CODES:
        raise ValueError(f"segment_combine takes float32 or int32, got "
                         f"{msgs.dtype}")
    if combiner == "sum" and not msgs.dtype.is_floating_point:
        raise ValueError(
            f"sum-combine needs a float dtype, got {msgs.dtype}; min/max "
            "are the integer-friendly combiners")
    if msgs.dim() != 2:
        raise ValueError(f"msgs must be [B*Be, K], got {tuple(msgs.shape)}")
    for name, ids in (("local_dst", local_dst),
                      ("block_window", block_window)):
        if ids.dtype != torch.int32 or ids.dim() != 1:
            raise ValueError(f"{name} must be a 1-d int32 tensor, got "
                             f"{ids.dtype} {tuple(ids.shape)}")
    B = block_window.shape[0]
    if B < 1 or msgs.shape[0] % B or local_dst.shape[0] != msgs.shape[0]:
        raise ValueError(
            f"msgs [{msgs.shape[0]}, K] and local_dst [{local_dst.shape[0]}]"
            f" must hold B * Be rows for B = {B} blocks")
    devs = {t.device for t in (msgs, local_dst, block_window)}
    if len(devs) != 1:
        raise ValueError(f"segment_combine inputs lie on several devices: "
                         f"{devs}")
    if n_windows < 1:
        raise ValueError(f"n_windows must be >= 1, got {n_windows}")


def segment_combine_plain(msgs, local_dst, block_window, *, n_windows: int,
                          combiner: str = "sum") -> torch.Tensor:
    """Plain PyTorch version: scatter every message into its row
    ``block_window[b] * W + local_dst[e]``, starting from the combiner
    identity of the message dtype."""
    _check(msgs, local_dst, block_window, n_windows, combiner)
    B = block_window.shape[0]
    Be = msgs.shape[0] // B
    K = msgs.shape[1]
    row = (block_window.long().repeat_interleave(Be) * W + local_dst.long())
    ident = combine_identity(combiner, numpy_dtype(msgs.dtype)).item()
    out = torch.full((n_windows * W, K), ident, dtype=msgs.dtype,
                     device=msgs.device)
    if combiner == "sum":
        out.index_add_(0, row, msgs)
    else:
        out.index_reduce_(0, row, msgs, _REDUCE[combiner])
    return out.reshape(n_windows, W, K)


def plan_windows(block_window: torch.Tensor, n_windows: int) -> ChunkPlan:
    """The kernel's chunk plan of an ascending block -> window list: at most
    ``BLOCK_CHUNK`` blocks of one window per CTA."""
    return build_chunk_plan(block_window, n_windows, BLOCK_CHUNK)


def _lib():
    lib = _build.load("segment_combine")
    fn = lib.drone_segment_combine
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _segment_combine_cuda(msgs, local_dst, block_window, n_windows,
                          combiner, plan):
    B = block_window.shape[0]
    Be = msgs.shape[0] // B
    K = msgs.shape[1]
    for name, t in (("msgs", msgs), ("local_dst", local_dst)):
        if not t.is_contiguous():
            raise ValueError(f"segment_combine: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"segment_combine: {name} must be 16-byte "
                             "aligned for the kernel's bulk copies")
    if Be % 4:
        raise ValueError(f"segment_combine: the kernel takes a block of a "
                         f"multiple of 4 edges, got Be = {Be}")
    if K > MAX_K:
        raise ValueError(f"segment_combine: the kernel takes K <= {MAX_K}, "
                         f"got {K}")
    if plan is None:
        plan = plan_windows(block_window, n_windows)
    elif plan.chunk_ptr.device != msgs.device:
        raise ValueError(f"segment_combine: the plan lies on "
                         f"{plan.chunk_ptr.device}, the input on "
                         f"{msgs.device}")
    out = torch.empty((n_windows, W, K), dtype=msgs.dtype,
                      device=msgs.device)
    scratch = torch.empty((max(plan.n_slots, 1), W, K), dtype=msgs.dtype,
                          device=msgs.device)
    fn = _lib()
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(msgs.data_ptr(), local_dst.data_ptr(),
                 plan.chunk_ptr.data_ptr(), plan.chunk_row.data_ptr(),
                 plan.chunk_slot.data_ptr(), plan.n_chunks,
                 plan.split_row.data_ptr(), plan.split_ptr.data_ptr(),
                 plan.n_split, out.data_ptr(), scratch.data_ptr(), Be, K,
                 _DTYPE_CODES[msgs.dtype], COMBINERS.index(combiner), stream)
    if err != 0:
        raise RuntimeError(f"segment_combine kernel launch failed with CUDA "
                           f"error {err}")
    segment_combine_windowed.launches += 1
    return out


def segment_combine_windowed(msgs, local_dst, block_window, *,
                             n_windows: int, combiner: str = "sum",
                             plan: Optional[ChunkPlan] = None
                             ) -> torch.Tensor:
    """msgs [B*Be, K] (identity-padded), local_dst [B*Be] int32 in [0, W),
    block_window [B] int32 ascending, covering every window
    ->  [n_windows, W, K] in msgs.dtype. ``plan`` is the kernel's chunk
    plan of ``block_window`` (``plan_windows``), built here when None; the
    plain version needs none."""
    _check(msgs, local_dst, block_window, n_windows, combiner)
    if plan is not None:
        plan.check(block_window.shape[0], n_windows, "blocks")
    if msgs.device.type == "cuda":
        return _segment_combine_cuda(msgs, local_dst, block_window,
                                     n_windows, combiner, plan)
    if msgs.device.type == "cpu":
        return segment_combine_plain(msgs, local_dst, block_window,
                                     n_windows=n_windows, combiner=combiner)
    raise ValueError(f"segment_combine runs on CUDA or CPU tensors, got "
                     f"{msgs.device}")


segment_combine_windowed.launches = 0
