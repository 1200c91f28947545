"""Semiring and combiner identities shared by the kernels and the engine.

Semirings: the SVHM local relaxation sweep is a semiring SpMV over the
partition's adjacency:
  - ``plus_times`` : out[d] = sum_s A[d,s] * v[s]      (PageRank push)
  - ``min_plus``   : out[d] = min_s A[d,s] + v[s]      (SSSP relax; CC with 0
                     weights — min-label propagation)
Absent entries are the semiring's absorbing pad: 0 for plus_times, +inf (or
the integer maximum) for min_plus.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["combine_identity", "semiring_identity", "tile_pad_identity",
           "torch_dtype", "numpy_dtype"]

# the payload dtypes the kernels and the engine support
_TORCH_OF = {np.dtype(np.float32): torch.float32,
             np.dtype(np.int32): torch.int32}
_NUMPY_OF = {t: n for n, t in _TORCH_OF.items()}


def torch_dtype(dtype) -> torch.dtype:
    """float32 / int32 given as a numpy or torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_OF[np.dtype(dtype)]


def numpy_dtype(dtype) -> np.dtype:
    """float32 / int32 given as a numpy or torch dtype -> the numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _NUMPY_OF[dtype]
    return np.dtype(dtype)


def combine_identity(combiner: str, dtype):
    """Identity element of a reduce combiner in ``dtype`` (the pad value of
    the kernels' empty slots): +inf / iinfo.max for ``min``, mirrored for
    ``max``, 0 for ``sum``."""
    dt = np.dtype(dtype)
    if combiner == "sum":
        return dt.type(0)
    if np.issubdtype(dt, np.floating):
        return dt.type(np.inf if combiner == "min" else -np.inf)
    info = np.iinfo(dt)
    return dt.type(info.max if combiner == "min" else info.min)


def semiring_identity(semiring: str, dtype=np.float32):
    """Additive identity of the semiring — what absent matrix entries hold:
    0 for ``plus_times``, +inf (or the integer max) for ``min_plus``."""
    return combine_identity("sum" if semiring == "plus_times" else "min",
                            dtype)


def tile_pad_identity(semiring: str, dtype):
    """Absorbing pad for dense tile contents and the value blocks fed to
    ``bsp_spmv``. The tile kernel ADDS pads to values under ``min_plus``, so
    integer dtypes use the halved max: ``ident + ident`` must not wrap, or a
    padding lane could win the min. Values entering the tile kernel are
    clamped to this bound for the same reason (sound below 2**30 for
    int32)."""
    dt = np.dtype(dtype)
    if semiring == "plus_times" or np.issubdtype(dt, np.floating):
        return semiring_identity(semiring, dt)
    return dt.type(np.iinfo(dt).max >> 1)
