"""Single-partition layouts around the two kernels — the kernel-level rig.

``TileLayout``   COO edges -> dst-major dense 128x128 tile list (the
                 ``bsp_spmv`` input; identity filler tiles cover every dst
                 tile row).
``WindowLayout`` dst-sorted COO -> per-128-row-window edge blocks (the
                 ``segment_combine_windowed`` input; empty windows get one
                 identity block).
``spmv``         one-shot semiring SpMV on COO edges through either kernel.

Host layouts are numpy and bit-identical to the JAX package's
``repro.kernels.ops``; the engine-facing stacked layouts live in
``repro_torch.core.layouts``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.bsp_spmv import TM, TN, bsp_spmv
from repro_torch.kernels.ref import (combine_identity, numpy_dtype,
                                     tile_pad_identity, torch_dtype)
from repro_torch.kernels.segment_combine import W, segment_combine_windowed

__all__ = ["TileLayout", "WindowLayout", "spmv"]


class TileLayout:
    """Dense-tile decomposition of one partition's adjacency."""

    def __init__(self, src, dst, w, n_src_rows, n_dst_rows, semiring,
                 dtype=np.float32):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        self.dtype = np.dtype(dtype)
        w = np.asarray(w, self.dtype)
        ident = tile_pad_identity(semiring, self.dtype)
        self.semiring = semiring
        self.n_src_tiles = max(-(-int(n_src_rows) // TN), 1)
        self.n_dst_tiles = max(-(-int(n_dst_rows) // TM), 1)

        td, ts = dst // TM, src // TN
        key = td * self.n_src_tiles + ts
        uniq = np.unique(key)
        covered = np.zeros(self.n_dst_tiles, bool)
        covered[(uniq // self.n_src_tiles).astype(np.int64)] = True
        missing = np.nonzero(~covered)[0]
        T = uniq.shape[0] + missing.shape[0]

        tiles = np.full((T, TM, TN), ident, self.dtype)
        tile_dst = np.zeros(T, np.int32)
        tile_src = np.zeros(T, np.int32)
        tile_dst[:uniq.shape[0]] = (uniq // self.n_src_tiles).astype(np.int32)
        tile_src[:uniq.shape[0]] = (uniq % self.n_src_tiles).astype(np.int32)
        tile_dst[uniq.shape[0]:] = missing.astype(np.int32)

        tidx = np.searchsorted(uniq, key)               # tile index per edge
        r = (dst % TM).astype(np.int64)
        c = (src % TN).astype(np.int64)
        if semiring == "plus_times":
            np.add.at(tiles, (tidx, r, c), w)
        else:
            np.minimum.at(tiles, (tidx, r, c), w)

        final = np.lexsort((tile_src, tile_dst))       # dst-major, fillers in
        self.tiles = tiles[final]
        self.tile_dst = tile_dst[final]
        self.tile_src = tile_src[final]
        self.density = (self.tiles != ident).mean()

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        """vals [n_src_rows(+pad), K] -> [n_dst_tiles*TM, K] on the device of
        ``vals``."""
        dev = vals.device
        tdt = torch_dtype(self.dtype)
        K = vals.shape[-1]
        ident = tile_pad_identity(self.semiring, self.dtype).item()
        v = vals.to(tdt)
        if not tdt.is_floating_point:
            v = torch.clamp(v, max=ident)      # keep ident + val wrap-free
        pad = torch.full((self.n_src_tiles * TN - v.shape[0], K), ident,
                         dtype=tdt, device=dev)
        v = torch.cat([v, pad]).reshape(self.n_src_tiles, TN, K)
        out = bsp_spmv(torch.from_numpy(self.tiles).to(dev),
                       torch.from_numpy(self.tile_dst).to(dev),
                       torch.from_numpy(self.tile_src).to(dev), v,
                       n_dst_tiles=self.n_dst_tiles, semiring=self.semiring)
        return out.reshape(self.n_dst_tiles * TM, K)


class WindowLayout:
    """Edge blocks confined to 128-dst-row windows."""

    def __init__(self, dst, n_rows, block_edges: int = 512):
        dst = np.asarray(dst, np.int64)
        self.n_windows = max(-(-int(n_rows) // W), 1)
        self.block_edges = Be = int(block_edges)
        order = np.argsort(dst, kind="stable")
        self.order = order
        dsts = dst[order]
        win = dsts // W
        counts = np.bincount(win, minlength=self.n_windows)
        blocks = np.maximum(-(-counts // Be), 1)         # >=1 block per window
        self.n_blocks = int(blocks.sum())
        self.block_window = np.repeat(
            np.arange(self.n_windows, dtype=np.int32), blocks)
        woff = np.concatenate([[0], np.cumsum(blocks)])[:-1] * Be
        estart = np.concatenate([[0], np.cumsum(counts)])[:-1]
        self.edge_slot = woff[win] + (np.arange(dsts.shape[0]) - estart[win])
        self.local_dst = np.zeros(self.n_blocks * Be, np.int32)
        self.local_dst[self.edge_slot] = (dsts % W).astype(np.int32)
        self.pad_mask = np.ones(self.n_blocks * Be, bool)
        self.pad_mask[self.edge_slot] = False

    def __call__(self, msgs: torch.Tensor, *,
                 combiner: str = "sum") -> torch.Tensor:
        """msgs [E, K] (original edge order) -> [n_windows*W, K] on the
        device of ``msgs``."""
        dev = msgs.device
        K = msgs.shape[-1]
        ident = combine_identity(combiner, numpy_dtype(msgs.dtype)).item()
        buf = torch.full((self.n_blocks * self.block_edges, K), ident,
                         dtype=msgs.dtype, device=dev)
        buf[torch.from_numpy(self.edge_slot).to(dev)] = \
            msgs[torch.from_numpy(self.order).to(dev)]
        out = segment_combine_windowed(
            buf, torch.from_numpy(self.local_dst).to(dev),
            torch.from_numpy(self.block_window).to(dev),
            n_windows=self.n_windows, combiner=combiner)
        return out.reshape(self.n_windows * W, K)


def spmv(src, dst, w, vals, n_rows, *, semiring="plus_times",
         kernel="tiles", dtype=np.float32,
         device: DeviceLike = None) -> torch.Tensor:
    """One-shot semiring SpMV over COO edges (testing/benchmark entry);
    ``vals`` is array-like [n, K] or [n], the result lies on ``device``."""
    dev = resolve_device(device)
    tdt = torch_dtype(dtype)
    vals = torch.as_tensor(np.asarray(vals, dtype), device=dev)
    if vals.dim() == 1:
        vals = vals[:, None]
    if kernel == "tiles":
        layout = TileLayout(src, dst, w, vals.shape[0], n_rows, semiring,
                            dtype=dtype)
        return layout(vals)[:n_rows]
    sv = vals[torch.as_tensor(np.asarray(src, np.int64), device=dev)]
    wj = torch.as_tensor(np.asarray(w, dtype), dtype=tdt, device=dev)[:, None]
    msgs = sv * wj if semiring == "plus_times" else sv + wj
    layout = WindowLayout(dst, n_rows)
    comb = "sum" if semiring == "plus_times" else "min"
    return layout(msgs, combiner=comb)[:n_rows]
