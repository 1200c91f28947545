"""Chunk plans: how the two CUDA kernels split their work across CTAs.

Both kernels reduce a list of items (edge blocks or dense tiles) sorted by
output row (a 128-row window or dst tile row). One CTA per output row would
leave a row with thousands of items to a single CTA, and the bucketed
layouts of the JAX package put every padding block or tile on the last row
of each partition. A chunk plan cuts the sorted list into chunks of at most
``cap`` consecutive items of one row:

  - a row with exactly one chunk is written by that chunk's CTA directly;
  - every chunk of a row with several chunks writes a partial result into
    its own scratch slot, and a second, ordered pass combines the row's
    slots in chunk order (so float sums are the same bits on every launch);
  - a row with no items gets no chunk; the second pass writes the combiner
    identity there.

The plan depends only on the row ids, so the engine builds it once per
layout and caches it beside the layout's device tensors. Everything here is
plain PyTorch and runs on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["ChunkPlan", "build_chunk_plan"]


class ChunkPlan(NamedTuple):
    """Chunks of a row-sorted item list (int32 tensors on one device)."""
    chunk_ptr: torch.Tensor    # [n_chunks + 1] item boundaries of the chunks
    chunk_row: torch.Tensor    # [n_chunks] output row of each chunk
    chunk_slot: torch.Tensor   # [n_chunks] scratch slot, -1 = write the row
    split_row: torch.Tensor    # [n_split] rows the second pass writes
    split_ptr: torch.Tensor    # [n_split + 1] slot ranges of those rows
    n_items: int
    n_rows: int
    n_slots: int               # scratch slots the chunks of split rows use
    cap: int

    @property
    def n_chunks(self) -> int:
        return self.chunk_row.shape[0]

    @property
    def n_split(self) -> int:
        return self.split_row.shape[0]

    def check(self, n_items: int, n_rows: int, what: str) -> None:
        """Raise unless this plan covers ``n_items`` items of ``n_rows``
        rows (the caller's ``what``)."""
        if (self.n_items, self.n_rows) != (n_items, n_rows):
            raise ValueError(
                f"the chunk plan covers {self.n_items} items of "
                f"{self.n_rows} rows, the input {n_items} {what} of "
                f"{n_rows} rows")


def build_chunk_plan(rows: torch.Tensor, n_rows: int,
                     cap: int) -> ChunkPlan:
    """Chunk plan of the ascending row ids ``rows`` [N] (one per item) over
    ``n_rows`` output rows, at most ``cap`` items per chunk."""
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if rows.dim() != 1:
        raise ValueError(f"rows must be 1-d, got {tuple(rows.shape)}")
    dev = rows.device
    r = rows.long()
    if r.numel() and (bool((r[1:] < r[:-1]).any()) or int(r[0]) < 0
                      or int(r[-1]) >= n_rows):
        raise ValueError(f"row ids must ascend within [0, {n_rows})")
    counts = torch.bincount(r, minlength=n_rows)
    nch = (counts + cap - 1) // cap                    # chunks per row
    item0 = torch.cumsum(counts, 0) - counts           # first item per row
    chunk0 = torch.cumsum(nch, 0) - nch                # first chunk per row
    chunk_row = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                        nch)
    n_chunks = chunk_row.shape[0]
    j = torch.arange(n_chunks, device=dev) - chunk0[chunk_row]
    chunk_ptr = torch.cat([item0[chunk_row] + j * cap,
                           torch.tensor([r.shape[0]], device=dev)])
    split = nch != 1
    in_split = split[chunk_row]
    slot = torch.cumsum(in_split.long(), 0) - in_split.long()
    chunk_slot = torch.where(in_split, slot, torch.full_like(slot, -1))
    split_row = torch.nonzero(split).reshape(-1)
    per = nch[split_row]
    split_ptr = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                           torch.cumsum(per, 0)])

    def i32(t):
        return t.to(torch.int32).contiguous()

    return ChunkPlan(i32(chunk_ptr), i32(chunk_row), i32(chunk_slot),
                     i32(split_row), i32(split_ptr), int(r.shape[0]),
                     int(n_rows), int(in_split.sum()), int(cap))
