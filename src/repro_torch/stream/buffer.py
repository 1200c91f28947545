"""Delta batching under continuous producer traffic.

``apply_delta`` is O(affected partitions) per call: a producer emitting one
edge at a time pays a partition rebuild *and* a full ``recompute_frontier``
per edge. The ``DeltaBuffer`` sits between the producer and ``apply_delta``,
coalescing the op stream per (src, dst) pair and flushing one merged
``EdgeDelta`` when a threshold trips — N tiny patches become one partition
rebuild with one frontier re-election.

Coalescing preserves *sequential* semantics — the flushed graph equals
applying the buffered ops one ``apply_delta`` at a time in arrival order —
with one documented coarsening: duplicate adds of a live pair merge into a
single resident copy (last weight wins) instead of accumulating parallel
copies. The per-pair state machine:

  op stream (oldest -> newest)       buffered state     flushed as
  ---------------------------------  -----------------  -------------------
  add(w)                             ADD(w)             insert
  add(w) ... add(w')                 ADD(w')            insert (merged)
  add(w) ... delete                  DEL                delete only [#]
  delete                             DEL                delete
  delete ... add(w)                  DEL_ADD(w)         delete, then insert
  delete ... add(w) ... delete       DEL                delete

[#] the buffered add cancels in-buffer; the delete still flushes because
``apply_delta`` deletions target every *resident* copy of the pair — there
may be pre-buffer copies on device — and deleting a non-resident pair is a
no-op. ``apply_delta`` applies a flushed batch deletes-first, which is
exactly the DEL_ADD ordering.

Invariants: the buffer never mutates the graph outside ``flush`` (reads
between flushes see the pre-buffer graph — callers who need the tail must
flush first, which ``GraphSession.query`` does automatically); flush order
over pairs is deterministic (sorted), so identical op streams produce
identical patches; the configured ``shape_policy`` is forwarded to every
``apply_delta``, so a session's bucket choices apply to auto-flushes too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.subgraph import (PartitionedGraph, ShapePolicy,
                                       resolve_shape_policy)
from repro_torch.stream.delta import DeltaStats, EdgeDelta, apply_delta
from repro_torch.stream.ingest import StreamContext

__all__ = ["BufferStats", "DeltaBuffer"]

_ADD, _DEL, _DEL_ADD = 0, 1, 2


@dataclasses.dataclass
class BufferStats:
    """Cumulative producer-side accounting across the buffer's lifetime."""

    ops_in: int = 0              # add/delete ops the producer enqueued
    adds_merged: int = 0         # duplicate adds collapsed in-buffer
    adds_cancelled: int = 0      # buffered adds consumed by a later delete
    dels_merged: int = 0         # duplicate deletes collapsed in-buffer
    n_flushes: int = 0
    auto_flushes: int = 0        # flushes tripped by a threshold
    edges_flushed: int = 0       # add+del entries handed to apply_delta

    @property
    def coalesced(self) -> int:
        return self.adds_merged + self.adds_cancelled + self.dels_merged


class DeltaBuffer:
    """Coalescing write buffer in front of ``apply_delta``.

    ``max_edges``: auto-flush when the number of distinct buffered pairs
    reaches this bound. ``max_parts``: auto-flush when the buffered pairs
    touch this many partitions (each touched partition is rebuilt at flush,
    so this caps per-flush patch latency). Pass ``None`` to disable either
    trigger; ``flush()`` can always be called manually (and must be, before
    reading results that should see the buffered tail).
    """

    def __init__(self, pg: PartitionedGraph, ctx: StreamContext, *,
                 max_edges: Optional[int] = 4096,
                 max_parts: Optional[int] = None,
                 pad_multiple: int = 8,
                 shape_policy: Optional[ShapePolicy] = None):
        self.pg = pg
        self.ctx = ctx
        self.max_edges = max_edges
        self.max_parts = max_parts
        # resolve once: an explicit policy carries its own tiling, the bare
        # pad_multiple is only consulted when no policy is given
        self.shape_policy = resolve_shape_policy(shape_policy, pad_multiple)
        self.pad_multiple = self.shape_policy.pad_multiple
        self.stats = BufferStats()
        self._ops: dict = {}          # (src, dst) -> (STATE, weight|None)
        self._parts: set = set()
        self.last_flush: Optional[DeltaStats] = None

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self._ops)

    @property
    def pending_edges(self) -> int:
        return len(self._ops)

    @property
    def pending_parts(self) -> int:
        return len(self._parts)

    # ------------------------------------------------------------------ #
    def add(self, src, dst, w=None) -> None:
        src = np.atleast_1d(np.asarray(src, np.int64))
        dst = np.atleast_1d(np.asarray(dst, np.int64))
        ww = (np.ones(src.shape, np.float32) if w is None
              else np.atleast_1d(np.asarray(w, np.float32)))
        if not src.shape == dst.shape == ww.shape:
            raise ValueError("add(): src, dst and w must have one shape")
        self._touch(src, dst)
        for s, d, x in zip(src.tolist(), dst.tolist(), ww.tolist()):
            self._push_add((s, d), np.float32(x))
        self._maybe_flush()

    def delete(self, src, dst) -> None:
        src = np.atleast_1d(np.asarray(src, np.int64))
        dst = np.atleast_1d(np.asarray(dst, np.int64))
        if src.shape != dst.shape:
            raise ValueError("delete(): src and dst must have one shape")
        self._touch(src, dst)
        for s, d in zip(src.tolist(), dst.tolist()):
            self._push_del((s, d))
        self._maybe_flush()

    def push(self, delta: EdgeDelta) -> None:
        """Enqueue a whole producer ``EdgeDelta`` (its deletes are older
        than its adds, matching ``apply_delta`` batch order)."""
        if delta.n_dels:
            self.delete(delta.del_src, delta.del_dst)
        if delta.n_adds:
            self.add(delta.add_src, delta.add_dst, delta.add_w)

    # ------------------------------------------------------------------ #
    def _push_add(self, key, w) -> None:
        self.stats.ops_in += 1
        cur = self._ops.get(key)
        if cur is None:
            self._ops[key] = (_ADD, w)
        elif cur[0] == _ADD:
            self.stats.adds_merged += 1
            self._ops[key] = (_ADD, w)
        elif cur[0] == _DEL:
            self._ops[key] = (_DEL_ADD, w)
        else:                                   # DEL_ADD: merge the add leg
            self.stats.adds_merged += 1
            self._ops[key] = (_DEL_ADD, w)

    def _push_del(self, key) -> None:
        self.stats.ops_in += 1
        cur = self._ops.get(key)
        if cur is None:
            self._ops[key] = (_DEL, None)
        elif cur[0] == _DEL:
            self.stats.dels_merged += 1
        else:                                   # ADD or DEL_ADD: cancel add
            self.stats.adds_cancelled += 1
            self._ops[key] = (_DEL, None)

    def _touch(self, src, dst) -> None:
        if self.max_parts is not None:
            # brand-new ids must grow the routing snapshot before they can
            # be routed (apply_delta does the same at flush; grow is
            # monotonic and zero-extending, so growing early is harmless)
            hi = int(max(src.max(), dst.max()))
            if hi >= self.ctx.n_vertices:
                self.ctx.grow(hi + 1)
            # route() is the non-mutating preview: a stateful router must
            # not commit placements for ops that are merely buffered
            self._parts.update(self.ctx.route(src, dst).tolist())

    def _maybe_flush(self) -> None:
        if ((self.max_edges is not None
             and len(self._ops) >= self.max_edges)
                or (self.max_parts is not None
                    and len(self._parts) >= self.max_parts)):
            self.flush(_auto=True)

    # ------------------------------------------------------------------ #
    def flush(self, _auto: bool = False) -> Optional[DeltaStats]:
        """Resolve the buffer into one ``EdgeDelta`` and apply it. Returns
        the patch's ``DeltaStats`` (also kept as ``self.last_flush``), or
        None if nothing was buffered."""
        if not self._ops:
            return None
        keys = sorted(self._ops)                # deterministic flush order
        asrc, adst, aw, dsrc, ddst = [], [], [], [], []
        for k in keys:
            state, w = self._ops[k]
            if state in (_DEL, _DEL_ADD):
                dsrc.append(k[0])
                ddst.append(k[1])
            if state in (_ADD, _DEL_ADD):
                asrc.append(k[0])
                adst.append(k[1])
                aw.append(w)
        delta = EdgeDelta(
            add_src=np.array(asrc, np.int64), add_dst=np.array(adst, np.int64),
            add_w=np.array(aw, np.float32) if aw else None,
            del_src=np.array(dsrc, np.int64), del_dst=np.array(ddst, np.int64))
        self._ops.clear()
        self._parts.clear()
        self.stats.n_flushes += 1
        self.stats.auto_flushes += int(_auto)
        self.stats.edges_flushed += delta.n_adds + delta.n_dels
        self.last_flush = apply_delta(self.pg, self.ctx, delta,
                                      shape_policy=self.shape_policy)
        return self.last_flush
