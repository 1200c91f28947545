"""Incremental graph mutation: route edge deltas with the frozen pure
hashes and patch the affected partitions in place.

An ``EdgeDelta`` (insert + delete batches) is routed through the *same*
``StreamContext`` the graph was ingested with, so every mutation lands in
exactly the partition a full re-ingest would choose — no global re-shuffle,
no re-routing of resident edges. Only partitions that actually receive a
mutation are rebuilt (O(partition) each); a partition whose new edge count
overflows ``e_max`` triggers a grow-and-re-pad of the dense arrays (the
padded capacity is shared across partitions by construction). Vertex-level
metadata (frontier slots, master election, full degrees) is recomputed from
the patched membership — O(P * v_max), cheap next to any edge pass — using
the same hash election as the builders.

Membership is grow-only between compactions: a vertex whose last local edge
was deleted stays a (edge-less) member of its partition. That is harmless —
it contributes nothing to sweeps and only its own initial value to SBS — and
keeps deletion O(partition). ``n_vertices`` grows automatically when a delta
references ids beyond the current space. After delete-heavy traffic the
zombie members (and the grown ``e_max``/``v_max`` padding) inflate every
device buffer; ``compact`` evicts edge-less members, re-homes fully isolated
vertices by the same hash round-robin as ingest, and shrinks the padded
capacities back down — returning a remap so live per-partition state
survives.

Warm-start pairing: after ``apply_delta``, monotone programs (SSSP/MSSP/CC)
can restart from the previous converged result via ``run_sim(...,
init_state=prev)`` — sound for *insert-only* deltas, where old values remain
valid upper bounds. ``apply_delta`` reports ``warm_start_safe`` accordingly;
deletions require a cold start (the engine also refuses warm starts for
non-monotone programs on its own).

Invariants this module owns (callers and docs rely on them):

  - **delete-before-add batch semantics** — within one ``EdgeDelta``,
    deletions hit the *pre-delta* graph, then adds are appended; a pair in
    both lists nets to an insert, never a cancel (producer-order
    cancellation is ``DeltaBuffer``'s job, resolved before flush).
  - **capacity is grow-only here** — ``v_max``/``e_max`` only ever grow
    under ``apply_delta`` (per the ``ShapePolicy``, exact round-up by
    default, geometric buckets on a serving session); shrinking is
    exclusively ``compact``'s job, which rounds *down to the bucket floor*.
  - **every patch reports a row remap** — ``DeltaStats.remap`` maps old
    local rows to new ones (membership is grow-only, so no row is ever
    evicted by a delta; an empty delta's remap is the identity), letting
    sessions carry ``[P, v_max, K]`` device-layout state (cached warm
    results) across a patch exactly like ``CompactStats.remap_state`` does
    across a compaction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.graph import unique_sorted
from repro_torch.core.partition import route_vertices_rh
from repro_torch.core.subgraph import (PartitionedGraph, ShapePolicy,
                                       localize_edges, recompute_frontier,
                                       repack_partitions,
                                       resolve_shape_policy)
from repro_torch.stream.ingest import StreamContext

__all__ = ["EdgeDelta", "DeltaStats", "apply_delta",
           "CompactStats", "compact"]


def _remap_rows(remap: np.ndarray, v_max_after: int, state: np.ndarray,
                fill) -> np.ndarray:
    """Carry a live ``[P, v_max_before(, K)]`` per-partition array across a
    re-layout described by ``remap``: surviving rows move to their new local
    index, evicted/padded rows get ``fill``."""
    state = np.asarray(state)
    P, old_v = remap.shape
    if state.shape[:2] != (P, old_v):
        raise ValueError(f"state {state.shape} does not match the remap "
                         f"{remap.shape}")
    out = np.full((P, v_max_after) + state.shape[2:], fill,
                  dtype=state.dtype)
    ip, iold = np.nonzero(remap >= 0)
    out[ip, remap[ip, iold]] = state[ip, iold]
    return out


@dataclasses.dataclass
class EdgeDelta:
    """A batch of edge mutations in global vertex ids."""

    add_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    add_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    add_w: Optional[np.ndarray] = None       # None -> unit weights
    del_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    del_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))

    def __post_init__(self):
        self.add_src = np.asarray(self.add_src, np.int64)
        self.add_dst = np.asarray(self.add_dst, np.int64)
        self.del_src = np.asarray(self.del_src, np.int64)
        self.del_dst = np.asarray(self.del_dst, np.int64)
        if self.add_w is not None:
            self.add_w = np.asarray(self.add_w, np.float32)
            if self.add_w.shape != self.add_src.shape:
                raise ValueError(f"add_w {self.add_w.shape} does not match "
                                 f"add_src {self.add_src.shape}")
        if self.add_src.shape != self.add_dst.shape \
                or self.del_src.shape != self.del_dst.shape:
            raise ValueError("src and dst of an EdgeDelta batch must have "
                             "the same shape")

    @property
    def n_adds(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def n_dels(self) -> int:
        return int(self.del_src.shape[0])

    @property
    def max_id(self) -> int:
        parts = [a.max() for a in (self.add_src, self.add_dst,
                                   self.del_src, self.del_dst) if a.size]
        return int(max(parts)) if parts else -1


@dataclasses.dataclass
class DeltaStats:
    n_added: int = 0
    n_deleted: int = 0               # edges actually found and removed
    parts_patched: int = 0
    repadded: bool = False           # e_max/v_max grew (dense arrays re-pad)
    n_slots_before: int = 0
    n_slots_after: int = 0
    warm_start_safe: bool = False    # True for insert-only deltas
    v_max_before: int = 0
    v_max_after: int = 0
    # [P, v_max_before] int32: old local row -> new local row. Membership is
    # grow-only under a delta, so every pre-patch member survives; -1 marks
    # only padding rows. None for an empty delta (nothing was applied, so
    # the layout is unchanged).
    remap: Optional[np.ndarray] = None

    def remap_state(self, state: np.ndarray, fill) -> np.ndarray:
        """Carry a live ``[P, v_max_before(, K)]`` per-partition array (e.g.
        a cached warm-result block) across this patch's row re-layout —
        the delta counterpart of ``CompactStats.remap_state``. An empty
        delta never moved a row, so its remap is the identity."""
        if self.remap is None:
            return np.asarray(state)
        return _remap_rows(self.remap, self.v_max_after, state, fill)


def _grow_cols(arr: np.ndarray, n: int, fill) -> np.ndarray:
    if arr.shape[1] >= n:
        return arr
    out = np.full((arr.shape[0], n) + arr.shape[2:], fill, dtype=arr.dtype)
    out[:, :arr.shape[1]] = arr
    return out


def _edge_key(src: np.ndarray, dst: np.ndarray, n_vertices: int) -> np.ndarray:
    # Collision-free for n_vertices < 2^31.5; the dense in-memory builder has
    # the same id-space envelope (local indices are int32).
    return src.astype(np.int64) * np.int64(n_vertices) + dst.astype(np.int64)


def apply_delta(pg: PartitionedGraph, ctx: StreamContext, delta: EdgeDelta,
                *, pad_multiple: int = 8,
                shape_policy: Optional[ShapePolicy] = None) -> DeltaStats:
    """Apply ``delta`` to ``pg`` in place, routing through ``ctx``.

    Deletions remove *every* resident copy of a (src, dst) pair in the
    partition the pair routes to; pairs that are not resident are ignored.

    Batch semantics: **deletes apply to the pre-delta graph, then adds are
    appended** — a pair appearing in both lists of one ``EdgeDelta`` has its
    pre-existing resident copies removed and exactly the new copies
    inserted (i.e. it nets to an insert, never to a cancel). Producer-order
    coalescing — "I added this pair a moment ago, now forget it" — is the
    ``DeltaBuffer``'s job (stream/buffer.py), which resolves op order
    *before* anything reaches this function.
    """
    policy = resolve_shape_policy(shape_policy, pad_multiple)
    stats = DeltaStats(n_slots_before=pg.n_slots,
                       warm_start_safe=delta.n_dels == 0,
                       v_max_before=pg.v_max, v_max_after=pg.v_max)
    if delta.n_adds == 0 and delta.n_dels == 0:
        stats.n_slots_after = pg.n_slots
        return stats
    old_v_max = pg.v_max
    old_nv = pg.vmask.sum(axis=1)    # rows are packed at the front

    # ---- id-space growth ------------------------------------------------ #
    new_v = max(pg.n_vertices, delta.max_id + 1)
    ctx.grow(new_v)
    pg.n_vertices = new_v

    # ---- route mutations through the frozen routing context -------------- #
    # Adds first: a stateful router (EBV) commits placements as it routes,
    # and its pair table is what lets the deletes of a DEL_ADD pair find the
    # resident copies (placement is pair-sticky). For the pure hashes
    # route_adds == route_deletes.
    add_part = ctx.route_adds(delta.add_src, delta.add_dst)
    del_part = ctx.route_deletes(delta.del_src, delta.del_dst)
    add_w = (np.ones(delta.n_adds, np.float32) if delta.add_w is None
             else delta.add_w)
    affected = np.unique(np.concatenate([add_part, del_part]))

    # Current full degrees, reconstructed from replica rows while they are
    # still aligned with gvid (all replicas agree on the value); the delta's
    # shifts are folded in below — O(V + delta), no global edge re-scan.
    g_out = np.zeros(new_v, np.float64)
    g_in = np.zeros(new_v, np.float64)
    sel = pg.vmask
    g_out[pg.gvid[sel]] = pg.out_deg[sel]
    g_in[pg.gvid[sel]] = pg.in_deg[sel]
    g_out += np.bincount(delta.add_src, minlength=new_v)
    g_in += np.bincount(delta.add_dst, minlength=new_v)

    # ---- rebuild each affected partition's local arrays ------------------ #
    # Rebuilt content is staged, then written after any capacity growth.
    staged = {}
    need_e = int(pg.e_max)
    need_v = int(pg.v_max)
    for p in affected.tolist():
        m = pg.emask[p]
        gs = pg.gvid[p][pg.esrc[p][m]]
        gd = pg.gvid[p][pg.edst[p][m]]
        w = pg.ew[p][m]

        dsel = del_part == p
        if dsel.any():
            dkey = _edge_key(delta.del_src[dsel], delta.del_dst[dsel], new_v)
            keep = ~np.isin(_edge_key(gs, gd, new_v), dkey)
            stats.n_deleted += int(gs.shape[0] - keep.sum())
            if not keep.all():   # only matched copies shift degrees
                g_out -= np.bincount(gs[~keep], minlength=new_v)
                g_in -= np.bincount(gd[~keep], minlength=new_v)
            gs, gd, w = gs[keep], gd[keep], w[keep]

        asel = add_part == p
        if asel.any():
            gs = np.concatenate([gs, delta.add_src[asel]])
            gd = np.concatenate([gd, delta.add_dst[asel]])
            w = np.concatenate([w, add_w[asel]])
            stats.n_added += int(asel.sum())

        # grow-only membership: old members stay, new endpoints join
        old_lv = pg.gvid[p][pg.vmask[p]]
        lv = unique_sorted(np.concatenate([old_lv, gs, gd]))
        staged[p] = (lv, gs, gd, w, old_lv)
        need_e = max(need_e, gs.shape[0])
        need_v = max(need_v, lv.shape[0])

    # ---- capacity growth (shared padded dims, policy-bucketed) ----------- #
    new_e_max = max(pg.e_max, policy.bucket(need_e)) \
        if need_e > pg.e_max else pg.e_max
    new_v_max = max(pg.v_max, policy.bucket(need_v)) \
        if need_v > pg.v_max else pg.v_max
    if new_e_max > pg.e_max or new_v_max > pg.v_max:
        stats.repadded = True
        pg.esrc = _grow_cols(pg.esrc, new_e_max, 0)
        pg.edst = _grow_cols(pg.edst, new_e_max, 0)
        pg.ew = _grow_cols(pg.ew, new_e_max, 0.0)
        pg.emask = _grow_cols(pg.emask, new_e_max, False)
        pg.gvid = _grow_cols(pg.gvid, new_v_max, -1)
        pg.vmask = _grow_cols(pg.vmask, new_v_max, False)
        pg.out_deg = _grow_cols(pg.out_deg, new_v_max, 0.0)
        pg.in_deg = _grow_cols(pg.in_deg, new_v_max, 0.0)
        # slot/is_frontier/is_master are rebuilt below at the new width
        pg.e_max, pg.v_max = new_e_max, new_v_max
        if pg.vlabel is not None:
            pg.vlabel = _grow_cols(pg.vlabel, new_v_max, 0)

    for p, (lv, gs, gd, w, _) in staged.items():
        nv, ne = lv.shape[0], gs.shape[0]
        pg.gvid[p] = -1
        pg.gvid[p, :nv] = lv
        pg.vmask[p] = False
        pg.vmask[p, :nv] = True
        ls, ld, ww = localize_edges(lv, gs, gd, w)
        pg.esrc[p] = 0
        pg.edst[p] = 0
        pg.ew[p] = 0.0
        pg.emask[p] = False
        pg.esrc[p, :ne] = ls
        pg.edst[p, :ne] = ld
        pg.ew[p, :ne] = ww
        pg.emask[p, :ne] = True
    stats.parts_patched = len(staged)
    pg.n_edges += stats.n_added - stats.n_deleted
    pg.edge_part = None   # host-side assignment is stale after a patch

    # ---- old-row -> new-row remap (carries device-layout state) ----------- #
    # Patched partitions: old members keep their values at a new sorted
    # position; untouched partitions: rows do not move (column growth only
    # appends padding).
    remap = np.full((pg.n_parts, old_v_max), -1, np.int32)
    for p in range(pg.n_parts):
        st = staged.get(p)
        if st is None:
            n = int(old_nv[p])
            remap[p, :n] = np.arange(n, dtype=np.int32)
        else:
            lv, old_lv = st[0], st[4]
            remap[p, :old_lv.shape[0]] = np.searchsorted(
                lv, old_lv).astype(np.int32)
    stats.remap = remap
    stats.v_max_after = pg.v_max

    # ---- write refreshed full degrees to every replica -------------------- #
    # (rows of patched partitions were re-ordered and new members appeared,
    # so every replica row re-reads the updated global table; ctx's
    # routing_degrees stays frozen — that is the delta-routing contract)
    sel = pg.vmask
    pg.out_deg[sel] = g_out[pg.gvid[sel]].astype(np.float32)
    pg.in_deg[sel] = g_in[pg.gvid[sel]].astype(np.float32)

    # ---- frontier-slot + master maintenance ------------------------------ #
    recompute_frontier(pg)
    stats.n_slots_after = pg.n_slots

    # ---- kernel edge layouts: incremental refresh ----------------------- #
    # Only the partitions this delta patched get their tile/window geometry
    # (and their rows of every cached tile realization) rebuilt; both paths
    # drop the layout's device lists, so the next kernel query uploads the
    # patched geometry. v_max growth moves the tile/window grid itself —
    # then the whole layout is rebuilt as a new object (it coincides with a
    # shape-key change, which already builds new runners).
    if pg.edge_layouts is not None:
        lay = pg.edge_layouts
        if lay.sync_capacity(pg):
            lay.rebuild_partitions(pg, staged.keys())
        else:
            pg.edge_layouts = None
            pg.ensure_edge_layouts(shape_policy=lay.policy,
                                   block_edges=lay.block_edges)
    return stats


# --------------------------------------------------------------------------- #
# Membership compaction after delete-heavy traffic
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class CompactStats:
    """What ``compact`` did, plus the state-carrying remap."""

    n_evicted: int = 0               # replica rows removed
    v_max_before: int = 0
    v_max_after: int = 0
    e_max_before: int = 0
    e_max_after: int = 0
    n_slots_before: int = 0
    n_slots_after: int = 0
    remap: Optional[np.ndarray] = None   # [P, v_max_before] int32, -1 evicted

    @property
    def shrunk(self) -> bool:
        return (self.v_max_after < self.v_max_before
                or self.e_max_after < self.e_max_before)

    def remap_state(self, state: np.ndarray, fill) -> np.ndarray:
        """Carry a live ``[P, v_max_before(, K)]`` per-partition array across
        the compaction: surviving rows move to their new local index, evicted
        and padded rows get ``fill`` (use the program's combiner identity for
        warm-state blocks)."""
        return _remap_rows(self.remap, self.v_max_after, state, fill)


def compact(pg: PartitionedGraph, ctx: StreamContext,
            *, pad_multiple: int = 8,
            shape_policy: Optional[ShapePolicy] = None) -> CompactStats:
    """Evict edge-less members and shrink the padded capacities in place.

    Membership after compaction is exactly what a from-scratch re-ingest of
    the resident edges would produce: each partition keeps the endpoints of
    its resident edges, and vertices with no resident edge *anywhere* are
    re-homed by the same hash round-robin ingest uses for isolated vertices
    (so every global id stays collectable from a master replica). Resident
    edges never move — placement is frozen in ``ctx`` — so slots and masters
    are re-elected (``n_slots`` shrinks with the evicted frontier rows) but
    the graph itself is unchanged: a previous converged result remains a
    valid warm start after ``compact``.

    Returns ``CompactStats``; ``stats.remap_state`` carries live
    ``[P, v_max, K]`` device-layout state into the compacted layout. Global
    ``[n_vertices]`` results (``pg.collect``) are untouched by compaction.

    Under a bucketed ``shape_policy`` the capacities shrink to the **bucket
    floor** (the smallest bucket that still fits the compacted content), not
    the exact minimum — so a session that compacts and then regrows inside
    the same bucket keeps its padded shapes, and with them every compiled
    runner.
    """
    if ctx.n_parts != pg.n_parts:
        raise ValueError(f"the routing context has {ctx.n_parts} "
                         f"partitions, the graph {pg.n_parts}")
    P = pg.n_parts
    stats = CompactStats(v_max_before=pg.v_max, e_max_before=pg.e_max,
                         n_slots_before=pg.n_slots)
    members_before = int(pg.vmask.sum())

    part_edges = []
    members = []
    touched = np.zeros(pg.n_vertices, bool)
    for p in range(P):
        m = pg.emask[p]
        gs = pg.gvid[p][pg.esrc[p][m]]
        gd = pg.gvid[p][pg.edst[p][m]]
        part_edges.append((gs, gd, pg.ew[p][m]))
        lv = unique_sorted(np.concatenate([gs, gd]))
        members.append(lv)
        touched[lv] = True

    iso = np.nonzero(~touched)[0].astype(np.int64)
    if iso.size:
        iso_part = route_vertices_rh(iso, P)
        for p in range(P):
            mine = iso[iso_part == p]
            if mine.size:
                members[p] = unique_sorted(
                    np.concatenate([members[p], mine]))

    stats.remap = repack_partitions(pg, members, part_edges,
                                    pad_multiple=pad_multiple,
                                    shape_policy=shape_policy)
    stats.n_evicted = members_before - int(pg.vmask.sum())
    stats.v_max_after = pg.v_max
    stats.e_max_after = pg.e_max
    stats.n_slots_after = pg.n_slots
    return stats
