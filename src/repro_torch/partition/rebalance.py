"""Online rebalancing: migrate boundary edges off overloaded partitions.

Streaming churn skews partitions no matter how well ingest placed the
initial graph — a hot producer keeps appending to the same community, a
delete wave hollows out another partition. When the ``LoadMonitor`` gauge
trips, the rebalancer picks a **minimal, cheapest-first** set of resident
edges to migrate and executes the move through the *same*
``repack_partitions`` remap machinery that ``compact()`` already uses —
which is exactly what lets warm device state, runner-cache entries, and the
tiered result cache survive a migration:

  - the remap carries ``[P, v_max, K]`` warm blocks to their new rows
    (``RebalanceStats.remap_state``, same contract as ``CompactStats``);
  - capacities land on the shape policy's bucket floor, so a migration that
    stays inside the current buckets keeps every compiled runner — zero
    retraces (the acceptance test pins this with ``retrace_guard``);
  - the session bumps its graph version, which *implicitly* invalidates all
    result-cache entries (keys carry the version) — no flush protocol.

Planning is deterministic greedy: donors (partitions above ``target`` x
mean edge load) shed their overflow, cheapest edges first, where the cost
of moving edge (u, v) to partition r counts the replicas the move would
*create* (0 if r already hosts both endpoints — a boundary edge, 1 for one
endpoint, 2 for none). Receivers fill up to the mean; spill beyond a
receiver's capacity is deferred to the next trigger rather than forced
into a worse placement. Migrated pairs are recorded in the routing
context's relocation table (``EBVRouterState.apply_moves`` or a fresh
``RelocationOverlay`` over a pure hash) so later deletes/re-adds of a
moved pair still find the resident copies.

The JAX package's planner and executor (``repro.partition.rebalance``),
numpy for numpy: the same plans and the same host arrays after a move.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.graph import unique_sorted
from repro_torch.core.partition import route_vertices_rh
from repro_torch.core.subgraph import (PartitionedGraph, ShapePolicy,
                                       repack_partitions)
from repro_torch.stream.delta import _remap_rows
from repro_torch.stream.ingest import StreamContext

__all__ = ["RebalancePlan", "RebalanceStats", "plan_rebalance",
           "execute_rebalance"]


@dataclasses.dataclass
class RebalancePlan:
    """A concrete migration: per-donor edge indices (into the donor's
    *masked resident edge list*, valid until the next mutation) and their
    destination partitions."""

    # donor partition -> (edge indices int64[], destination parts int32[])
    moves: dict = dataclasses.field(default_factory=dict)
    imbalance_before: float = 1.0
    imbalance_after: float = 1.0      # predicted edge-count imbalance
    edges_considered: int = 0

    @property
    def n_moves(self) -> int:
        return sum(int(idx.size) for idx, _ in self.moves.values())


@dataclasses.dataclass
class RebalanceStats:
    """What ``execute_rebalance`` did, plus the state-carrying remap
    (same ``remap_state`` contract as ``CompactStats``/``DeltaStats``)."""

    n_moved: int = 0
    parts_from: int = 0
    parts_to: int = 0
    replicas_created: int = 0         # new replica rows the moves added
    imbalance_before: float = 1.0
    imbalance_after: float = 1.0      # realized edge-count imbalance
    v_max_before: int = 0
    v_max_after: int = 0
    e_max_before: int = 0
    e_max_after: int = 0
    n_slots_before: int = 0
    n_slots_after: int = 0
    remap: Optional[np.ndarray] = None   # [P, v_max_before] int32

    def remap_state(self, state: np.ndarray, fill) -> np.ndarray:
        """Carry a live ``[P, v_max_before(, K)]`` per-partition array
        across the migration's row re-layout. Migration moves *edges*, not
        values: surviving members keep their values at their new rows, new
        replica rows start at ``fill`` (the program's combiner identity — a
        valid bound, SBS combines replicas every superstep)."""
        if self.remap is None:
            return np.asarray(state)
        return _remap_rows(self.remap, self.v_max_after, state, fill)


def _resident_edges(pg: PartitionedGraph, p: int):
    m = pg.emask[p]
    gs = pg.gvid[p][pg.esrc[p][m]]
    gd = pg.gvid[p][pg.edst[p][m]]
    return gs, gd, pg.ew[p][m]


def _member_lookup(pg: PartitionedGraph, p: int) -> np.ndarray:
    """Sorted member ids of partition p (gvid rows are sorted unique)."""
    return pg.gvid[p][pg.vmask[p]]


def _has_member(members: np.ndarray, vids: np.ndarray) -> np.ndarray:
    if members.size == 0:
        return np.zeros(vids.shape, bool)
    pos = np.searchsorted(members, vids)
    pos = np.minimum(pos, members.size - 1)
    return members[pos] == vids


def plan_rebalance(pg: PartitionedGraph, *, target: float = 1.05,
                   max_fraction: float = 0.25,
                   loads: Optional[np.ndarray] = None) -> RebalancePlan:
    """Plan a minimal cheapest-first migration toward balanced edge loads.

    ``target``: donors are partitions above ``target * mean`` edges; the
    plan sheds them down to the mean. ``max_fraction`` caps the total moved
    edges at that fraction of |E| (a rebalance is an online nicety, not a
    re-partition). ``loads`` optionally weights donor selection by a
    measured per-partition load vector (the monitor's blended signal) in
    place of raw edge counts — moves themselves are always edges.
    """
    P = pg.n_parts
    epp = pg.edges_per_part.astype(np.int64)
    total = int(epp.sum())
    mean = total / max(P, 1)
    plan = RebalancePlan(
        imbalance_before=float(epp.max() / max(mean, 1e-12)),
        imbalance_after=float(epp.max() / max(mean, 1e-12)))
    if total == 0 or P < 2:
        return plan
    sel = epp if loads is None else np.asarray(loads, np.float64)
    donors = [p for p in np.argsort(-sel, kind="stable").tolist()
              if epp[p] > target * mean]
    if not donors:
        return plan

    move_budget = int(max_fraction * total)
    new_epp = epp.astype(np.float64).copy()
    # receivers absorb up to the mean; refreshed as the plan fills them
    capacity = np.maximum(mean - new_epp, 0.0)
    members = [_member_lookup(pg, p) for p in range(P)]

    for p in donors:
        quota = int(min(np.ceil(new_epp[p] - mean), move_budget))
        if quota <= 0:
            continue
        gs, gd, _ = _resident_edges(pg, p)
        plan.edges_considered += int(gs.size)
        receivers = np.array([r for r in range(P)
                              if r != p and capacity[r] >= 1.0], np.int64)
        if receivers.size == 0:
            break
        # cost[e, r] = replicas created by moving edge e to receiver r
        cost = np.zeros((gs.size, receivers.size), np.int8)
        for j, r in enumerate(receivers.tolist()):
            cost[:, j] = ((~_has_member(members[r], gs)).astype(np.int8)
                          + (~_has_member(members[r], gd)).astype(np.int8))
        # per edge: cheapest receiver, load-ascending tie-break (receiver
        # columns scanned in load order so argmin lands on the emptiest)
        order_j = np.argsort(new_epp[receivers], kind="stable")
        cost_sorted = cost[:, order_j]
        best_j = np.argmin(cost_sorted, axis=1)
        best_r = receivers[order_j][best_j]
        best_cost = cost_sorted[np.arange(gs.size), best_j]
        # cheapest edges first; stable sort keeps the plan deterministic
        order = np.argsort(best_cost, kind="stable")[:max(4 * quota, quota)]
        take_idx, take_dst = [], []
        taken = 0
        for e in order.tolist():
            r = int(best_r[e])
            if capacity[r] < 1.0:
                continue
            take_idx.append(e)
            take_dst.append(r)
            capacity[r] -= 1.0
            new_epp[r] += 1.0
            taken += 1
            if taken >= quota:
                break
        if taken:
            plan.moves[p] = (np.asarray(take_idx, np.int64),
                             np.asarray(take_dst, np.int32))
            new_epp[p] -= taken
            move_budget -= taken
        if move_budget <= 0:
            break

    plan.imbalance_after = float(new_epp.max() / max(mean, 1e-12))
    return plan


def execute_rebalance(pg: PartitionedGraph, ctx: StreamContext,
                      plan: RebalancePlan, *, pad_multiple: int = 8,
                      shape_policy: Optional[ShapePolicy] = None
                      ) -> RebalanceStats:
    """Execute a migration plan in place through ``repack_partitions``.

    Rebuilds every partition's membership/edge lists with the planned moves
    applied, repacks the dense padded arrays (capacities land on the shape
    policy's bucket floor — in-bucket migrations keep compiled runners),
    records the moved pairs in ``ctx``'s relocation table, and returns the
    stats whose ``remap_state`` carries live device-layout state across."""
    if ctx is None or ctx.n_parts != pg.n_parts:
        raise ValueError("execute_rebalance needs the graph's StreamContext "
                         f"(P={pg.n_parts}), got {ctx!r}")
    P = pg.n_parts
    epp = pg.edges_per_part.astype(np.float64)
    mean = max(float(epp.mean()), 1e-12)
    stats = RebalanceStats(
        imbalance_before=float(epp.max() / mean),
        imbalance_after=float(epp.max() / mean),
        v_max_before=pg.v_max, e_max_before=pg.e_max,
        n_slots_before=pg.n_slots, n_slots_after=pg.n_slots)
    if plan.n_moves == 0:
        return stats
    replicas_before = int(pg.vmask.sum())

    part_edges = [list(_resident_edges(pg, p)) for p in range(P)]
    moved_src, moved_dst, moved_part = [], [], []
    appends: dict = {r: [] for r in range(P)}
    for p, (idx, dst_part) in plan.moves.items():
        gs, gd, w = part_edges[p]
        for r in np.unique(dst_part).tolist():
            sel = idx[dst_part == r]
            appends[r].append((gs[sel], gd[sel], w[sel]))
        moved_src.append(gs[idx])
        moved_dst.append(gd[idx])
        moved_part.append(dst_part)
        keep = np.ones(gs.size, bool)
        keep[idx] = False
        part_edges[p] = [gs[keep], gd[keep], w[keep]]
    for r, chunks in appends.items():
        if chunks:
            gs, gd, w = part_edges[r]
            part_edges[r] = [
                np.concatenate([gs] + [c[0] for c in chunks]),
                np.concatenate([gd] + [c[1] for c in chunks]),
                np.concatenate([w] + [c[2] for c in chunks])]
    moved_src = np.concatenate(moved_src)
    moved_dst = np.concatenate(moved_dst)
    moved_part = np.concatenate(moved_part)

    # membership = endpoints of resident edges; fully isolated vertices are
    # re-homed by the same hash round-robin as ingest/compact
    members = []
    touched = np.zeros(pg.n_vertices, bool)
    for p in range(P):
        gs, gd, _ = part_edges[p]
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

    stats.remap = repack_partitions(
        pg, members, [tuple(e) for e in part_edges],
        pad_multiple=pad_multiple, shape_policy=shape_policy)

    # pin the moved pairs in the routing context so later deletes/re-adds
    # find the migrated copies (stateful router: exact table + resync;
    # pure hash: install a RelocationOverlay)
    if ctx.router_state is None:
        from repro_torch.partition.ebv import RelocationOverlay
        ctx.router_state = RelocationOverlay(ctx._route_pure)
    ctx.router_state.apply_moves(pg, moved_src, moved_dst, moved_part)

    stats.n_moved = int(moved_src.size)
    stats.parts_from = len(plan.moves)
    stats.parts_to = int(np.unique(moved_part).size)
    stats.replicas_created = int(pg.vmask.sum()) - replicas_before
    epp = pg.edges_per_part.astype(np.float64)
    stats.imbalance_after = float(epp.max() / max(epp.mean(), 1e-12))
    stats.v_max_after = pg.v_max
    stats.e_max_after = pg.e_max
    stats.n_slots_after = pg.n_slots
    return stats
