"""Subgraph construction (paper §4.1, §6.3), host-side numpy.

Given an edge -> partition assignment (any vertex-cut or edge-cut
partitioner), build the ``PartitionedGraph``: dense padded per-partition
arrays with *local* int32 vertex indexing, plus the frontier-slot structure
that SBS (subgraph boundary synchronization) reduces over. Frontier vertices
(replicated in >= 2 partitions) each get a global slot in ``[0, n_slots)``;
masters are elected by hash (§4.3) and used to collect results.

The layers are the reference's: ``partition_vertex_sets`` (membership),
``frontier_election`` (slots + masters from membership alone),
``assemble_partitioned_graph`` (padded arrays, one partition's edges at a
time), ``build_partitioned_graph`` (the one-shot wrapper), and the two the
streaming path patches a graph with: ``recompute_frontier`` (slots and
masters re-elected in place after a membership change) and
``repack_partitions`` (the arrays rebuilt at fresh, possibly smaller,
capacities by a compaction). Every array is bit-identical to the JAX
package's for the same graph and assignment. Padded capacities
(``v_max``/``e_max``) come from a ``ShapePolicy``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.graph import Graph, splitmix64, unique_sorted
from repro_torch.core.partition import route_vertices_rh

__all__ = ["PartitionedGraph", "ShapePolicy", "resolve_shape_policy",
           "build_partitioned_graph", "frontier_election",
           "assemble_partitioned_graph", "partition_vertex_sets",
           "recompute_frontier", "repack_partitions", "localize_edges"]


@dataclasses.dataclass(frozen=True)
class ShapePolicy:
    """How content sizes become padded device capacities.

    ``bucket(n)`` rounds a content maximum up to the next value of the
    geometric series ``pad_multiple * growth^k`` (each rounded to
    ``pad_multiple``); ``growth=1.0`` is the exact round-up
    (``ShapePolicy.exact``). ``headroom`` scales the content size before
    bucketing; ``bucket_slots`` also buckets the SBS slot count.
    """

    growth: float = 2.0
    headroom: float = 1.0
    pad_multiple: int = 8
    bucket_slots: bool = True

    def __post_init__(self):
        if self.growth < 1.0:
            raise ValueError(f"ShapePolicy.growth must be >= 1.0, got "
                             f"{self.growth}")
        if self.headroom < 1.0:
            raise ValueError(f"ShapePolicy.headroom must be >= 1.0, got "
                             f"{self.headroom}")
        if self.pad_multiple < 1:
            raise ValueError(f"ShapePolicy.pad_multiple must be >= 1, got "
                             f"{self.pad_multiple}")

    @classmethod
    def exact(cls, pad_multiple: int = 8) -> "ShapePolicy":
        """Capacities are the content maximum rounded up to
        ``pad_multiple``; slot counts are exact."""
        return cls(growth=1.0, headroom=1.0, pad_multiple=pad_multiple,
                   bucket_slots=False)

    def _round(self, n: int) -> int:
        return int(-(-max(n, 1) // self.pad_multiple) * self.pad_multiple)

    def bucket(self, n: int) -> int:
        """Smallest admissible capacity >= ``n * headroom``."""
        need = max(1, int(math.ceil(max(n, 1) * self.headroom)))
        if self.growth <= 1.0:
            return self._round(need)
        b = self.pad_multiple
        while b < need:
            b = self._round(int(math.ceil(b * self.growth)))
        return b

    def slot_capacity(self, n_slots: int) -> int:
        """Exchange-buffer slot count a runner is built with; padded slot
        rows only ever hold the combiner identity."""
        if not self.bucket_slots or self.growth <= 1.0:
            return int(n_slots)
        return self.bucket(n_slots)


def resolve_shape_policy(shape_policy: Optional[ShapePolicy],
                         pad_multiple: int) -> ShapePolicy:
    """An explicit policy wins; otherwise the exact policy."""
    if shape_policy is None:
        return ShapePolicy.exact(pad_multiple)
    return shape_policy


def _pad_to(arr: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def localize_edges(lv: np.ndarray, gs: np.ndarray, gd: np.ndarray, w):
    """Global-id edges -> local int32 indices against the sorted membership
    ``lv``, stably sorted by destination (segment ops expect ascending
    dst)."""
    ls = np.searchsorted(lv, gs).astype(np.int32)
    ld = np.searchsorted(lv, gd).astype(np.int32)
    eo = np.argsort(ld, kind="stable")
    return ls[eo], ld[eo], np.asarray(w, dtype=np.float32)[eo]


@dataclasses.dataclass
class PartitionedGraph:
    """Dense, padded partitioned graph. All ``[P, ...]`` arrays are numpy on
    the host; ``engine._device_subgraph`` moves them to the device."""

    n_parts: int
    n_vertices: int      # global vertex count
    n_edges: int         # global edge count (unpadded)
    n_slots: int         # number of frontier (replicated) vertices
    v_max: int           # padded per-partition vertex capacity
    e_max: int           # padded per-partition edge capacity

    gvid: np.ndarray     # [P, v_max] int64 global id per local slot (-1 pad)
    vmask: np.ndarray    # [P, v_max] bool
    esrc: np.ndarray     # [P, e_max] int32 local src index (0 where padded)
    edst: np.ndarray     # [P, e_max] int32 local dst index, sorted ascending
    ew: np.ndarray       # [P, e_max] float32 edge weight (0 where padded)
    emask: np.ndarray    # [P, e_max] bool
    slot: np.ndarray     # [P, v_max] int32 frontier slot id; n_slots if none
    is_frontier: np.ndarray  # [P, v_max] bool — vertex replicated elsewhere
    out_deg: np.ndarray  # [P, v_max] float32 FULL (global) out-degree
    in_deg: np.ndarray   # [P, v_max] float32 FULL (global) in-degree
    is_master: np.ndarray  # [P, v_max] bool

    frontier_gvid: np.ndarray  # [n_slots] int64
    edge_part: Optional[np.ndarray] = None  # [E] int32 host-side assignment
    vlabel: Optional[np.ndarray] = None     # [P, v_max] int32
    # stacked tile/window decompositions for the kernel backends
    # (core/layouts.py EdgeLayouts), built on demand
    edge_layouts: Optional[object] = None

    @property
    def edges_per_part(self) -> np.ndarray:
        return self.emask.sum(axis=1)

    @property
    def vertices_per_part(self) -> np.ndarray:
        return self.vmask.sum(axis=1)

    def collect(self, values, fill=0) -> np.ndarray:
        """Gather per-vertex results from master replicas into a global
        [n_vertices, ...] array."""
        values = np.asarray(values)
        out = np.full((self.n_vertices,) + values.shape[2:], fill,
                      dtype=values.dtype)
        sel = self.vmask & self.is_master
        out[self.gvid[sel]] = values[sel]
        return out

    def set_vertex_labels(self, labels: np.ndarray) -> None:
        """Attach global per-vertex int labels (graph simulation §7.3) as
        the [P, v_max] int32 ``vlabel`` array, 0 at padded rows. A session
        uploads them with the graph, so set them before its first query."""
        lab = np.zeros((self.n_parts, self.v_max), dtype=np.int32)
        lab[self.vmask] = np.asarray(labels)[self.gvid[self.vmask]]
        self.vlabel = lab

    def ensure_edge_layouts(self, shape_policy: Optional[ShapePolicy] = None,
                            block_edges: int = 512):
        """The ``EdgeLayouts`` for this graph, built on first use (and
        rebuilt if the padded shapes moved since). The first build's policy
        sticks unless a caller passes another."""
        from repro_torch.core.layouts import build_edge_layouts
        lay = self.edge_layouts
        if lay is not None and lay.matches(self):
            return lay
        policy = resolve_shape_policy(
            shape_policy if lay is None or shape_policy is not None
            else lay.policy, 8)
        if lay is not None and shape_policy is None:
            block_edges = lay.block_edges
        self.edge_layouts = build_edge_layouts(self, policy, block_edges)
        return self.edge_layouts


def partition_vertex_sets(src: np.ndarray, dst: np.ndarray,
                          edge_part: np.ndarray, n_parts: int,
                          n_vertices: int, *,
                          isolated: Optional[np.ndarray] = None
                          ) -> list[np.ndarray]:
    """Per-partition sorted unique vertex ids: the endpoints of each
    partition's edges (Eq. 3), plus hash-round-robin isolated vertices."""
    pair_part = np.concatenate([edge_part, edge_part]).astype(np.int64)
    pair_vid = np.concatenate([src, dst])
    key = pair_part * np.int64(n_vertices) + pair_vid
    ukey = unique_sorted(key)
    up = (ukey // n_vertices).astype(np.int32)
    uv = (ukey % n_vertices).astype(np.int64)
    if isolated is not None and isolated.size:
        iso_p = route_vertices_rh(isolated, n_parts)
        up = np.concatenate([up, iso_p])
        uv = np.concatenate([uv, isolated])
        re = np.lexsort((uv, up))
        up, uv = up[re], uv[re]
    starts = np.searchsorted(up, np.arange(n_parts + 1))
    return [uv[starts[p]:starts[p + 1]] for p in range(n_parts)]


def frontier_election(part_vertices: Sequence[np.ndarray], n_vertices: int):
    """``(frontier_gvid, slot_of_gvid, masters)`` from per-partition
    membership. The master of v is its ``hash(v) % replica_count(v)``-th
    replica in partition-id order (paper §4.3 random replica election)."""
    replica_count = np.zeros(n_vertices, dtype=np.int64)
    for lv in part_vertices:
        replica_count[lv] += 1
    frontier_gvid = np.nonzero(replica_count >= 2)[0].astype(np.int64)
    n_slots = int(frontier_gvid.shape[0])
    slot_of_gvid = np.full(n_vertices, n_slots, dtype=np.int64)
    slot_of_gvid[frontier_gvid] = np.arange(n_slots)

    pick = (splitmix64(np.arange(n_vertices, dtype=np.uint64))
            % np.maximum(replica_count, 1).astype(np.uint64)).astype(np.int64)
    seen = np.zeros(n_vertices, dtype=np.int64)
    masters = []
    for lv in part_vertices:
        masters.append(seen[lv] == pick[lv])
        seen[lv] += 1
    return frontier_gvid, slot_of_gvid, masters


def assemble_partitioned_graph(
        n_parts: int, n_vertices: int, n_edges: int,
        part_vertices: Sequence[np.ndarray],
        edge_counts: np.ndarray,
        load_edges: Callable[[int], tuple],
        out_degrees: np.ndarray, in_degrees: np.ndarray,
        *, pad_multiple: int = 8,
        shape_policy: Optional[ShapePolicy] = None,
        edge_part: Optional[np.ndarray] = None,
        build_edge_layouts: bool = False) -> PartitionedGraph:
    """Fill the dense padded arrays. ``load_edges(p) -> (src, dst, w)``
    supplies partition p's edges in global ids, in their original order."""
    P = n_parts
    policy = resolve_shape_policy(shape_policy, pad_multiple)
    frontier_gvid, slot_of_gvid, masters = frontier_election(
        part_vertices, n_vertices)
    n_slots = int(frontier_gvid.shape[0])

    vcounts = np.array([lv.shape[0] for lv in part_vertices], dtype=np.int64)
    v_max = policy.bucket(int(vcounts.max()) if P else 1)
    e_max = policy.bucket(int(np.max(edge_counts)) if P else 1)

    gvid = np.full((P, v_max), -1, dtype=np.int64)
    vmask = np.zeros((P, v_max), dtype=bool)
    slot = np.full((P, v_max), n_slots, dtype=np.int32)
    is_master = np.zeros((P, v_max), dtype=bool)
    out_deg = np.zeros((P, v_max), dtype=np.float32)
    in_deg = np.zeros((P, v_max), dtype=np.float32)
    esrc = np.zeros((P, e_max), dtype=np.int32)
    edst = np.zeros((P, e_max), dtype=np.int32)
    ew = np.zeros((P, e_max), dtype=np.float32)
    emask = np.zeros((P, e_max), dtype=bool)

    g_out = out_degrees.astype(np.float32)
    g_in = in_degrees.astype(np.float32)

    for p in range(P):
        lv = part_vertices[p]
        nv = lv.shape[0]
        gvid[p, :nv] = lv
        vmask[p, :nv] = True
        slot[p, :nv] = slot_of_gvid[lv]
        is_master[p, :nv] = masters[p]
        out_deg[p, :nv] = g_out[lv]
        in_deg[p, :nv] = g_in[lv]

        es, ed, w = load_edges(p)
        ls, ld, ww = localize_edges(lv, es, ed, w)
        ne = es.shape[0]
        esrc[p, :ne] = ls
        edst[p, :ne] = ld
        ew[p, :ne] = ww
        emask[p, :ne] = True

    pg = PartitionedGraph(
        n_parts=P, n_vertices=n_vertices, n_edges=n_edges,
        n_slots=n_slots, v_max=v_max, e_max=e_max,
        gvid=gvid, vmask=vmask, esrc=esrc, edst=edst, ew=ew, emask=emask,
        slot=slot, is_frontier=(slot < n_slots) & vmask,
        out_deg=out_deg, in_deg=in_deg, is_master=is_master,
        frontier_gvid=frontier_gvid, edge_part=edge_part,
    )
    if build_edge_layouts:
        pg.ensure_edge_layouts(shape_policy=policy)
    return pg


def build_partitioned_graph(g: Graph, edge_part: np.ndarray, n_parts: int,
                            *, pad_multiple: int = 8,
                            shape_policy: Optional[ShapePolicy] = None,
                            include_isolated: bool = True,
                            build_edge_layouts: bool = False
                            ) -> PartitionedGraph:
    edge_part = np.asarray(edge_part, dtype=np.int32)
    if edge_part.shape != g.src.shape:
        raise ValueError(f"edge_part has shape {edge_part.shape}, the graph "
                         f"has {g.src.shape[0]} edges")

    order = np.argsort(edge_part, kind="stable")
    ps, pd = g.src[order], g.dst[order]
    pw = g.weights[order]
    counts = np.bincount(edge_part, minlength=n_parts).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])

    iso = g.isolated_vertices() if include_isolated else None
    part_vertices = partition_vertex_sets(g.src, g.dst, edge_part, n_parts,
                                          g.n_vertices, isolated=iso)

    def load_edges(p):
        return (ps[starts[p]:starts[p + 1]], pd[starts[p]:starts[p + 1]],
                pw[starts[p]:starts[p + 1]])

    return assemble_partitioned_graph(
        n_parts, g.n_vertices, g.n_edges, part_vertices, counts, load_edges,
        g.out_degrees(), g.in_degrees(), pad_multiple=pad_multiple,
        shape_policy=shape_policy, edge_part=edge_part,
        build_edge_layouts=build_edge_layouts)


# --------------------------------------------------------------------------- #
# In-place repack at fresh capacities (stream/delta.py compaction)
# --------------------------------------------------------------------------- #
def repack_partitions(pg: PartitionedGraph,
                      part_vertices: Sequence[np.ndarray],
                      part_edges: Sequence[tuple],
                      *, pad_multiple: int = 8,
                      shape_policy: Optional[ShapePolicy] = None
                      ) -> np.ndarray:
    """Rebuild ``pg``'s padded arrays in place from explicit per-partition
    membership (sorted unique global ids) and edge lists ``(src, dst, w)``
    in global ids. ``v_max``/``e_max`` are re-derived from the new content
    and may shrink (to the policy's bucket floor under a bucketed policy);
    slots and masters are re-elected; degrees and labels follow their
    global ids. Edge layouts, if the graph had them, are rebuilt under
    their own policy.

    Returns ``remap``: ``[P, old_v_max]`` int32, each old local row's new
    local row (-1 for evicted members and padding)."""
    P = pg.n_parts
    old_v_max = pg.v_max
    policy = resolve_shape_policy(shape_policy, pad_multiple)

    new_v_max = policy.bucket(
        max((lv.shape[0] for lv in part_vertices), default=1))
    new_e_max = policy.bucket(
        max((e[0].shape[0] for e in part_edges), default=1))

    # global per-vertex tables, read from the old replicas (all agree)
    sel = pg.vmask
    g_out = np.zeros(pg.n_vertices, np.float32)
    g_in = np.zeros(pg.n_vertices, np.float32)
    g_out[pg.gvid[sel]] = pg.out_deg[sel]
    g_in[pg.gvid[sel]] = pg.in_deg[sel]
    g_lab = None
    if pg.vlabel is not None:
        g_lab = np.zeros(pg.n_vertices, np.int32)
        g_lab[pg.gvid[sel]] = pg.vlabel[sel]

    remap = np.full((P, old_v_max), -1, np.int32)
    gvid = np.full((P, new_v_max), -1, np.int64)
    vmask = np.zeros((P, new_v_max), bool)
    out_deg = np.zeros((P, new_v_max), np.float32)
    in_deg = np.zeros((P, new_v_max), np.float32)
    vlabel = np.zeros((P, new_v_max), np.int32) if g_lab is not None else None
    esrc = np.zeros((P, new_e_max), np.int32)
    edst = np.zeros((P, new_e_max), np.int32)
    ew = np.zeros((P, new_e_max), np.float32)
    emask = np.zeros((P, new_e_max), bool)

    for p in range(P):
        lv = np.asarray(part_vertices[p], np.int64)
        nv = lv.shape[0]
        gvid[p, :nv] = lv
        vmask[p, :nv] = True
        out_deg[p, :nv] = g_out[lv]
        in_deg[p, :nv] = g_in[lv]
        if vlabel is not None:
            vlabel[p, :nv] = g_lab[lv]

        old_lv = pg.gvid[p][pg.vmask[p]]
        pos = np.searchsorted(lv, old_lv)
        kept = np.zeros(old_lv.shape[0], bool)
        in_range = pos < nv
        kept[in_range] = lv[pos[in_range]] == old_lv[in_range]
        remap[p, :old_lv.shape[0]] = np.where(kept, pos, -1).astype(np.int32)

        gs, gd, w = part_edges[p]
        ne = gs.shape[0]
        ls, ld, ww = localize_edges(lv, gs, gd, w)
        esrc[p, :ne] = ls
        edst[p, :ne] = ld
        ew[p, :ne] = ww
        emask[p, :ne] = True

    pg.gvid, pg.vmask = gvid, vmask
    pg.out_deg, pg.in_deg, pg.vlabel = out_deg, in_deg, vlabel
    pg.esrc, pg.edst, pg.ew, pg.emask = esrc, edst, ew, emask
    pg.v_max, pg.e_max = new_v_max, new_e_max
    pg.n_edges = int(emask.sum())
    pg.edge_part = None
    recompute_frontier(pg)
    if pg.edge_layouts is not None:
        # the tile/window grid moved with v_max and the rows: a fresh
        # layout object, so no device list of the old geometry survives
        old = pg.edge_layouts
        pg.edge_layouts = None
        pg.ensure_edge_layouts(shape_policy=old.policy,
                               block_edges=old.block_edges)
    return remap


# --------------------------------------------------------------------------- #
# Frontier maintenance after a membership patch (stream/delta.py)
# --------------------------------------------------------------------------- #
def recompute_frontier(pg: PartitionedGraph) -> None:
    """Re-derive ``slot``/``is_frontier``/``is_master``/``frontier_gvid``
    in place from the current ``gvid``/``vmask`` membership, with the
    builders' hash election (an unchanged membership round-trips
    bit-identically)."""
    part_vertices = [pg.gvid[p][pg.vmask[p]] for p in range(pg.n_parts)]
    frontier_gvid, slot_of_gvid, masters = frontier_election(
        part_vertices, pg.n_vertices)
    n_slots = int(frontier_gvid.shape[0])
    pg.slot = np.full((pg.n_parts, pg.v_max), n_slots, dtype=np.int32)
    pg.is_master = np.zeros((pg.n_parts, pg.v_max), dtype=bool)
    for p in range(pg.n_parts):
        nv = part_vertices[p].shape[0]
        pg.slot[p, :nv] = slot_of_gvid[part_vertices[p]]
        pg.is_master[p, :nv] = masters[p]
    pg.n_slots = n_slots
    pg.frontier_gvid = frontier_gvid
    pg.is_frontier = (pg.slot < n_slots) & pg.vmask
