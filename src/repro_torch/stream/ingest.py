"""Two-pass out-of-core ingestion: edge log -> PartitionedGraph.

Pass 1  (degrees):   stream chunks, accumulate full in/out degree counts —
                     CDBH routing needs the *full-graph* degree of every
                     endpoint before any edge can be placed (paper §6.3).
Pass 2  (routing):   stream chunks again, route each edge with the pure
                     chunk routers (``core.partition.STREAM_ROUTERS``) and
                     append it to its partition's on-disk spill shard.
Assembly:            per partition, read the spill shard back (one partition
                     resident at a time), derive membership, and fill the
                     padded arrays via ``core.subgraph``'s layered builder.

Because the routers are pure per-edge functions, the result is bit-identical
to the one-shot in-memory path (``partition_and_build``) and to the JAX
package's ``streaming_ingest``; that parity is why the default
``ShapePolicy`` here is the exact one (a session passes its bucketed policy
explicitly). The returned ``StreamContext`` freezes the routing inputs
(partitioner, seed, degree snapshot, ingest-time id-space size): every later
delta routes through it unchanged, or resident edges stop being findable.
Peak *edge* memory is O(chunk_size), never O(|E|): the ``ChunkAccountant``
measures every transient edge buffer the passes hold and
``streaming_ingest`` checks the measured peak against an analytic
O(chunk_size) bound.

Stateful-streaming routers (the ``"ebv"`` ``STREAM_ROUTERS`` entry) route
pass 2 through a router state built after the degree pass; the state rides
on the returned ``StreamContext`` (``ctx.router_state``), so deltas keep
routing through it. Its replica bitmask and exact pair table are
O(V * P / 64) and O(distinct pairs) host memory, the documented price of
load-aware placement; the transient chunk buffers stay bounded either way.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Optional, Union

import numpy as np

from repro_torch.core.graph import unique_sorted
from repro_torch.core.partition import (STREAM_ROUTERS, is_stateful_router,
                                        route_vertices_rh)
from repro_torch.core.subgraph import (PartitionedGraph, ShapePolicy,
                                       assemble_partitioned_graph)
from repro_torch.stream.edgelog import (BYTES_PER_EDGE, EdgeLogReader,
                                        EdgeLogWriter)

__all__ = ["StreamContext", "IngestStats", "ChunkAccountant",
           "streaming_ingest"]


def check_stream_router(partitioner: str) -> None:
    """Raise unless ``partitioner`` is one of the port's stream routers."""
    if partitioner not in STREAM_ROUTERS:
        raise ValueError(
            f"partitioner {partitioner!r} is not streamable "
            f"(streamable: {sorted(STREAM_ROUTERS)})")


@dataclasses.dataclass
class StreamContext:
    """Routing metadata frozen at ingest time.

    ``routing_degrees`` is the degree snapshot CDBH consulted when edges
    were placed. Delta batches (``stream.delta``) route through the *same*
    snapshot so an edge deletion finds its edge in the partition where
    ingestion put it, and re-inserted edges co-locate deterministically.
    Grown id-spaces extend the snapshot with zeros (new vertices route by
    their own hash)."""

    partitioner: str
    n_parts: int
    seed: int
    n_vertices: int
    routing_degrees: np.ndarray  # int64 [n_vertices]
    # id-space size frozen at ingest: the 'range' router divides by it, so
    # routing keeps the ingest-time value after growth (post-growth ids
    # clip to the last block; a no-op for ingest-time ids)
    routing_n_vertices: int = -1
    # a stateful router's state (``"ebv"``: an ``EBVRouterState``), or the
    # ``RelocationOverlay`` a rebalance installs over a pure hash; None for
    # an untouched pure router
    router_state: Optional[object] = None

    def __post_init__(self):
        check_stream_router(self.partitioner)
        if self.routing_n_vertices < 0:
            self.routing_n_vertices = self.n_vertices

    def _route_pure(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        entry = STREAM_ROUTERS[self.partitioner]
        if is_stateful_router(entry):
            raise ValueError(
                f"partitioner {self.partitioner!r} is stateful-streaming "
                "but this StreamContext has no router_state; build the "
                "context through streaming_ingest / GraphSession.from_graph "
                "(or attach spec.make_state(...) yourself)")
        part = entry(src, dst, self.routing_degrees,
                     self.routing_n_vertices, self.n_parts, self.seed)
        return np.minimum(part, self.n_parts - 1)

    def route(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Non-mutating routing: the pure hash, or a router state's preview
        of where an insert would land now. Mutations route through
        ``route_adds`` / ``route_deletes``; for a pure hash all three are
        the same."""
        if self.router_state is not None:
            return np.minimum(self.router_state.route_preview(src, dst),
                              self.n_parts - 1)
        return self._route_pure(src, dst)

    def route_adds(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Route inserted edges; a router state commits each placement
        (load counters, replica sets, pair table) as it routes."""
        if self.router_state is not None:
            return np.minimum(self.router_state.route_adds(src, dst),
                              self.n_parts - 1)
        return self._route_pure(src, dst)

    def route_deletes(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Route deletions to the partition holding the resident copies:
        a router state answers from its exact pair table, a pure hash
        re-hashes (its placement never moves)."""
        if self.router_state is not None:
            return np.minimum(self.router_state.route_deletes(src, dst),
                              self.n_parts - 1)
        return self._route_pure(src, dst)

    def grow(self, n_vertices: int) -> None:
        if n_vertices > self.n_vertices:
            self.routing_degrees = np.concatenate(
                [self.routing_degrees,
                 np.zeros(n_vertices - self.n_vertices, np.int64)])
            self.n_vertices = n_vertices
            if self.router_state is not None:
                self.router_state.grow(n_vertices)


class ChunkAccountant:
    """Tracks transient edge-buffer bytes held by the streaming passes.

    ``hold``/``drop`` bracket every chunk-sized allocation; ``sample`` folds
    in externally-owned buffers (spill-writer backlogs). The assembly phase
    is accounted separately — it is bounded by the largest partition, not by
    the chunk size."""

    def __init__(self):
        self.live = 0
        self.peak_stream = 0
        self.peak_assemble = 0

    def hold(self, nbytes: int) -> int:
        self.live += int(nbytes)
        self.peak_stream = max(self.peak_stream, self.live)
        return int(nbytes)

    def drop(self, nbytes: int) -> None:
        self.live -= int(nbytes)

    def sample(self, extra: int = 0) -> None:
        self.peak_stream = max(self.peak_stream, self.live + int(extra))


@dataclasses.dataclass
class IngestStats:
    n_edges: int = 0
    n_chunks: int = 0
    chunk_size: int = 0
    spill_chunk_size: int = 0
    peak_stream_bytes: int = 0       # measured: passes 1-2 transient buffers
    stream_bound_bytes: int = 0      # analytic O(chunk_size) bound (checked)
    peak_assemble_bytes: int = 0     # measured: largest resident partition
    pass1_time: float = 0.0
    pass2_time: float = 0.0
    assemble_time: float = 0.0

    @property
    def ingest_edges_per_s(self) -> float:
        t = self.pass1_time + self.pass2_time + self.assemble_time
        return self.n_edges / t if t > 0 else float("nan")


def _chunk_nbytes(src, dst, w) -> int:
    return src.nbytes + dst.nbytes + (w.nbytes if w is not None else 0)


def streaming_ingest(log: Union[str, EdgeLogReader], n_parts: int,
                     partitioner: str = "cdbh", *, seed: int = 0,
                     pad_multiple: int = 8,
                     shape_policy: Optional[ShapePolicy] = None,
                     include_isolated: bool = True,
                     spill_dir: Optional[str] = None, cleanup: bool = True,
                     ) -> tuple[PartitionedGraph, StreamContext, IngestStats]:
    """Stream an edge log into a PartitionedGraph without materializing |E|.

    Returns ``(pg, ctx, stats)`` — ``ctx`` is the frozen routing context for
    later incremental deltas (``stream.delta.apply_delta``). The streaming
    passes' measured peak is checked against the chunk-bounded contract.
    ``shape_policy`` picks the padded capacities (exact round-up by
    default; sessions pass their bucketed policy)."""
    if isinstance(log, str):
        log = EdgeLogReader(log)
    check_stream_router(partitioner)
    meta = log.meta
    V = meta.n_vertices
    chunk = meta.chunk_size
    acct = ChunkAccountant()
    stats = IngestStats(n_edges=meta.n_edges, n_chunks=meta.n_chunks,
                        chunk_size=chunk)

    # ---- pass 1: full degree counts + touched mask ---------------------- #
    t0 = time.perf_counter()
    out_deg = np.zeros(V, dtype=np.int64)
    in_deg = np.zeros(V, dtype=np.int64)
    touched = np.zeros(V, dtype=bool)
    for src, dst, w in log.chunks():
        held = acct.hold(_chunk_nbytes(src, dst, w))
        out_deg += np.bincount(src, minlength=V)
        in_deg += np.bincount(dst, minlength=V)
        touched[src] = True
        touched[dst] = True
        acct.drop(held)
    ctx = StreamContext(partitioner=partitioner, n_parts=n_parts, seed=seed,
                        n_vertices=V, routing_degrees=out_deg + in_deg)
    entry = STREAM_ROUTERS[partitioner]
    if is_stateful_router(entry):
        # a stateful router starts scoring from an empty state after the
        # degree pass and rides on the returned ctx for later deltas
        ctx.router_state = entry.make_state(n_parts, V, seed)
    stats.pass1_time = time.perf_counter() - t0

    # ---- pass 2: route chunks to per-partition spill shards -------------- #
    t0 = time.perf_counter()
    own_spill = spill_dir is None
    if own_spill:
        spill_dir = tempfile.mkdtemp(prefix="drone_spill_")
    os.makedirs(spill_dir, exist_ok=True)
    # Spill writers flush at ~chunk/P edges so their combined backlog stays
    # O(chunk_size) even with every partition's buffer full.
    spill_chunk = max(chunk // max(n_parts, 1), 1024)
    stats.spill_chunk_size = spill_chunk
    writers = [EdgeLogWriter(os.path.join(spill_dir, f"part_{p:05d}"),
                             chunk_size=spill_chunk, weighted=True,
                             n_vertices=V)
               for p in range(n_parts)]
    for src, dst, w in log.chunks():
        held = acct.hold(_chunk_nbytes(src, dst, w))
        part = ctx.route_adds(src, dst)
        order = np.argsort(part, kind="stable")   # chunk order == log order
        held2 = acct.hold(order.nbytes + src.nbytes + dst.nbytes
                          + 4 * src.size)
        s, d = src[order], dst[order]
        ww = (np.ones(src.shape, np.float32) if w is None else w)[order]
        starts = np.searchsorted(part[order], np.arange(n_parts + 1))
        for p in range(n_parts):
            lo, hi = starts[p], starts[p + 1]
            if lo < hi:
                writers[p].append(s[lo:hi], d[lo:hi], ww[lo:hi])
        acct.sample(sum(wr.buffered_nbytes for wr in writers))
        acct.drop(held + held2)
    shard_meta = [wr.close() for wr in writers]
    edge_counts = np.array([m.n_edges for m in shard_meta], dtype=np.int64)
    if int(edge_counts.sum()) != meta.n_edges:
        raise RuntimeError(
            f"spill shards hold {int(edge_counts.sum())} edges, the log "
            f"{meta.n_edges}")
    stats.pass2_time = time.perf_counter() - t0

    # Chunk-bounded contract for the streaming passes: one chunk in flight,
    # one routed copy, plus the spill writers' bounded backlog.
    chunk_bytes = chunk * BYTES_PER_EDGE
    stats.stream_bound_bytes = (3 * chunk_bytes
                                + n_parts * spill_chunk * BYTES_PER_EDGE
                                + (1 << 16))
    stats.peak_stream_bytes = acct.peak_stream
    if stats.peak_stream_bytes > stats.stream_bound_bytes:
        raise RuntimeError(
            "streaming ingest exceeded its chunk-bounded memory contract: "
            f"{stats.peak_stream_bytes} > {stats.stream_bound_bytes}")

    # ---- assembly: one partition resident at a time ---------------------- #
    t0 = time.perf_counter()
    iso = np.nonzero(~touched)[0].astype(np.int64) if include_isolated else \
        np.empty(0, np.int64)
    iso_part = route_vertices_rh(iso, n_parts) if iso.size else iso

    # Each spill shard is read twice: once to derive membership (v_max must
    # be known for every partition before any row is filled) and once to
    # fill rows. Caching the first read would bring back O(|E|) host memory.
    readers = [EdgeLogReader(os.path.join(spill_dir, f"part_{p:05d}"))
               for p in range(n_parts)]
    part_vertices = []
    for p in range(n_parts):
        s, d, _ = readers[p].read_all()
        lv = unique_sorted(np.concatenate([s, d]))
        if iso.size:
            lv = unique_sorted(np.concatenate([lv, iso[iso_part == p]]))
        part_vertices.append(lv)
        acct.peak_assemble = max(acct.peak_assemble,
                                 s.nbytes + d.nbytes + lv.nbytes)

    def load_edges(p):
        s, d, w = readers[p].read_all()
        acct.peak_assemble = max(acct.peak_assemble,
                                 s.nbytes + d.nbytes + w.nbytes)
        return s, d, w

    pg = assemble_partitioned_graph(
        n_parts, V, meta.n_edges, part_vertices, edge_counts, load_edges,
        out_deg, in_deg, pad_multiple=pad_multiple,
        shape_policy=shape_policy, edge_part=None)
    stats.assemble_time = time.perf_counter() - t0
    stats.peak_assemble_bytes = acct.peak_assemble

    if cleanup and own_spill:
        shutil.rmtree(spill_dir, ignore_errors=True)
    return pg, ctx, stats
