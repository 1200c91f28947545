"""Chunked on-disk edge log — the out-of-core graph representation.

Layout (one directory per log):

    <path>/manifest.json            {"n_vertices", "n_edges", "weighted",
                                     "chunk_size", "chunk_edges": [...]}
    <path>/chunk_000000.npz         src:int64[c], dst:int64[c][, w:f32[c]]
    <path>/chunk_000001.npz         ...

Chunks are bounded at ``chunk_size`` edges, so any consumer that processes
one chunk at a time holds O(chunk_size) edge data — never O(|E|). The same
writer/reader pair serves both the user-facing edge log and the ingest
pipeline's per-partition spill shards (``repro_torch.stream.ingest`` pass
2). The format is the JAX package's byte for byte (same file names, same
``np.savez`` members and dtypes, same manifest keys), so a log either
package writes is read by the other.

Writes are streaming-append (``EdgeLogWriter.append``) with an atomic
manifest rename on ``close()``, so a crashed producer never leaves a log
that parses as complete.

Invariants: chunk order preserves append order (ingest parity with the
in-memory path depends on it); ``BYTES_PER_EDGE`` (int64 src + int64 dst +
float32 w = 20) is the accounting constant the ingest memory contract and
the benchmarks bill transient edge buffers with; the manifest's
``n_vertices`` covers every appended id (the writer tracks ``max(id) + 1``
and widens a caller-declared id-space that turns out too small).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.graph import Graph

__all__ = ["EdgeLogMeta", "EdgeLogWriter", "EdgeLogReader", "write_edge_log"]

_MANIFEST = "manifest.json"
# host bytes per buffered edge: int64 src + int64 dst + float32 w
BYTES_PER_EDGE = 20


@dataclasses.dataclass(frozen=True)
class EdgeLogMeta:
    n_vertices: int
    n_edges: int
    n_chunks: int
    chunk_size: int
    weighted: bool


def _chunk_name(i: int) -> str:
    return f"chunk_{i:06d}.npz"


class EdgeLogWriter:
    """Append edges; flush a chunk file whenever ``chunk_size`` is reached.

    ``n_vertices`` may be passed (id-space is known up front) or inferred as
    ``max(id) + 1`` over everything appended.
    """

    def __init__(self, path: str, *, chunk_size: int = 1 << 20,
                 weighted: bool = False, n_vertices: Optional[int] = None):
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be > 0, got {chunk_size}")
        self.path = path
        self.chunk_size = int(chunk_size)
        self.weighted = weighted
        self._given_nv = n_vertices
        self._max_id = -1
        self._n_edges = 0
        self._chunk_edges: list[int] = []
        self._buf_src: list[np.ndarray] = []
        self._buf_dst: list[np.ndarray] = []
        self._buf_w: list[np.ndarray] = []
        self._buffered = 0
        self._closed = False
        os.makedirs(path, exist_ok=True)

    # ------------------------------------------------------------------ #
    @property
    def buffered_nbytes(self) -> int:
        """Host bytes currently buffered (ingest chunk accounting)."""
        return self._buffered * BYTES_PER_EDGE

    def append(self, src, dst, w=None) -> None:
        if self._closed:
            raise ValueError("append() on a closed EdgeLogWriter")
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.size == 0:
            return
        if self.weighted:
            w = (np.ones(src.shape, np.float32) if w is None
                 else np.asarray(w, dtype=np.float32))
            if w.shape != src.shape:
                raise ValueError(f"weights {w.shape} do not match the "
                                 f"edges {src.shape}")
        self._max_id = max(self._max_id, int(src.max()), int(dst.max()))
        self._buf_src.append(src)
        self._buf_dst.append(dst)
        if self.weighted:
            self._buf_w.append(w)
        self._buffered += src.size
        self._n_edges += src.size
        if self._buffered >= self.chunk_size:
            self._drain(self.chunk_size)

    def _concat(self):
        src = np.concatenate(self._buf_src) if self._buf_src else \
            np.empty(0, np.int64)
        dst = np.concatenate(self._buf_dst) if self._buf_dst else \
            np.empty(0, np.int64)
        w = (np.concatenate(self._buf_w) if self._buf_w else
             np.empty(0, np.float32)) if self.weighted else None
        return src, dst, w

    def _write_chunk(self, src, dst, w) -> None:
        out = {"src": src, "dst": dst}
        if self.weighted:
            out["w"] = w
        idx = len(self._chunk_edges)
        np.savez(os.path.join(self.path, _chunk_name(idx)), **out)
        self._chunk_edges.append(int(src.shape[0]))

    def _drain(self, min_tail: int) -> None:
        """Flush full chunks; keep a < ``min_tail`` remainder buffered.
        Concatenates the backlog ONCE and slices windows off it (a large
        append flushing k chunks copies O(backlog), not O(k * backlog))."""
        src, dst, w = self._concat()
        off, n, cs = 0, src.shape[0], self.chunk_size
        while n - off >= max(min_tail, 1):
            take = min(cs, n - off)
            self._write_chunk(src[off:off + take], dst[off:off + take],
                              None if w is None else w[off:off + take])
            off += take
        self._buf_src = [src[off:]] if off < n else []
        self._buf_dst = [dst[off:]] if off < n else []
        if self.weighted:
            self._buf_w = [w[off:]] if off < n else []
        self._buffered = n - off

    # ------------------------------------------------------------------ #
    def close(self) -> EdgeLogMeta:
        if self._closed:
            return self.meta
        if self._buffered:
            self._drain(1)   # flush everything, remainder included
        # cover every appended id even when the caller declared a smaller
        # id-space (a short manifest would crash ingest's degree bincount)
        n_v = self._max_id + 1 if self._given_nv is None \
            else max(self._given_nv, self._max_id + 1)
        meta = dict(n_vertices=int(max(n_v, 0)), n_edges=self._n_edges,
                    weighted=self.weighted, chunk_size=self.chunk_size,
                    chunk_edges=self._chunk_edges)
        tmp = os.path.join(self.path, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.path, _MANIFEST))
        self._closed = True
        self._meta = EdgeLogMeta(meta["n_vertices"], meta["n_edges"],
                                 len(self._chunk_edges), self.chunk_size,
                                 self.weighted)
        return self._meta

    @property
    def meta(self) -> EdgeLogMeta:
        if not self._closed:
            raise ValueError("close() the writer first")
        return self._meta

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


class EdgeLogReader:
    """Iterate (src, dst, w) chunk triples; ``w`` is None when unweighted."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, _MANIFEST)) as f:
            m = json.load(f)
        self.meta = EdgeLogMeta(m["n_vertices"], m["n_edges"],
                                len(m["chunk_edges"]), m["chunk_size"],
                                m["weighted"])
        self._chunk_edges = m["chunk_edges"]

    def chunks(self) -> Iterator[tuple]:
        for i in range(self.meta.n_chunks):
            with np.load(os.path.join(self.path, _chunk_name(i))) as z:
                w = z["w"] if self.meta.weighted else None
                yield z["src"], z["dst"], w

    def __iter__(self):
        return self.chunks()

    def read_all(self) -> tuple:
        """Concatenate every chunk (spill-shard assembly: one partition's
        shards are loaded together, bounded by that partition's size)."""
        srcs, dsts, ws = [], [], []
        for s, d, w in self.chunks():
            srcs.append(s)
            dsts.append(d)
            if w is not None:
                ws.append(w)
        if not srcs:
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    np.empty(0, np.float32) if self.meta.weighted else None)
        return (np.concatenate(srcs), np.concatenate(dsts),
                np.concatenate(ws) if self.meta.weighted else None)


def write_edge_log(g: Graph, path: str, *,
                   chunk_size: int = 1 << 20) -> EdgeLogMeta:
    """Spill an in-memory Graph to a chunked edge log (tests/benchmarks;
    production producers append straight to an EdgeLogWriter)."""
    with EdgeLogWriter(path, chunk_size=chunk_size,
                       weighted=g.weight is not None,
                       n_vertices=g.n_vertices) as w:
        for lo in range(0, g.n_edges, chunk_size):
            hi = min(lo + chunk_size, g.n_edges)
            w.append(g.src[lo:hi], g.dst[lo:hi],
                     None if g.weight is None else g.weight[lo:hi])
    return w.meta
