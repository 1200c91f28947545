"""Graph containers for DRONE/SVHM.

Host-side (numpy) representation used by the partitioners and the subgraph
builder. Vertex ids are int64 end-to-end so the *design* scales to
trillion-edge graphs (the paper's headline claim); local per-partition indices
are int32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Graph", "splitmix64", "unique_sorted"]


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix hash (SplitMix64 finalizer), vectorized.

    Used everywhere a hash-based placement decision is made (RH / CDBH / EC),
    so that partitioning is a pure function of (entity, n_parts, seed) — the
    property our elastic re-partitioning relies on (DESIGN.md §7).
    """
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def unique_sorted(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` for integer ``a`` (the sorted distinct values) by a
    sort and one comparison. NumPy 2.3 moved ``np.unique`` to a hash table
    that takes seconds on the ~2 M distinct int64 keys of a kron-20
    partition; a sort takes tens of milliseconds."""
    a = np.sort(np.asarray(a).ravel())
    if a.size < 2:
        return a
    keep = np.empty(a.shape[0], bool)
    keep[0] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


@dataclasses.dataclass
class Graph:
    """A directed graph in COO form. Undirected graphs are stored with both
    edge directions present (the paper's convention, §2 Notations)."""

    n_vertices: int
    src: np.ndarray  # [E] int64
    dst: np.ndarray  # [E] int64
    weight: Optional[np.ndarray] = None  # [E] float32 (None -> unit weights)
    directed: bool = True

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int64)
        self.dst = np.asarray(self.dst, dtype=np.int64)
        if self.weight is not None:
            self.weight = np.asarray(self.weight, dtype=np.float32)
            assert self.weight.shape == self.src.shape
        assert self.src.shape == self.dst.shape
        if self.n_edges:
            assert int(self.src.max()) < self.n_vertices
            assert int(self.dst.max()) < self.n_vertices
            assert int(min(self.src.min(), self.dst.min())) >= 0

    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def weights(self) -> np.ndarray:
        if self.weight is None:
            return np.ones_like(self.src, dtype=np.float32)
        return self.weight

    # ------------------------------------------------------------------ #
    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_vertices).astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n_vertices).astype(np.int64)

    def total_degrees(self) -> np.ndarray:
        """Full degree per the paper's ``getDegree()`` (in + out)."""
        return self.out_degrees() + self.in_degrees()

    # ------------------------------------------------------------------ #
    def as_undirected(self) -> "Graph":
        """Replace each edge by two opposite-direction edges (paper §2),
        de-duplicated."""
        s = np.concatenate([self.src, self.dst])
        d = np.concatenate([self.dst, self.src])
        w = np.concatenate([self.weights, self.weights])
        # dedupe on (s, d)
        key = s * np.int64(self.n_vertices) + d
        _, idx = np.unique(key, return_index=True)
        return Graph(self.n_vertices, s[idx], d[idx], w[idx], directed=False)

    def dedup(self) -> "Graph":
        key = self.src * np.int64(self.n_vertices) + self.dst
        _, idx = np.unique(key, return_index=True)
        w = None if self.weight is None else self.weight[idx]
        return Graph(self.n_vertices, self.src[idx], self.dst[idx], w,
                     directed=self.directed)

    def drop_self_loops(self) -> "Graph":
        keep = self.src != self.dst
        w = None if self.weight is None else self.weight[keep]
        return Graph(self.n_vertices, self.src[keep], self.dst[keep], w,
                     directed=self.directed)

    # ------------------------------------------------------------------ #
    def isolated_vertices(self) -> np.ndarray:
        touched = np.zeros(self.n_vertices, dtype=bool)
        touched[self.src] = True
        touched[self.dst] = True
        return np.nonzero(~touched)[0].astype(np.int64)
