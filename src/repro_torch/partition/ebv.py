"""EBV: efficiency-and-balance vertex-cut streaming router.

Zhang et al. (arXiv:2010.09007, DRONE's own follow-up paper) partition the
edge stream by jointly minimizing replication and load imbalance: edge
(u, v) goes to the partition minimizing

    score(p) = I[u not replicated on p] + I[v not replicated on p]
             + alpha * |E_p| * P / (|E_routed| + 1)
             + beta  * |V_p| * P / (sum_q |V_q| + 1)

The first two terms prefer partitions that already hold the endpoints (low
replication factor); the load terms steer ties — and eventually any
placement — toward underloaded partitions. Unlike the pure hashes in
``core/partition.py`` this is **stateful-streaming**: the score depends on
every previously routed edge, so chunking order matters and the state must
travel with the ``StreamContext``.

Determinism and resumability contract (what the tests pin):

  - given the same sequence of ``route_adds`` calls, assignments are
    bit-identical — scoring runs in fixed-size mini-blocks with the state
    frozen inside a block and folded in between blocks;
  - ``checkpoint()``/``from_checkpoint()`` snapshot/restore the full state:
    a restored router continues the stream with bit-identical assignments;
  - routing is **pair-sticky**: every placement is recorded in an exact
    edge->partition table keyed by the canonical pair key, so duplicate
    copies and both directions of an undirected edge co-locate, and
    ``route_deletes`` finds resident edges without replaying the stream.

The price of load-awareness is O(distinct pairs) host memory for the
assignment table plus O(V * P / 64) for the packed replica bitmask — the
table is two-tier (sorted base arrays + a small dict overlay merged in
batches) so lookups stay O(log E) and inserts amortized O(1).
``route_deletes`` does not decrement the load counters (a delete does not
say how many resident copies it removed); ``resync()`` re-reads the exact
counters from a realized ``PartitionedGraph`` — the rebalancer calls it
after every migration.

This is the JAX package's router (``repro.partition.ebv``), numpy for
numpy: the same scores, mini-blocks and tie-breaks, so both packages place
every edge on the same partition, and ``checkpoint()`` writes the same
dict — ``from_checkpoint`` resumes a stream either package routed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph, splitmix64, unique_sorted

__all__ = ["EBVConfig", "EBVRouterState", "RelocationOverlay",
           "ebv_vertex_cut"]

_KEY_SHIFT = np.uint64(32)
_ONE = np.uint64(1)
# overlay entries are merged into the sorted base arrays at this size: large
# enough to amortize the re-sort, small enough to keep per-edge dict cost flat
_MERGE_AT = 1 << 16


def pair_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Canonical uint64 key for an undirected endpoint pair: (lo << 32) | hi.

    Growth-stable (independent of ``n_vertices``, unlike the dense
    ``src * V + dst`` key the delta patcher uses internally), so table
    entries survive id-space growth. Requires ids < 2**32 — far beyond the
    int32 local-index envelope the builders already impose.
    """
    lo = np.minimum(src, dst).astype(np.uint64)
    hi = np.maximum(src, dst).astype(np.uint64)
    return (lo << _KEY_SHIFT) | hi


class _PairTable:
    """Exact edge-key -> partition map, two-tier: a sorted uint64 base array
    (binary-searched) under a dict overlay (recent inserts; wins on
    conflict), merged down when the overlay grows past ``_MERGE_AT``."""

    def __init__(self, keys=None, parts=None):
        self.base_keys = (np.empty(0, np.uint64) if keys is None
                          else np.asarray(keys, np.uint64))
        self.base_parts = (np.empty(0, np.int32) if parts is None
                           else np.asarray(parts, np.int32))
        self.overlay: dict = {}

    def __len__(self) -> int:
        # upper bound: overlay entries may shadow base entries until merged
        return int(self.base_keys.size) + len(self.overlay)

    def get(self, keys: np.ndarray) -> np.ndarray:
        """Partition per key; -1 where the pair was never recorded."""
        out = np.full(keys.shape, -1, np.int32)
        if self.base_keys.size:
            pos = np.searchsorted(self.base_keys, keys)
            pos_c = np.minimum(pos, self.base_keys.size - 1)
            hit = self.base_keys[pos_c] == keys
            out[hit] = self.base_parts[pos_c[hit]]
        if self.overlay:
            ov = self.overlay
            for i, k in enumerate(keys.tolist()):
                p = ov.get(k)
                if p is not None:
                    out[i] = p
        return out

    def put(self, keys: np.ndarray, parts: np.ndarray) -> None:
        ov = self.overlay
        for k, p in zip(keys.tolist(), parts.tolist()):
            ov[k] = p
        if len(ov) >= _MERGE_AT:
            self.merge()

    def merge(self) -> None:
        """Fold the overlay into the sorted base (overlay wins on dups)."""
        if not self.overlay:
            return
        ok = np.fromiter(self.overlay.keys(), np.uint64, len(self.overlay))
        op = np.fromiter(self.overlay.values(), np.int32, len(self.overlay))
        keys = np.concatenate([self.base_keys, ok])
        parts = np.concatenate([self.base_parts, op])
        order = np.argsort(keys, kind="stable")   # base first, overlay after
        keys, parts = keys[order], parts[order]
        # keep the LAST entry of every duplicate run (the overlay's value)
        keep = np.ones(keys.size, bool)
        keep[:-1] = keys[:-1] != keys[1:]
        self.base_keys = keys[keep]
        self.base_parts = parts[keep]
        self.overlay = {}

    def snapshot(self) -> tuple:
        self.merge()
        return self.base_keys.copy(), self.base_parts.copy()


@dataclasses.dataclass(frozen=True)
class EBVConfig:
    """EBV objective weights + scoring granularity (all deterministic)."""

    alpha: float = 1.0      # edge-balance weight
    beta: float = 1.0       # vertex(replica)-balance weight
    block: int = 256        # mini-block size: state is frozen within a block


class EBVRouterState:
    """Running EBV router state: per-partition replica sets (packed bitmask),
    edge/replica load counters, and the exact pair->partition table.

    Mutating entry point is ``route_adds``; ``route_deletes`` and
    ``route_preview`` never change state. ``checkpoint``/``from_checkpoint``
    round-trip the whole thing (the streaming-resume contract)."""

    name = "ebv"

    def __init__(self, n_parts: int, n_vertices: int, *, seed: int = 0,
                 cfg: EBVConfig | None = None):
        if n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {n_parts}")
        self.n_parts = int(n_parts)
        self.n_vertices = int(n_vertices)
        self.seed = int(seed)
        self.cfg = cfg or EBVConfig()
        words = (self.n_parts + 63) // 64
        # replicas[v, w] bit b set <=> vertex v has a replica on part w*64+b
        self.replicas = np.zeros((self.n_vertices, words), np.uint64)
        self.edge_load = np.zeros(self.n_parts, np.int64)
        self.replica_load = np.zeros(self.n_parts, np.int64)
        self.total_edges = 0
        self.table = _PairTable()
        self._word = np.arange(self.n_parts) // 64
        self._bit = (np.arange(self.n_parts) % 64).astype(np.uint64)

    # ------------------------------------------------------------------ #
    def grow(self, n_vertices: int) -> None:
        if n_vertices > self.n_vertices:
            extra = np.zeros((n_vertices - self.n_vertices,
                              self.replicas.shape[1]), np.uint64)
            self.replicas = np.concatenate([self.replicas, extra])
            self.n_vertices = int(n_vertices)

    def _present(self, vids: np.ndarray) -> np.ndarray:
        """[N, P] bool: does vertex vids[i] have a replica on partition p?"""
        rows = self.replicas[vids]                       # [N, W]
        return ((rows[:, self._word] >> self._bit) & _ONE).astype(bool)

    def _score_block(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Argmin-EBV partition per edge, state frozen (ties -> lowest id)."""
        P = self.n_parts
        miss = 2.0 - (self._present(lo).astype(np.float64)
                      + self._present(hi).astype(np.float64))
        e_norm = self.cfg.alpha * P / (self.total_edges + 1.0)
        r_norm = self.cfg.beta * P / (float(self.replica_load.sum()) + 1.0)
        score = miss + self.edge_load * e_norm + self.replica_load * r_norm
        return np.argmin(score, axis=1).astype(np.int32)

    def _place(self, lo: np.ndarray, hi: np.ndarray,
               parts: np.ndarray) -> None:
        """Fold a scored block into the state: set replica bits (counting
        only newly-set ones into ``replica_load``) and bump edge loads."""
        vid = np.concatenate([lo, hi])
        pp = np.concatenate([parts, parts]).astype(np.int64)
        # dedup (vertex, partition) pairs so a block never double-counts
        uniq = unique_sorted(vid * np.int64(self.n_parts) + pp)
        uv = uniq // self.n_parts
        up = uniq % self.n_parts
        w = self._word[up]
        m = _ONE << self._bit[up]
        newbit = (self.replicas[uv, w] & m) == 0
        np.bitwise_or.at(self.replicas, (uv, w), m)
        self.replica_load += np.bincount(up[newbit], minlength=self.n_parts)
        self.edge_load += np.bincount(parts, minlength=self.n_parts)
        self.total_edges += int(parts.size)

    # ------------------------------------------------------------------ #
    def route_adds(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Place a chunk of inserts; updates state. Pairs already in the
        table stick to their recorded partition (co-location of duplicate
        copies and of both directions of an undirected edge)."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.size == 0:
            return np.empty(0, np.int32)
        if src.size and int(max(src.max(), dst.max())) >= self.n_vertices:
            self.grow(int(max(src.max(), dst.max())) + 1)
        keys = pair_keys(src, dst)
        out = self.table.get(keys)
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        unknown = np.nonzero(out < 0)[0]
        known = np.nonzero(out >= 0)[0]
        for s in range(0, unknown.size, self.cfg.block):
            idx = unknown[s:s + self.cfg.block]
            if s:
                # a duplicate pair may have been placed by an earlier block
                # of this very call — stick to it (within one block, equal
                # rows score identically, so same-block dups already agree)
                now = self.table.get(keys[idx])
                stick = now >= 0
                if stick.any():
                    out[idx[stick]] = now[stick]
                    self._place(lo[idx[stick]], hi[idx[stick]], now[stick])
                    idx = idx[~stick]
                    if idx.size == 0:
                        continue
            choice = self._score_block(lo[idx], hi[idx])
            out[idx] = choice
            self._place(lo[idx], hi[idx], choice)
            self.table.put(keys[idx], choice)
        if known.size:
            # sticky re-adds: another copy lands on the recorded partition
            self._place(lo[known], hi[known], out[known])
        return out

    def route_deletes(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Partition holding the pair's resident copies (exact, from the
        table). Pairs never routed fall back to a deterministic hash — a
        delete of a non-resident pair is a no-op wherever it lands. Never
        mutates state (load counters drift; ``resync`` squares them)."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.size == 0:
            return np.empty(0, np.int32)
        keys = pair_keys(src, dst)
        out = self.table.get(keys)
        miss = out < 0
        if miss.any():
            out[miss] = (splitmix64(keys[miss] + np.uint64(self.seed))
                         % np.uint64(self.n_parts)).astype(np.int32)
        return out

    def route_preview(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Where ``route_adds`` *would currently* place each pair, without
        committing anything (DeltaBuffer part-counting)."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.size == 0:
            return np.empty(0, np.int32)
        keys = pair_keys(src, dst)
        out = self.table.get(keys)
        unknown = np.nonzero(out < 0)[0]
        if unknown.size:
            lo = np.minimum(src, dst)
            hi = np.maximum(src, dst)
            sel = np.minimum(lo[unknown], self.n_vertices - 1)
            seh = np.minimum(hi[unknown], self.n_vertices - 1)
            out[unknown] = self._score_block(sel, seh)
        return out

    # ------------------------------------------------------------------ #
    def apply_moves(self, pg, move_src: np.ndarray, move_dst: np.ndarray,
                    new_parts: np.ndarray) -> None:
        """Record a rebalancer migration (pair -> new partition) and resync
        the load counters/replica sets from the realized graph."""
        if np.asarray(move_src).size:
            self.table.put(pair_keys(np.asarray(move_src, np.int64),
                                     np.asarray(move_dst, np.int64)),
                           np.asarray(new_parts, np.int32))
        self.resync(pg)

    def resync(self, pg) -> None:
        """Re-read the exact per-partition loads and replica sets from a
        ``PartitionedGraph`` (post-migration, or after delete-heavy churn
        has drifted the streaming counters)."""
        self.grow(pg.n_vertices)
        self.replicas[:] = 0
        for p in range(pg.n_parts):
            members = pg.gvid[p][pg.vmask[p]]
            if members.size:
                np.bitwise_or.at(
                    self.replicas, (members, self._word[p]),
                    _ONE << self._bit[p])
        self.replica_load = pg.vertices_per_part.astype(np.int64).copy()
        self.edge_load = pg.edges_per_part.astype(np.int64).copy()
        self.total_edges = int(pg.n_edges)

    # ------------------------------------------------------------------ #
    def checkpoint(self) -> dict:
        """Full state snapshot (plain numpy arrays + scalars — picklable).
        ``from_checkpoint(blob)`` resumes the stream bit-identically."""
        keys, parts = self.table.snapshot()
        return dict(
            name=self.name, n_parts=self.n_parts, n_vertices=self.n_vertices,
            seed=self.seed, alpha=self.cfg.alpha, beta=self.cfg.beta,
            block=self.cfg.block, replicas=self.replicas.copy(),
            edge_load=self.edge_load.copy(),
            replica_load=self.replica_load.copy(),
            total_edges=self.total_edges, table_keys=keys, table_parts=parts)

    @classmethod
    def from_checkpoint(cls, blob: dict) -> "EBVRouterState":
        st = cls(blob["n_parts"], blob["n_vertices"], seed=blob["seed"],
                 cfg=EBVConfig(alpha=blob["alpha"], beta=blob["beta"],
                               block=blob["block"]))
        st.replicas = np.asarray(blob["replicas"], np.uint64).copy()
        st.edge_load = np.asarray(blob["edge_load"], np.int64).copy()
        st.replica_load = np.asarray(blob["replica_load"], np.int64).copy()
        st.total_edges = int(blob["total_edges"])
        st.table = _PairTable(blob["table_keys"], blob["table_parts"])
        return st


class RelocationOverlay:
    """Sticky relocation table over a pure chunk router.

    Installed by ``execute_rebalance`` on a *stateless* ``StreamContext``:
    migrated pairs are pinned to their new partition in an exact table,
    everything else keeps routing through the frozen base hash — so deletes
    and re-adds of moved edges still find the resident copies, and
    unmigrated traffic stays bit-identical to the pure-hash contract."""

    name = "relocation-overlay"

    def __init__(self, base_route):
        self._base = base_route      # (src, dst) -> int32[chunk]
        self.table = _PairTable()

    def _route(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.size == 0:
            return np.empty(0, np.int32)
        out = self.table.get(pair_keys(src, dst))
        miss = out < 0
        if miss.any():
            out[miss] = np.asarray(self._base(src[miss], dst[miss]),
                                   np.int32)
        return out

    # moved pairs route identically on every path
    route_adds = _route
    route_deletes = _route
    route_preview = _route

    def grow(self, n_vertices: int) -> None:
        pass                         # the base hash owns the id space

    def apply_moves(self, pg, move_src, move_dst, new_parts) -> None:
        del pg
        if np.asarray(move_src).size:
            self.table.put(pair_keys(np.asarray(move_src, np.int64),
                                     np.asarray(move_dst, np.int64)),
                           np.asarray(new_parts, np.int32))

    def checkpoint(self) -> dict:
        keys, parts = self.table.snapshot()
        return dict(name=self.name, table_keys=keys, table_parts=parts)


def ebv_vertex_cut(g: Graph, n_parts: int, *, seed: int = 0,
                   cfg: EBVConfig | None = None,
                   state_out: list | None = None) -> np.ndarray:
    """One-shot EBV vertex-cut over an in-memory ``Graph`` — streams the
    edge list through a fresh ``EBVRouterState`` in storage order (the same
    order ``partition_and_build`` and a single-chunk ingest would use, so
    the two paths agree bit-for-bit). Pass ``state_out=[]`` to also receive
    the final router state (``GraphSession.from_graph`` attaches it to the
    session's ``StreamContext``)."""
    state = EBVRouterState(n_parts, g.n_vertices, seed=seed, cfg=cfg)
    part = state.route_adds(g.src, g.dst)
    if state_out is not None:
        state_out.append(state)
    return part
