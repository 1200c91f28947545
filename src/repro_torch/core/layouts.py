"""Engine-facing edge-compute layouts: stacked [P, ...] tile/window
decompositions of a ``PartitionedGraph``'s per-partition adjacencies,
feeding the CUDA semiring kernels (``repro_torch.kernels``) from inside the
BSP sweep.

  - **stacked + padded** — per-partition quantities are padded to a shared
    capacity (``t_max`` tiles, ``b_max`` edge blocks), so the simulator
    flattens all P partitions into a single kernel launch (tile/window ids
    offset by ``p * n_dst_tiles``). Padding tiles hold the semiring identity
    and point at the last dst tile (keeping the dst-major sort); padding
    blocks point at the last window.
  - **program-independent geometry, per-program realization** — the
    edge -> tile/slot assignment depends only on the graph and is built
    once; dense tile *values* depend on the program's ``SemiringSweep``
    (semiring x edge-value map x dtype) and are realized lazily per key.
    Window layouts bake no values (messages are computed in the sweep).
  - **ShapePolicy-bucketed capacities** — ``t_max``/``b_max`` land on the
    policy's buckets, as ``v_max``/``e_max`` do, and only grow under a
    delta.

Layout invariants the kernels rely on: tile lists are (dst, src)-sorted per
partition with every dst tile row covered at least once; ``bwin`` is
ascending and covers every window; padded edge slots are ``-1``; values at
padded positions are the semiring/combiner identity. Host arrays are
bit-identical to the JAX package's layouts.

The device form (``device_tiles`` / ``device_windows``) is NOT padded: it
is the flat list of the real tiles / blocks of all P partitions
(partition p's first ``n_tiles[p]`` tiles and ``n_blocks[p]`` blocks, ids
offset by ``p * n_dst_tiles`` / ``p * n_windows``), with each edge's slot
remapped into the compact message buffer and the kernels' chunk plans —
all computed once per layout, so a sweep feeds the kernels no padding.
With ``parts=`` (``edge_backend='auto'``) the list holds only the listed
partitions, renumbered to their position in the group, with a chunk plan
of its own over ``len(parts)`` partitions' rows; it is built from those
partitions' geometry alone, and only their tile values are realized (as
compact per-partition arrays when no full realization exists — at kron-20
the full ``[P, t_max, 128, 128]`` stack would be ~1 TB). The ``'auto'``
tile density comes from the geometry too (``geometric_density``: the
distinct (tile, row, col) positions of each partition's edges), so it needs
no realization at all.

The ``shard_map`` backend with ``edge_axes`` splits each partition's edge
columns into ``S`` contiguous chunks of ``e_max / S`` (one per edge shard)
and gives every (partition, shard) its own tile and window geometry
(``_sharded_geometry``, array for array the reference's: per-shard
coverage fillers, shard-local slots, grow-only per-shard caps
``_shard_caps``). A rank's device list (``device_tiles_sharded`` /
``device_windows_sharded``) is the compact list of its own (partition,
shard) with a chunk plan of its own; a shard with no edge is all fillers.

Under streaming (``repro_torch.stream``) the host rows are refreshed in
place: ``rebuild_partitions`` rebuilds the partitions a delta patched and
``sync_capacity`` column-grows the per-edge arrays; both drop every device
list (a stale list would have the kernels read the graph as it was before
the flush) and the sharded geometry, and the next kernel query builds the
compact list and its chunk plans anew. A ``v_max`` change rebuilds the
whole layout as a new object.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import unique_sorted
from repro_torch.kernels.bsp_spmv import TM, TN, plan_tiles
from repro_torch.kernels.chunks import ChunkPlan
from repro_torch.kernels.ref import tile_pad_identity, torch_dtype
from repro_torch.kernels.segment_combine import W, plan_windows

__all__ = ["EdgeLayouts", "TileBlock", "WindowBlock", "build_edge_layouts",
           "EDGE_VALUE_KINDS"]

EDGE_VALUE_KINDS = ("weight", "zero", "one")
DEFAULT_BLOCK_EDGES = 512


class TileBlock(NamedTuple):
    """Device tensors for the ``pallas_tiles`` backend: the real tiles of
    all partitions, T = sum(n_tiles), dst-major sorted."""
    tiles: torch.Tensor      # [T, TM, TN] program dtype
    tile_dst: torch.Tensor   # [T] int32, p * n_dst_tiles + local dst tile
    tile_src: torch.Tensor   # [T] int32, p * n_src_tiles + local src tile
    plan: ChunkPlan          # bsp_spmv's chunk plan of tile_dst


class WindowBlock(NamedTuple):
    """Device tensors for the ``pallas_windows`` backend: the real blocks of
    all partitions, B = sum(n_blocks), window-sorted."""
    slot: torch.Tensor       # [P * e_max] int64 buffer row per edge
                             # (padding edges: the dump row B * Be)
    ldst: torch.Tensor       # [B * Be] int32 dst row within the window
    bwin: torch.Tensor       # [B] int32, p * n_windows + local window
    plan: ChunkPlan          # segment_combine's chunk plan of bwin


def _edge_values(kind: str, ew: np.ndarray, dtype) -> np.ndarray:
    """What each edge contributes to the semiring product (SSSP relaxes by
    the weight, CC propagates over 0-weight edges, PageRank pushes
    unweighted)."""
    if kind == "weight":
        return ew.astype(dtype)
    if kind == "zero":
        return np.zeros(ew.shape[0], dtype)
    if kind == "one":
        return np.ones(ew.shape[0], dtype)
    raise ValueError(f"unknown edge-value kind {kind!r}; "
                     f"expected one of {EDGE_VALUE_KINDS}")


def _flatten(a: np.ndarray, counts: np.ndarray, step: int = 0) -> np.ndarray:
    """The first ``counts[p]`` entries of each row ``a[p]``, plus
    ``p * step``, concatenated over p (int32)."""
    return np.concatenate([a[p, :counts[p]] + p * step
                           for p in range(a.shape[0])]).astype(np.int32)


def _tile_geometry(ls, ld, ndt: int, nst: int):
    """(local src, local dst) -> (tile_dst, tile_src, edge_tile, r, c).

    Tile list sorted (dst, src)-major with identity fillers covering every
    dst tile row; ``edge_tile[e]`` indexes the final sorted list."""
    key = (ld.astype(np.int64) // TM) * nst + (ls.astype(np.int64) // TN)
    uniq = unique_sorted(key)
    covered = np.zeros(ndt, bool)
    covered[(uniq // nst).astype(np.int64)] = True
    missing = np.nonzero(~covered)[0]
    T = uniq.shape[0] + missing.shape[0]

    tile_dst = np.zeros(T, np.int32)
    tile_src = np.zeros(T, np.int32)
    tile_dst[:uniq.shape[0]] = (uniq // nst).astype(np.int32)
    tile_src[:uniq.shape[0]] = (uniq % nst).astype(np.int32)
    tile_dst[uniq.shape[0]:] = missing.astype(np.int32)

    final = np.lexsort((tile_src, tile_dst))
    inv = np.empty(T, np.int64)
    inv[final] = np.arange(T)
    edge_tile = inv[np.searchsorted(uniq, key)].astype(np.int32)
    return (tile_dst[final], tile_src[final], edge_tile,
            (ld % TM).astype(np.int32), (ls % TN).astype(np.int32))


def _window_geometry(ld, nw: int, Be: int):
    """Ascending-dst local edges -> (eslot, ldst, bwin, n_blocks)."""
    win = ld.astype(np.int64) // W
    counts = np.bincount(win, minlength=nw)
    blocks = np.maximum(-(-counts // Be), 1)          # >= 1 block per window
    n_blocks = int(blocks.sum())
    bwin = np.repeat(np.arange(nw, dtype=np.int32), blocks)
    woff = np.concatenate([[0], np.cumsum(blocks)])[:-1] * Be
    estart = np.concatenate([[0], np.cumsum(counts)])[:-1]
    eslot = (woff[win] + (np.arange(ld.shape[0]) - estart[win])).astype(
        np.int32)
    ldst = np.zeros(n_blocks * Be, np.int32)
    ldst[eslot] = (ld % W).astype(np.int32)
    return eslot, ldst, bwin, n_blocks


@dataclasses.dataclass
class EdgeLayouts:
    """Host-side stacked layout state attached to a ``PartitionedGraph``
    (``PartitionedGraph.ensure_edge_layouts``). All arrays are numpy; the
    ``device_tiles``/``device_windows`` accessors return cached tensors on
    the requested device."""

    n_parts: int
    v_max: int
    e_max: int
    t_max: int                    # padded tiles per partition (bucketed)
    b_max: int                    # padded edge blocks per partition
    block_edges: int
    policy: object                # ShapePolicy governing t_max/b_max

    tile_dst: np.ndarray          # [P, t_max] int32
    tile_src: np.ndarray          # [P, t_max] int32
    n_tiles: np.ndarray           # [P] int64 real (content) tiles
    edge_tile: np.ndarray         # [P, e_max] int32 (-1 = padding edge)
    edge_r: np.ndarray            # [P, e_max] int32 row within tile
    edge_c: np.ndarray            # [P, e_max] int32 col within tile
    eslot: np.ndarray             # [P, e_max] int32 (-1 = padding edge)
    ldst: np.ndarray              # [P, b_max*Be] int32
    bwin: np.ndarray              # [P, b_max] int32
    n_blocks: np.ndarray          # [P] int64 real blocks

    _tiles: Dict[Tuple, np.ndarray] = dataclasses.field(default_factory=dict)
    _filled: Dict[Tuple, np.ndarray] = dataclasses.field(
        default_factory=dict)             # [P] non-identity entries per part
    _density: Dict[Tuple, float] = dataclasses.field(default_factory=dict)
    _device: Dict[Tuple, object] = dataclasses.field(default_factory=dict)
    # compact [n_tiles[p], TM, TN] values of single partitions, per
    # realization key, where no full stack was realized (group lists)
    _part_tiles: Dict[Tuple, Dict[int, np.ndarray]] = dataclasses.field(
        default_factory=dict)
    # [P] distinct (tile, row, col) positions of each partition's edges
    # (-1: not counted since the partition was last built)
    _positions: Optional[np.ndarray] = None
    # edge-sharded geometry per shard count S (rebuilt on any graph change)
    # and its per-shard caps S -> (t_loc, b_loc), grow-only across rebuilds
    _shard_geom: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    _shard_caps: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)

    @property
    def n_dst_tiles(self) -> int:
        return max(-(-self.v_max // TM), 1)

    @property
    def n_src_tiles(self) -> int:
        return max(-(-self.v_max // TN), 1)

    @property
    def n_windows(self) -> int:
        return max(-(-self.v_max // W), 1)

    def shape_key(self, backend: str, n_shards: int = 1, pg=None) -> tuple:
        """What a runner is additionally specialized to on a kernel
        backend — joins the session's padded-shape key. ``n_shards > 1``
        keys the edge-sharded variant by its per-shard caps (``pg``
        required)."""
        if n_shards > 1:
            if pg is None:
                raise ValueError("a sharded shape_key needs the graph")
            self._sharded_geometry(pg, n_shards)
            t_loc, b_loc = self._shard_caps[int(n_shards)]
            if backend == "pallas_tiles":
                return ("tiles", int(n_shards), t_loc, self.n_dst_tiles,
                        self.n_src_tiles)
            return ("windows", int(n_shards), b_loc, self.block_edges,
                    self.n_windows)
        if backend == "pallas_tiles":
            return ("tiles", self.t_max, self.n_dst_tiles, self.n_src_tiles)
        return ("windows", self.b_max, self.block_edges, self.n_windows)

    # ------------------------------------------------------------------ #
    # realization: dense tile values per (semiring, edge-value map, dtype)
    # ------------------------------------------------------------------ #
    def _realize_tiles(self, pg, key, parts: Optional[Iterable[int]] = None):
        """Realize (or, with ``parts``, re-realize only those partitions'
        rows of) the dense tile values of one (semiring, edge-value map,
        dtype) key."""
        semiring, kind, dtype_str = key
        dtype = np.dtype(dtype_str)
        # tile contents are ADDED to values under min_plus: integer dtypes
        # pad with the wrap-safe halved identity (kernels/ref.py)
        ident = tile_pad_identity(semiring, dtype)
        tiles = self._tiles.get(key)
        if tiles is None or parts is None:
            tiles = np.full((self.n_parts, self.t_max, TM, TN), ident, dtype)
            parts = range(self.n_parts)
            self._tiles[key] = tiles
            self._part_tiles.pop(key, None)     # the stack supersedes them
            self._filled[key] = np.zeros(self.n_parts, np.int64)
        filled = self._filled[key]
        for p in parts:
            tiles[p] = ident
            self._fill_partition(pg, key, p, tiles[p])
            # per partition, so a partial rebuild never rescans the
            # untouched partitions' tiles to refresh the density
            filled[p] = int((tiles[p] != ident).sum())
        self._density[key] = int(filled.sum()) / max(
            int(self.n_tiles.sum()) * TM * TN, 1)
        return tiles

    def _fill_partition(self, pg, key, p: int, out: np.ndarray) -> None:
        """Combine partition ``p``'s edge values into ``out`` (its tiles,
        identity-filled by the caller)."""
        semiring, kind, dtype_str = key
        valid = self.edge_tile[p] >= 0
        vals = _edge_values(kind, pg.ew[p][valid], np.dtype(dtype_str))
        idx = (self.edge_tile[p][valid], self.edge_r[p][valid],
               self.edge_c[p][valid])
        if semiring == "plus_times":
            np.add.at(out, idx, vals)
        else:
            np.minimum.at(out, idx, vals)

    def _partition_values(self, pg, key, p: int) -> np.ndarray:
        """Partition ``p``'s real tiles' values [n_tiles[p], TM, TN]: a view
        of the full realization when there is one, else realized for this
        partition alone (and cached until a rebuild touches it)."""
        nt = int(self.n_tiles[p])
        if key in self._tiles:
            return self._tiles[key][p, :nt]
        cache = self._part_tiles.setdefault(key, {})
        vals = cache.get(p)
        if vals is None:
            dtype = np.dtype(key[2])
            vals = np.full((nt, TM, TN), tile_pad_identity(key[0], dtype),
                           dtype)
            self._fill_partition(pg, key, p, vals)
            cache[p] = vals
        return vals

    def tile_values(self, pg, semiring: str, kind: str, dtype) -> np.ndarray:
        key = (semiring, kind, np.dtype(dtype).str)
        if key not in self._tiles:
            self._realize_tiles(pg, key)
        return self._tiles[key]

    def density(self, pg, semiring: str, kind: str, dtype) -> float:
        """Fraction of non-identity entries across the real tiles."""
        key = (semiring, kind, np.dtype(dtype).str)
        if key not in self._density:
            self._realize_tiles(pg, key)
        return self._density[key]

    def partition_density(self, pg, semiring: str, kind: str,
                          dtype) -> np.ndarray:
        """[P] per-partition tile density."""
        key = (semiring, kind, np.dtype(dtype).str)
        if key not in self._filled:
            self._realize_tiles(pg, key)
        denom = np.maximum(self.n_tiles * (TM * TN), 1).astype(np.float64)
        return self._filled[key].astype(np.float64) / denom

    def partition_positions(self) -> np.ndarray:
        """[P] distinct (tile, row, col) positions of each partition's
        edges: its tiles' non-identity entries whenever no combined value
        lands on the identity, counted from the geometry alone."""
        if self._positions is None:
            self._positions = np.full(self.n_parts, -1, np.int64)
        for p in np.nonzero(self._positions < 0)[0]:
            et = self.edge_tile[p]
            valid = et >= 0
            pos = ((et[valid].astype(np.int64) * TM + self.edge_r[p][valid])
                   * TN + self.edge_c[p][valid])
            self._positions[p] = unique_sorted(pos).shape[0]
        return self._positions

    def geometric_density(self) -> Tuple[float, np.ndarray]:
        """``(density, [P] partition density)`` of the real tiles from
        ``partition_positions``: ``density``/``partition_density`` without
        realizing any tile value."""
        pos = self.partition_positions()
        denom = np.maximum(self.n_tiles * (TM * TN), 1).astype(np.float64)
        return (int(pos.sum()) / max(int(self.n_tiles.sum()) * TM * TN, 1),
                pos.astype(np.float64) / denom)

    # ------------------------------------------------------------------ #
    # device tensors (cached per device and partition group)
    # ------------------------------------------------------------------ #
    def _group(self, parts) -> Optional[Tuple[int, ...]]:
        if parts is None:
            return None
        parts = tuple(int(p) for p in parts)
        if not parts or list(parts) != sorted(set(parts)) \
                or parts[0] < 0 or parts[-1] >= self.n_parts:
            raise ValueError(f"parts must be ascending distinct partitions "
                             f"of [0, {self.n_parts}), got {parts}")
        return parts

    def device_tiles(self, pg, semiring: str, kind: str, dtype,
                     device, parts=None) -> TileBlock:
        """The compact tile list on ``device`` (cached per device): of all
        partitions, or of the ascending group ``parts`` only, with tile ids
        offset by the partition's position in the group."""
        dev = torch.device(device)
        group = self._group(parts)
        key = ("tiles", semiring, kind, np.dtype(dtype).str, str(dev), group)
        blk = self._device.get(key)
        if blk is None:
            vkey = (semiring, kind, np.dtype(dtype).str)
            if group is None:
                self.tile_values(pg, semiring, kind, dtype)
            idx = list(range(self.n_parts)) if group is None else list(group)
            nt = self.n_tiles[idx].astype(np.int64)
            off = np.concatenate([[0], np.cumsum(nt)])
            tiles = torch.empty((int(off[-1]), TM, TN),
                                dtype=torch_dtype(np.dtype(dtype)),
                                device=dev)
            for g, p in enumerate(idx):        # no compact host copy
                tiles[off[g]:off[g + 1]] = torch.from_numpy(
                    self._partition_values(pg, vkey, p)).to(dev)
            tile_dst = torch.from_numpy(
                _flatten(self.tile_dst[idx], nt, self.n_dst_tiles)).to(dev)
            blk = TileBlock(
                tiles=tiles, tile_dst=tile_dst,
                tile_src=torch.from_numpy(
                    _flatten(self.tile_src[idx], nt, self.n_src_tiles))
                .to(dev),
                plan=plan_tiles(tile_dst, len(idx) * self.n_dst_tiles))
            self._device[key] = blk
        return blk

    def device_windows(self, device, parts=None) -> WindowBlock:
        """The compact block list on ``device`` (cached per device): of all
        partitions, or of the ascending group ``parts`` only (window ids
        offset by the partition's position in the group, ``slot`` over the
        group's ``[len(parts) * e_max]`` edges)."""
        dev = torch.device(device)
        group = self._group(parts)
        key = ("windows", str(dev), group)
        blk = self._device.get(key)
        if blk is None:
            Be, nw = self.block_edges, self.n_windows
            idx = list(range(self.n_parts)) if group is None else list(group)
            nb = self.n_blocks[idx].astype(np.int64)
            row0 = (np.concatenate([[0], np.cumsum(nb)])[:-1] * Be)[:, None]
            dump = int(nb.sum()) * Be
            eslot = self.eslot[idx]
            slot = np.where(eslot >= 0, eslot + row0, dump)
            bwin = torch.from_numpy(_flatten(self.bwin[idx], nb, nw)).to(dev)
            blk = WindowBlock(
                slot=torch.from_numpy(slot.reshape(-1).astype(np.int64))
                .to(dev),
                ldst=torch.from_numpy(
                    _flatten(self.ldst[idx], nb * Be)).to(dev),
                bwin=bwin, plan=plan_windows(bwin, len(idx) * nw))
            self._device[key] = blk
        return blk

    # ------------------------------------------------------------------ #
    # edge-sharded geometry (shard_map with edge_axes)
    # ------------------------------------------------------------------ #
    def _sharded_geometry(self, pg, n_shards: int) -> Dict:
        """Per-(partition, shard) tile/window geometry over the ``n_shards``
        contiguous ``e_max / n_shards`` column chunks of the edge arrays.
        A partition's valid edges ascend by dst along the columns, so each
        chunk's valid subset does too and the per-partition builders apply
        unchanged. Each shard gets its own coverage fillers and shard-local
        slot ids; the caps ``t_loc`` / ``b_loc`` are shared, bucketed and
        grow-only, so the stacked arrays split evenly: tile_dst/tile_src
        [P, S*t_loc], bwin [P, S*b_loc], ldst [P, S*b_loc*Be], eslot
        [P, e_max] (shard-local), edge_tile [P, e_max] (into the [S*t_loc]
        list), n_tiles/n_blocks [P, S]. The reference's arrays, array for
        array."""
        S = int(n_shards)
        geom = self._shard_geom.get(S)
        if geom is not None:
            return geom
        if self.e_max % S:
            raise ValueError(f"e_max={self.e_max} must divide by n_shards="
                             f"{S}; pad edges to a multiple of the edge "
                             "axes")
        Se = self.e_max // S
        ndt, nst, nw = self.n_dst_tiles, self.n_src_tiles, self.n_windows
        Be = self.block_edges
        P = self.n_parts

        per = []                       # (p, s) -> geometry pieces
        need_t = need_b = 1
        for p in range(P):
            m = pg.emask[p]
            for s in range(S):
                cols = slice(s * Se, (s + 1) * Se)
                ms = m[cols]
                ls, ld = pg.esrc[p][cols][ms], pg.edst[p][cols][ms]
                td, ts, et, er, ec = _tile_geometry(ls, ld, ndt, nst)
                es, ldst, bw, nb = _window_geometry(ld, nw, Be)
                per.append((np.nonzero(ms)[0] + s * Se, td, ts, et, er, ec,
                            es, ldst, bw, nb))
                need_t = max(need_t, td.shape[0])
                need_b = max(need_b, nb)
        prev_t, prev_b = self._shard_caps.get(S, (0, 0))
        t_loc = max(prev_t, self.policy.bucket(need_t))
        b_loc = max(prev_b, self.policy.bucket(need_b))
        self._shard_caps[S] = (t_loc, b_loc)

        geom = dict(
            n_shards=S, t_loc=t_loc, b_loc=b_loc,
            tile_dst=np.full((P, S * t_loc), ndt - 1, np.int32),
            tile_src=np.full((P, S * t_loc), nst - 1, np.int32),
            edge_tile=np.full((P, self.e_max), -1, np.int32),
            edge_r=np.zeros((P, self.e_max), np.int32),
            edge_c=np.zeros((P, self.e_max), np.int32),
            eslot=np.full((P, self.e_max), -1, np.int32),
            ldst=np.zeros((P, S * b_loc * Be), np.int32),
            bwin=np.full((P, S * b_loc), nw - 1, np.int32),
            n_tiles=np.zeros((P, S), np.int64),
            n_blocks=np.zeros((P, S), np.int64),
        )
        it = iter(per)
        for p in range(P):
            for s in range(S):
                cols, td, ts, et, er, ec, es, ldst, bw, nb = next(it)
                T = td.shape[0]
                t0, b0 = s * t_loc, s * b_loc
                geom["tile_dst"][p, t0:t0 + T] = td
                geom["tile_src"][p, t0:t0 + T] = ts
                geom["n_tiles"][p, s] = T
                geom["edge_tile"][p, cols] = et + t0
                geom["edge_r"][p, cols] = er
                geom["edge_c"][p, cols] = ec
                geom["eslot"][p, cols] = es        # shard-local slot ids
                geom["ldst"][p, b0 * Be:b0 * Be + ldst.shape[0]] = ldst
                geom["bwin"][p, b0:b0 + nb] = bw
                geom["n_blocks"][p, s] = nb
        self._shard_geom[S] = geom
        return geom

    def shard_counts(self, pg, n_shards: int) -> Dict:
        """The ``n_shards`` geometry's counts: ``n_tiles`` and ``n_blocks``
        [P, S] per (partition, shard) list, coverage fillers included, and
        the shared per-shard caps ``t_loc`` / ``b_loc``."""
        g = self._sharded_geometry(pg, n_shards)
        return {k: g[k] for k in ("n_tiles", "n_blocks", "t_loc", "b_loc")}

    def drop_sharded(self) -> None:
        """Drop every edge-sharded geometry and its device lists (the
        grow-only caps stay); the next sharded use builds them anew."""
        self._shard_geom.clear()
        self._device = {k: v for k, v in self._device.items()
                        if k[0] not in ("tiles_sharded", "windows_sharded")}

    def device_tiles_sharded(self, pg, semiring: str, kind: str, dtype,
                             n_shards: int, device, part: int,
                             shard: int) -> TileBlock:
        """The compact tile list of one (partition, shard) on ``device``
        (cached): its ``n_tiles[part, shard]`` tiles, fillers included,
        with their values realized from that shard's edges alone and a
        chunk plan over one partition's dst tiles."""
        S, dev = int(n_shards), torch.device(device)
        key = ("tiles_sharded", S, int(part), int(shard), semiring, kind,
               np.dtype(dtype).str, str(dev))
        blk = self._device.get(key)
        if blk is None:
            g = self._sharded_geometry(pg, S)
            dt = np.dtype(dtype)
            Se = self.e_max // S
            t0 = int(shard) * g["t_loc"]
            T = int(g["n_tiles"][part, shard])
            cols = slice(int(shard) * Se, (int(shard) + 1) * Se)
            et = g["edge_tile"][part, cols]
            valid = et >= 0
            vals = np.full((T, TM, TN), tile_pad_identity(semiring, dt), dt)
            idx = (et[valid] - t0, g["edge_r"][part, cols][valid],
                   g["edge_c"][part, cols][valid])
            ev = _edge_values(kind, pg.ew[part][cols][valid], dt)
            if semiring == "plus_times":
                np.add.at(vals, idx, ev)
            else:
                np.minimum.at(vals, idx, ev)
            tile_dst = torch.from_numpy(np.ascontiguousarray(
                g["tile_dst"][part, t0:t0 + T])).to(dev)
            blk = TileBlock(
                tiles=torch.from_numpy(vals).to(dev), tile_dst=tile_dst,
                tile_src=torch.from_numpy(np.ascontiguousarray(
                    g["tile_src"][part, t0:t0 + T])).to(dev),
                plan=plan_tiles(tile_dst, self.n_dst_tiles))
            self._device[key] = blk
        return blk

    def device_windows_sharded(self, pg, n_shards: int, device, part: int,
                               shard: int) -> WindowBlock:
        """The compact block list of one (partition, shard) on ``device``
        (cached): its ``n_blocks[part, shard]`` blocks, ``slot`` over the
        shard's ``e_max / n_shards`` edge columns (padding edges: the dump
        row), and a chunk plan over one partition's windows."""
        S, dev = int(n_shards), torch.device(device)
        key = ("windows_sharded", S, int(part), int(shard), str(dev))
        blk = self._device.get(key)
        if blk is None:
            g = self._sharded_geometry(pg, S)
            Se, Be = self.e_max // S, self.block_edges
            nb = int(g["n_blocks"][part, shard])
            b0 = int(shard) * g["b_loc"]
            es = g["eslot"][part, int(shard) * Se:(int(shard) + 1) * Se]
            slot = np.where(es >= 0, es, nb * Be).astype(np.int64)
            bwin = torch.from_numpy(np.ascontiguousarray(
                g["bwin"][part, b0:b0 + nb])).to(dev)
            blk = WindowBlock(
                slot=torch.from_numpy(slot).to(dev),
                ldst=torch.from_numpy(np.ascontiguousarray(
                    g["ldst"][part, b0 * Be:(b0 + nb) * Be])).to(dev),
                bwin=bwin, plan=plan_windows(bwin, self.n_windows))
            self._device[key] = blk
        return blk

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #
    def flops_per_sweep(self, backend: str, K: int, n_shards: int = 1,
                        pg=None) -> np.ndarray:
        """[P] semiring ops one local sweep costs per partition: the dense
        work the kernels issue, identity padding inside real tiles/blocks
        included; ``n_shards > 1`` bills every shard's list, its coverage
        fillers included (``pg`` required)."""
        if n_shards > 1:
            g = self._sharded_geometry(pg, n_shards)
            if backend == "pallas_tiles":
                return (g["n_tiles"].sum(axis=1)
                        * (2 * TM * TN * K)).astype(np.int64)
            return (g["n_blocks"].sum(axis=1)
                    * (2 * W * self.block_edges * K)).astype(np.int64)
        if backend == "pallas_tiles":
            return (self.n_tiles * (2 * TM * TN * K)).astype(np.int64)
        return (self.n_blocks * (2 * W * self.block_edges * K)).astype(
            np.int64)

    # ------------------------------------------------------------------ #
    # build
    # ------------------------------------------------------------------ #
    def _build_partition(self, pg, p: int):
        """Compute partition ``p``'s geometry rows (caps must fit)."""
        m = pg.emask[p]
        ls, ld = pg.esrc[p][m], pg.edst[p][m]
        ne = ls.shape[0]
        ndt, nst, nw = self.n_dst_tiles, self.n_src_tiles, self.n_windows
        td, ts, et, er, ec = _tile_geometry(ls, ld, ndt, nst)
        T = td.shape[0]
        self.tile_dst[p] = ndt - 1       # padding tiles: last dst row
        self.tile_src[p] = nst - 1
        self.tile_dst[p, :T] = td
        self.tile_src[p, :T] = ts
        self.n_tiles[p] = T
        self.edge_tile[p] = -1
        self.edge_r[p] = 0
        self.edge_c[p] = 0
        self.edge_tile[p, :ne] = et
        self.edge_r[p, :ne] = er
        self.edge_c[p, :ne] = ec
        if self._positions is not None:
            self._positions[p] = -1

        es, ldst, bw, nb = _window_geometry(ld, nw, self.block_edges)
        self.eslot[p] = -1
        self.eslot[p, :ne] = es
        self.ldst[p] = 0
        self.ldst[p, :ldst.shape[0]] = ldst
        self.bwin[p] = nw - 1            # padding blocks: last window
        self.bwin[p, :nb] = bw
        self.n_blocks[p] = nb

    def _partition_caps(self, pg, p: int) -> Tuple[int, int]:
        """(tiles, blocks) partition ``p`` needs at the current shapes."""
        m = pg.emask[p]
        ls, ld = pg.esrc[p][m], pg.edst[p][m]
        nst, nw = self.n_src_tiles, self.n_windows
        key = (ld.astype(np.int64) // TM) * nst + (ls.astype(np.int64) // TN)
        uniq = unique_sorted(key)
        covered = np.zeros(self.n_dst_tiles, bool)
        covered[(uniq // nst).astype(np.int64)] = True
        T = uniq.shape[0] + int((~covered).sum())
        counts = np.bincount(ld.astype(np.int64) // W, minlength=nw)
        B = int(np.maximum(-(-counts // self.block_edges), 1).sum())
        return T, B

    def _grow_caps(self, need_t: int, need_b: int) -> bool:
        """Grow ``t_max``/``b_max`` to the policy bucket (grow-only, like
        ``e_max`` under a delta). Returns True if anything grew."""
        grew = False
        if need_t > self.t_max:
            new_t = max(self.t_max, self.policy.bucket(need_t))
            pad = new_t - self.t_max
            self.tile_dst = np.concatenate(
                [self.tile_dst, np.full((self.n_parts, pad),
                                        self.n_dst_tiles - 1, np.int32)], 1)
            self.tile_src = np.concatenate(
                [self.tile_src, np.full((self.n_parts, pad),
                                        self.n_src_tiles - 1, np.int32)], 1)
            for key, tiles in list(self._tiles.items()):
                # the pad of the realization's own semiring and dtype (the
                # halved iinfo.max for integer min_plus), never the
                # combiner identity
                ident = tile_pad_identity(key[0], np.dtype(key[2]))
                self._tiles[key] = np.concatenate(
                    [tiles, np.full((self.n_parts, pad, TM, TN), ident,
                                    tiles.dtype)], 1)
            self.t_max = new_t
            grew = True
        if need_b > self.b_max:
            new_b = max(self.b_max, self.policy.bucket(need_b))
            pad = new_b - self.b_max
            self.bwin = np.concatenate(
                [self.bwin, np.full((self.n_parts, pad),
                                    self.n_windows - 1, np.int32)], 1)
            self.ldst = np.concatenate(
                [self.ldst, np.zeros((self.n_parts, pad * self.block_edges),
                                     np.int32)], 1)
            self.b_max = new_b
            grew = True
        return grew

    def rebuild_partitions(self, pg, parts: Iterable[int]) -> None:
        """Refresh the layout after a delta patched ``parts``
        (``stream/delta.py``): grow the bucketed caps if a patched partition
        overflows them, rebuild only the patched partitions' geometry and
        their rows of every cached tile realization (the caps are
        grow-only, so untouched rows stay valid; their single-partition
        values are dropped and realized again on use), and drop the device
        lists, group lists included, whose compact ids and chunk plans
        describe the old geometry."""
        parts = sorted(set(int(p) for p in parts))
        need_t = need_b = 0
        for p in parts:
            t, b = self._partition_caps(pg, p)
            need_t, need_b = max(need_t, t), max(need_b, b)
        self._grow_caps(need_t, need_b)
        for p in parts:
            self._build_partition(pg, p)
        for key in self._tiles:
            self._realize_tiles(pg, key, parts)
        for cache in self._part_tiles.values():
            for p in parts:
                cache.pop(p, None)
        self._device.clear()
        self.drop_sharded()         # its caps stay (grow-only)

    def sync_capacity(self, pg) -> bool:
        """Column-grow the per-edge arrays after ``e_max`` growth. Returns
        False when ``v_max`` (or P) moved: the tile/window grid moved with
        it and the caller rebuilds the whole layout. New columns are padding
        until ``rebuild_partitions`` fills them."""
        if self.n_parts != pg.n_parts or self.v_max != pg.v_max:
            return False
        if pg.e_max > self.e_max:
            pad = pg.e_max - self.e_max

            def grow(a, fill):
                return np.concatenate(
                    [a, np.full((self.n_parts, pad), fill, a.dtype)], 1)

            self.edge_tile = grow(self.edge_tile, -1)
            self.edge_r = grow(self.edge_r, 0)
            self.edge_c = grow(self.edge_c, 0)
            self.eslot = grow(self.eslot, -1)
            self.e_max = pg.e_max
            self._device.clear()
            self.drop_sharded()
        return self.e_max == pg.e_max

    def matches(self, pg) -> bool:
        """False when the graph's padded shapes moved since the build."""
        return (self.n_parts == pg.n_parts and self.v_max == pg.v_max
                and self.e_max == pg.e_max)


def build_edge_layouts(pg, policy,
                       block_edges: int = DEFAULT_BLOCK_EDGES) -> EdgeLayouts:
    """Full build for all partitions of ``pg``; capacities land on
    ``policy`` buckets."""
    P, v_max, e_max = pg.n_parts, pg.v_max, pg.e_max
    lay = EdgeLayouts(
        n_parts=P, v_max=v_max, e_max=e_max, t_max=0, b_max=0,
        block_edges=int(block_edges), policy=policy,
        tile_dst=np.zeros((P, 0), np.int32),
        tile_src=np.zeros((P, 0), np.int32),
        n_tiles=np.zeros(P, np.int64),
        edge_tile=np.full((P, e_max), -1, np.int32),
        edge_r=np.zeros((P, e_max), np.int32),
        edge_c=np.zeros((P, e_max), np.int32),
        eslot=np.full((P, e_max), -1, np.int32),
        ldst=np.zeros((P, 0), np.int32),
        bwin=np.zeros((P, 0), np.int32),
        n_blocks=np.zeros(P, np.int64),
    )
    need_t = need_b = 1
    for p in range(P):
        t, b = lay._partition_caps(pg, p)
        need_t, need_b = max(need_t, t), max(need_b, b)
    lay._grow_caps(need_t, need_b)
    for p in range(P):
        lay._build_partition(pg, p)
    return lay
