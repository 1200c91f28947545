"""GraphSession — the resident-graph query API of the port.

    sess = GraphSession.from_graph(g, n_parts=16)          # on the CUDA card
    dist, st = sess.query(SSSP(), {"source": 0})           # builds a runner
    dist, st = sess.query(SSSP(), {"source": 7})           # runner cache hit
    sess.update(adds=(src, dst, w))                        # buffered
    sess.flush()                                           # patch the host
    dist, st = sess.query(SSSP(), {"source": 0})           # re-upload, warm

The session keeps the stacked ``DeviceSubgraph`` resident on its device
across queries and caches runners keyed like the JAX package's compiled
runners: (program dataclass fields, parameter *structure*, EngineConfig,
padded shapes ``(P, v_max, e_max, slot_capacity, has_vlabel)`` plus the
kernel layout's shape key, warm-input flag). A PyTorch runner compiles
nothing, so a build is cheap, but the key keeps the reference's contract:
repeated queries and different parameter values of one structure reuse one
runner (``SessionStats.runner_builds`` counts the misses).

Each converged result of a monotone program is remembered and warm-starts
the next identical query (``warm="auto"``); cold starts of monotone programs
go through the same runner with a combiner-identity warm block.

The streaming lifecycle is the reference's: a session with a
``StreamContext`` (``from_graph`` with a pure router, ``from_edge_log``)
buffers ``update``/``push`` in a coalescing ``DeltaBuffer``; ``flush``
patches the host graph and its edge layouts (which drops their device
lists), ``compact`` shrinks the padded capacities. Both log their row remap
on a chain that each cached warm result replays on its next use; a
deleting flush drops the results whose ``warm_under`` polarity it breaks.
The device graph is uploaded again on the first query after a change, and
runners whose padded shapes or layout capacities the graph left are
dropped (``SessionStats.cache_evictions_shape``).

``edge_backend='auto'`` resolves a backend per partition from the
device's calibration table and pins the assignment per (padded shape,
layout capacity) bucket, so in-bucket streaming never flips a partition's
backend; a compaction or a rebalance clears the pin. ``from_graph(g, P,
"ebv")`` streams the edges through the EBV router and keeps its state on
the ``StreamContext``; ``rebalance="auto"|"manual"`` attaches a
``LoadMonitor`` that reads edge counts and frontier occupancy at every
graph event and each query's flops-apportioned per-partition sweep time,
and ``rebalance()`` migrates edges off overloaded partitions through the
remap chain of ``compact()`` (the JAX package's ``repro.partition``).

``query_batch`` raises ``NotImplementedError`` naming the ROADMAP item that
will port it. Only the simulator backend exists; a ``mesh`` is refused.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core.api import VertexProgram, numpy_dtype
from repro_torch.core.engine import (EngineConfig, _auto_layout_blocks,
                                     _device_subgraph, _flops_per_sweep,
                                     _layout_block_from, _warm_block,
                                     make_sim_runner, normalize_edge_backend,
                                     resolve_partition_backends, run_sim)
from repro_torch.core.graph import Graph
from repro_torch.core.metrics import ExecutionStats
from repro_torch.core.partition import (PARTITIONERS, STREAM_ROUTERS,
                                        is_stateful_router)
from repro_torch.core.subgraph import (PartitionedGraph, ShapePolicy,
                                       build_partitioned_graph)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.partition.monitor import LoadMonitor
from repro_torch.partition.rebalance import (RebalanceStats,
                                             execute_rebalance,
                                             plan_rebalance)
from repro_torch.stream.buffer import DeltaBuffer
from repro_torch.stream.delta import CompactStats, DeltaStats, EdgeDelta
from repro_torch.stream.delta import compact as _compact_pg
from repro_torch.stream.ingest import StreamContext, streaming_ingest

__all__ = ["GraphSession", "SessionStats", "ShapePolicy"]


@dataclasses.dataclass
class _WarmEntry:
    """Last converged result of one (program, params) query.

    ``global_values`` ([n_vertices(, K)], combiner identity where no master
    holds a value) survives any membership change; ``device_block``
    ([P, v_max, K] numpy) is valid at ``device_epoch`` of the session's
    remap log and is brought forward lazily on the entry's next use
    (``GraphSession._sync_warm_entry``). ``polarity`` is the program's
    ``warm_under``: the delta polarity the entry survives."""
    global_values: np.ndarray
    device_block: np.ndarray
    identity: object
    device_epoch: int = 0
    polarity: str = "inserts"

    @property
    def nbytes(self) -> int:
        return self.global_values.nbytes + self.device_block.nbytes


@dataclasses.dataclass
class SessionStats:
    """Serving-side counters across the session lifetime."""
    queries: int = 0
    cache_hits: int = 0
    runner_builds: int = 0         # runner-cache misses
    warm_queries: int = 0          # queries served from a previous result
    flushes: int = 0               # delta batches applied to the host graph
    compactions: int = 0
    uploads: int = 0               # device-graph uploads
    compile_time_total: float = 0.0
    cache_evictions_lru: int = 0   # runners dropped by max_runners
    cache_evictions_shape: int = 0  # runners dropped by a bucket change
    warm_evictions: int = 0        # warm results dropped by max_warm_entries
    warm_cache_bytes: int = 0      # host bytes of the warm-result memory
    warm_remaps_applied: int = 0   # deferred warm-block remaps replayed
    host_syncs: int = 0            # device->host reads across all queries
    rebalances: int = 0            # online migrations executed
    load_imbalance: float = 1.0    # the LoadMonitor's latest blended gauge
                                   # (1.0 when no monitor is attached)
    partition_edge_counts: list = dataclasses.field(default_factory=list)
                                   # latest per-partition resident edges
    partition_sweep_time: list = dataclasses.field(default_factory=list)
                                   # EWMA per-partition sweep seconds across
                                   # queries (the monitor's measured work)
    tile_density_min: float = 0.0  # spread of the per-partition tile
    tile_density_mean: float = 0.0  # densities of the latest tiles or
    tile_density_max: float = 0.0  # 'auto' query


class _SessionBuffer(DeltaBuffer):
    """DeltaBuffer whose flushes (manual and threshold-tripped) notify the
    owning session, so an auto-flush inside ``update`` never leaves the
    device graph, the runner cache or the warm memory stale."""

    def __init__(self, session: "GraphSession", *args, **kwargs):
        self._session = session
        super().__init__(*args, **kwargs)

    def flush(self, _auto: bool = False) -> Optional[DeltaStats]:
        st = super().flush(_auto)
        if st is not None:
            self._session._on_flush(st)
        return st


# --------------------------------------------------------------------------- #
# cache keys
# --------------------------------------------------------------------------- #
def program_key(program: VertexProgram):
    """Hashable identity of a program's static structure: its type plus every
    dataclass field. Programs with unhashable fields fall back to identity."""
    try:
        fields = tuple((f.name, getattr(program, f.name))
                       for f in dataclasses.fields(program))
        hash(fields)
        return (type(program), fields)
    except TypeError:
        return (type(program), id(program))


def _leaves(params, path=()):
    if params is None:
        return
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _leaves(params[k], path + (k,))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _leaves(v, path + (i,))
    else:
        yield path, params


def _leaf_spec(x) -> tuple:
    """(shape, canonical dtype) of a params leaf: 0-d numbers of any width
    normalize to int32 / float32 / bool, as the reference's
    ``canonical_params`` does, so caller habits never split the cache."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    if a.ndim == 0:
        if a.dtype.kind == "b":
            return (), "bool", np.asarray(bool(a))
        if a.dtype.kind in "iu":
            v = int(a)
            wide = not (-2**31 <= v < 2**31)
            dt = np.int64 if wide else np.int32
            return (), np.dtype(dt).name, np.asarray(v, dt)
        if a.dtype.kind == "f":
            return (), "float32", np.asarray(float(a), np.float32)
    return a.shape, a.dtype.name, a


def params_struct_key(params) -> tuple:
    """Structure-only key (paths + leaf shape/dtype)."""
    return tuple((p,) + _leaf_spec(v)[:2] for p, v in _leaves(params))


def params_fingerprint(params) -> tuple:
    """Value-level key: warm results are reusable only for the same query."""
    out = []
    for p, v in _leaves(params):
        shape, dt, a = _leaf_spec(v)
        out.append((p, shape, dt, np.ascontiguousarray(a).tobytes()))
    return tuple(out)


# --------------------------------------------------------------------------- #
class GraphSession:
    """Resident-graph query session over one ``PartitionedGraph`` on one
    device (``device=None``: the CUDA card; ``device="cpu"``: the plain
    PyTorch path).

    ``ctx`` (a ``StreamContext``) enables ``update``/``push``/``flush``/
    ``compact``, through a coalescing buffer bounded by
    ``max_buffer_edges``/``max_buffer_parts`` (auto-flush thresholds);
    the factory constructors provide it for pure streaming routers. A
    session without one is read-only and pads the SBS slot count exactly;
    a mutable one builds runners on the policy's bucketed slot capacity.
    ``shape_policy`` governs the padded shapes as in the reference.
    ``max_runners`` / ``max_warm_entries`` bound the runner cache and the
    warm-result memory with LRU eviction (``None`` = unbounded).

    ``rebalance="auto"`` attaches a ``LoadMonitor`` (``monitor=`` to
    configure it) whose hysteresis gauge, read at every flush, migrates
    edges off overloaded partitions when it trips; ``"manual"`` keeps the
    gauge live but only ``rebalance()`` migrates; ``"off"`` (default)
    attaches a monitor only if one is passed. ``rebalance_target`` is the
    edge balance the planner aims for."""

    def __init__(self, pg: PartitionedGraph, *,
                 ctx: Optional[StreamContext] = None, mesh=None,
                 cfg: Optional[EngineConfig] = None,
                 max_buffer_edges: Optional[int] = 4096,
                 max_buffer_parts: Optional[int] = None,
                 pad_multiple: Optional[int] = None,
                 shape_policy: Optional[ShapePolicy] = None,
                 max_runners: Optional[int] = 32,
                 max_warm_entries: Optional[int] = 64,
                 rebalance: str = "off",
                 monitor: Optional[LoadMonitor] = None,
                 rebalance_target: float = 1.05,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "the shard_map backend is not ported yet (ROADMAP Queue 1: "
                "multi-GPU backend over torch.distributed)")
        self.device = resolve_device(device)
        self.pg = pg
        self.ctx = ctx
        self.cfg = self._normalize_cfg(cfg or EngineConfig())
        self.shape_policy = self._resolve_policy(shape_policy, pad_multiple)
        self.max_runners = max_runners
        self.max_warm_entries = max_warm_entries
        if rebalance not in ("off", "auto", "manual"):
            raise ValueError(
                f"rebalance={rebalance!r}: expected 'off', 'manual' or "
                "'auto'")
        self._rebalance_mode = rebalance
        self.rebalance_target = rebalance_target
        self.monitor = monitor if monitor is not None else (
            LoadMonitor() if rebalance != "off" else None)
        self._rebalancing = False      # the auto trigger fires inside
                                       # _on_flush, and rebalance() flushes
        self.stats = SessionStats()
        self.buffer = None if ctx is None else _SessionBuffer(
            self, pg, ctx, max_edges=max_buffer_edges,
            max_parts=max_buffer_parts, shape_policy=self.shape_policy)
        self._device_graph = None
        self._device_version = -1
        self._host_version = 0         # bumped by every applied flush/compact
        self._runners: OrderedDict = OrderedDict()
        self._warm: OrderedDict = OrderedDict()
        self._identity_blocks: dict = {}
        self._auto_pin: dict = {}      # (shape, tiles, windows keys) ->
                                       # pinned 'auto' assignment
        self._keepalive: dict = {}
        self._warm_epoch = 0           # advances per layout-moving event
        self._remap_log: list = []     # [(epoch, stats with remap_state)]

    # ------------------------------------------------------------------ #
    @classmethod
    def _resolve_policy(cls, shape_policy, pad_multiple) -> ShapePolicy:
        if shape_policy is not None:
            return shape_policy
        return ShapePolicy(pad_multiple=8 if pad_multiple is None
                           else pad_multiple)

    @classmethod
    def from_graph(cls, g: Graph, n_parts: int, partitioner: str = "cdbh",
                   *, seed: int = 0, mesh=None,
                   cfg: Optional[EngineConfig] = None,
                   pad_multiple: Optional[int] = None,
                   shape_policy: Optional[ShapePolicy] = None,
                   device: DeviceLike = None,
                   **kwargs) -> "GraphSession":
        """Partition + build + open a session in one call, with the
        reference's padding choice: streamable partitioners get the bucketed
        policy and a ``StreamContext`` (so ``update`` works), the others
        exact padding and a read-only session. A stateful router (``"ebv"``)
        places the edges through the router state the context then keeps,
        so later deltas find the resident edges."""
        dev = resolve_device(device)
        if shape_policy is None and partitioner not in STREAM_ROUTERS:
            shape_policy = ShapePolicy.exact(
                8 if pad_multiple is None else pad_multiple)
        policy = cls._resolve_policy(shape_policy, pad_multiple)
        if partitioner not in PARTITIONERS:
            raise ValueError(f"partitioner={partitioner!r}: the port has "
                             f"{sorted(PARTITIONERS)}")
        entry = STREAM_ROUTERS.get(partitioner)
        router_state = None
        if is_stateful_router(entry):
            router_state = entry.make_state(n_parts, g.n_vertices, seed)
            part = np.minimum(router_state.route_adds(g.src, g.dst),
                              n_parts - 1)
        else:
            part = PARTITIONERS[partitioner](g, n_parts, seed=seed)
        pg = build_partitioned_graph(g, part, n_parts, shape_policy=policy)
        ctx = None
        if partitioner in STREAM_ROUTERS:
            ctx = StreamContext(partitioner=partitioner, n_parts=n_parts,
                                seed=seed, n_vertices=g.n_vertices,
                                routing_degrees=g.total_degrees(),
                                router_state=router_state)
        return cls(pg, ctx=ctx, mesh=mesh, cfg=cfg, shape_policy=policy,
                   device=dev, **kwargs)

    @classmethod
    def from_edge_log(cls, log, n_parts: int, partitioner: str = "cdbh",
                      *, seed: int = 0, mesh=None,
                      cfg: Optional[EngineConfig] = None,
                      pad_multiple: Optional[int] = None,
                      shape_policy: Optional[ShapePolicy] = None,
                      device: DeviceLike = None,
                      **kwargs) -> "GraphSession":
        """Open a session over a chunked on-disk edge log through the
        two-pass out-of-core ingest; ``sess.ingest_stats`` holds its
        throughput and memory accounting."""
        dev = resolve_device(device)
        policy = cls._resolve_policy(shape_policy, pad_multiple)
        pg, ctx, stats = streaming_ingest(log, n_parts, partitioner,
                                          seed=seed, shape_policy=policy)
        sess = cls(pg, ctx=ctx, mesh=mesh, cfg=cfg, shape_policy=policy,
                   device=dev, **kwargs)
        sess.ingest_stats = stats
        return sess

    @staticmethod
    def _normalize_cfg(cfg: EngineConfig) -> EngineConfig:
        """Without a mesh the session serves on the simulator backend."""
        if cfg.backend != "sim":
            cfg = dataclasses.replace(cfg, backend="sim")
        return cfg

    @property
    def slot_capacity(self) -> int:
        """SBS exchange height the runners are built with: the bucketed
        slot count when the session can mutate, the exact one when its
        frontier is frozen."""
        if self.buffer is None:
            return int(self.pg.n_slots)
        return self.shape_policy.slot_capacity(self.pg.n_slots)

    @property
    def shape_key(self):
        pg = self.pg
        return (pg.n_parts, pg.v_max, pg.e_max, self.slot_capacity,
                pg.vlabel is not None)

    def device_graph(self):
        """The resident stacked DeviceSubgraph, uploaded again only when
        the host graph changed since the last upload."""
        if self._device_graph is None \
                or self._device_version != self._host_version:
            self._device_graph = None      # free the old copy first
            self._device_graph = _device_subgraph(self.pg, self.device)
            self._device_version = self._host_version
            self.stats.uploads += 1
        return self._device_graph

    # ------------------------------------------------------------------ #
    # query path
    # ------------------------------------------------------------------ #
    def query(self, program: VertexProgram, params=None, *, warm="auto",
              cfg: Optional[EngineConfig] = None):
        """Run ``program`` over the resident graph; returns
        ``(results, ExecutionStats)`` with numpy results in the
        [P, v_max(, K)] local layout (``self.pg.collect`` maps them to
        global ids).

        ``warm``: ``"auto"`` restarts a monotone program from this
        (program, params) pair's last converged result; ``False`` forces a
        cold start; ``True`` requires a warm start. ``cfg`` overrides the
        session config for this query; ``cfg.trace=True`` delegates to the
        uncached ``run_sim``. Buffered updates are flushed first."""
        if self.buffer is not None and len(self.buffer):
            self.flush()
        cfg = self._normalize_cfg(cfg or self.cfg)
        pkey = program_key(program)
        if isinstance(pkey[1], int):
            self._keepalive[pkey[1]] = program

        entry = wkey = None
        if program.monotone:
            wkey = (pkey, params_fingerprint(params))
            entry = self._warm.get(wkey)
            if entry is not None:
                self._warm.move_to_end(wkey)
        if warm is True:
            if not program.monotone:
                raise ValueError(
                    f"warm=True: {type(program).__name__} is not monotone — "
                    "warm starts are only sound for programs whose values "
                    "tighten under the combiner (program.monotone)")
            if entry is None:
                raise ValueError(
                    "warm=True but no previous converged result is cached "
                    "for this (program, params) query; use warm='auto' to "
                    "fall back to cold")
        use_warm = entry is not None and warm in ("auto", True)

        if cfg.trace:
            init = entry.global_values if use_warm else None
            return run_sim(program, self.pg, params, cfg, init_state=init,
                           device=self.device)

        self.stats.queries += 1
        eb, cfg = normalize_edge_backend(program, cfg)
        warm_in = bool(program.monotone)
        sgs = self.device_graph()
        lay = self._layout_arg(program, eb, cfg) if eb != "coo" else None
        wblk = self._warm_arg(program, entry, use_warm) if warm_in else None
        runner, compile_time = self._get_runner(program, pkey, params, cfg,
                                                warm_in, eb)
        t0 = time.perf_counter()
        res, steps, msgs, sweeps, syncs = runner(sgs, lay, params, wblk)
        res = res.cpu().numpy()
        wall = time.perf_counter() - t0
        if use_warm:
            self.stats.warm_queries += 1
        self.stats.host_syncs += syncs + 1
        stats = self._execution_stats(program, cfg, steps, msgs, sweeps,
                                      wall, compile_time, eb)
        stats.host_syncs = syncs + 1
        if program.monotone:
            self._remember(program, wkey, res)
        return res, stats

    def _resolve_assignment(self, program, cfg) -> tuple:
        """The per-partition backends an ``'auto'`` query runs with, pinned
        per (padded shape, layout capacity) bucket: the policy is consulted
        when a bucket combination is first seen, and later queries in the
        same buckets reuse the pick while streaming growth moves the
        densities. Bucket crossings, compactions and rebalances
        re-resolve."""
        lay = self.pg.ensure_edge_layouts(shape_policy=self.shape_policy)
        key = (self.shape_key, lay.shape_key("pallas_tiles"),
               lay.shape_key("pallas_windows"))
        asg = self._auto_pin.get(key)
        if asg is None:
            asg = resolve_partition_backends(program, cfg, self.pg, lay=lay,
                                             device=self.device)
            self._auto_pin[key] = asg
        return asg

    def _layout_arg(self, program, eb, cfg):
        lay = self.pg.ensure_edge_layouts(shape_policy=self.shape_policy)
        if eb == "auto":
            return _auto_layout_blocks(lay, self.pg, program,
                                       self._resolve_assignment(program, cfg),
                                       self.device)
        return _layout_block_from(lay, self.pg, program, eb, self.device)

    def _layout_key(self, program, eb, cfg):
        lay = self.pg.edge_layouts
        if eb == "coo" or lay is None:
            return None
        if eb == "auto":
            # the pinned assignment joins the key: a re-resolution that
            # lands on other picks builds a runner of its own
            return ("auto", self._resolve_assignment(program, cfg),
                    lay.shape_key("pallas_tiles"),
                    lay.shape_key("pallas_windows"))
        return lay.shape_key(eb)

    def _warm_arg(self, program, entry, use_warm) -> torch.Tensor:
        """[P, v_max, K] warm tensor: the cached result when warming, the
        combiner identity (a no-op for ``warm_init``) when cold."""
        pg = self.pg
        K = program.payload
        if not use_warm:
            ikey = (pg.n_parts, pg.v_max, K, numpy_dtype(program.dtype).str,
                    float(program.identity))
            blk = self._identity_blocks.get(ikey)
            if blk is None:
                blk = torch.full((pg.n_parts, pg.v_max, K),
                                 program.identity.item(),
                                 dtype=program.torch_dtype,
                                 device=self.device)
                self._identity_blocks[ikey] = blk
            return blk
        self._sync_warm_entry(entry)
        blk = entry.device_block
        if blk.shape != (pg.n_parts, pg.v_max, K):
            blk = _warm_block(program, pg, entry.global_values)
        return torch.from_numpy(np.ascontiguousarray(blk)).to(self.device)

    def _sync_warm_entry(self, entry: _WarmEntry) -> None:
        """Replay on this entry's device block every remap logged since it
        was last brought forward (insert-only flushes, compactions)."""
        if entry.device_epoch == self._warm_epoch:
            return
        for ep, st in self._remap_log:
            if ep > entry.device_epoch:
                entry.device_block = st.remap_state(entry.device_block,
                                                    fill=entry.identity)
                self.stats.warm_remaps_applied += 1
        entry.device_epoch = self._warm_epoch
        self._sync_warm_bytes()

    def _prune_remap_log(self) -> None:
        """Drop log entries every live device block is already past."""
        epochs = [e.device_epoch for e in self._warm.values()]
        if not epochs:
            self._remap_log.clear()
            return
        floor = min(epochs)
        self._remap_log = [(ep, st) for ep, st in self._remap_log
                           if ep > floor]

    def _sync_warm_bytes(self) -> None:
        self.stats.warm_cache_bytes = sum(e.nbytes
                                          for e in self._warm.values())

    def _get_runner(self, program, pkey, params, cfg, warm_in, eb):
        """Cached runner for this (program, param structure, config,
        shapes); returns ``(runner, build_seconds)`` (0.0 on a hit)."""
        full_shape = (self.shape_key, self._layout_key(program, eb, cfg))
        key = (pkey, params_struct_key(params), cfg, full_shape, warm_in)
        hit = self._runners.get(key)
        if hit is not None:
            self._runners.move_to_end(key)
            self.stats.cache_hits += 1
            return hit, 0.0
        self.stats.runner_builds += 1
        t0 = time.perf_counter()
        asg = full_shape[1][1] if eb == "auto" else None
        runner = make_sim_runner(program, cfg, self.slot_capacity,
                                 warm_start=warm_in, partition_backends=asg)
        build_time = time.perf_counter() - t0
        self.stats.compile_time_total += build_time
        self._runners[key] = runner
        self.stats.cache_evictions_lru += self._evict_lru(
            self._runners, self.max_runners)
        return runner, build_time

    def _evict_lru(self, cache: OrderedDict, bound: Optional[int]) -> int:
        evicted = 0
        if bound is not None:
            while len(cache) > bound:
                cache.popitem(last=False)
                evicted += 1
        if evicted:
            self._prune_keepalive()
        return evicted

    def _prune_keepalive(self) -> None:
        """Release id-keyed program pins no runner or warm key holds."""
        live = {k[0][1] for k in self._runners} | \
               {wk[0][1] for wk in self._warm}
        self._keepalive = {i: p for i, p in self._keepalive.items()
                           if i in live}

    def _execution_stats(self, program, cfg, steps, msgs, sweeps, wall,
                         compile_time, eb) -> ExecutionStats:
        pg = self.pg
        K = program.payload
        itemsize = numpy_dtype(program.dtype).itemsize
        total_bytes = steps * (self.slot_capacity + 1) * K * itemsize \
            * pg.n_parts
        lay = pg.edge_layouts
        epp = pg.edges_per_part.astype(np.int64)
        asg = self._resolve_assignment(program, cfg) if eb == "auto" \
            else None
        # per-partition sweep time: the wall time apportioned by each
        # partition's flops share (partitions run lock-step supersteps, so
        # the flops skew is the critical-path skew the monitor reads)
        flops_pp = sweeps * _flops_per_sweep(program, eb, pg, lay, asg)
        tot_flops = int(flops_pp.sum())
        share = (flops_pp / tot_flops if tot_flops
                 else np.full(pg.n_parts, 1.0 / max(pg.n_parts, 1)))
        st = ExecutionStats(
            supersteps=steps, total_messages=msgs,
            processed_edges=int((sweeps * epp).sum()),
            total_bytes=total_bytes, wall_time=wall,
            compile_time=compile_time, edge_backend=eb,
            backend_flops=tot_flops,
            partition_edge_counts=[int(x) for x in epp],
            partition_flops=[int(x) for x in flops_pp],
            partition_sweep_time=[float(x) for x in wall * share],
            partition_sweeps=[int(x) for x in sweeps])
        dens = None
        if eb == "pallas_tiles" and lay is not None:
            spec = program.sweep_spec
            st.tile_density = lay.density(pg, spec.semiring,
                                          spec.edge_values, program.dtype)
            dens = lay.partition_density(pg, spec.semiring,
                                         spec.edge_values, program.dtype)
        elif eb == "auto" and lay is not None:
            # from the geometry: 'auto' realizes only its tile group
            st.tile_density, dens = lay.geometric_density()
            st.partition_edge_backends = list(asg)
        if dens is not None:
            st.partition_tile_density = [float(x) for x in dens]
            self.stats.tile_density_min = float(dens.min())
            self.stats.tile_density_mean = float(dens.mean())
            self.stats.tile_density_max = float(dens.max())
        # the load gauges on SessionStats (EWMA of the measured signal),
        # and the monitor's measured-work input
        self.stats.partition_edge_counts = list(st.partition_edge_counts)
        prev = self.stats.partition_sweep_time
        cur = st.partition_sweep_time
        if len(prev) != len(cur):
            self.stats.partition_sweep_time = list(cur)
        else:
            a = self.monitor.cfg.ema if self.monitor is not None else 0.5
            self.stats.partition_sweep_time = [
                a * n + (1.0 - a) * o for n, o in zip(cur, prev)]
        if self.monitor is not None:
            self.monitor.observe_query(st)
            self.stats.load_imbalance = self.monitor.gauge
        return st

    def _remember(self, program, wkey, res):
        """Cache this converged result as the warm seed for the next
        identical query (padded rows set to the combiner identity)."""
        pg = self.pg
        blk = res if res.ndim == 3 else res[..., None]
        blk = np.where(pg.vmask[..., None], blk,
                       np.asarray(program.identity, blk.dtype))
        self._warm[wkey] = _WarmEntry(
            global_values=pg.collect(res, fill=program.identity),
            device_block=blk, identity=program.identity,
            device_epoch=self._warm_epoch,
            polarity=program.warm_under)
        self._warm.move_to_end(wkey)
        self.stats.warm_evictions += self._evict_lru(self._warm,
                                                     self.max_warm_entries)
        self._prune_remap_log()
        self._sync_warm_bytes()

    # ------------------------------------------------------------------ #
    # streaming lifecycle
    # ------------------------------------------------------------------ #
    def _require_buffer(self, what: str) -> DeltaBuffer:
        if self.buffer is None:
            raise ValueError(
                f"{what} needs a StreamContext (this session was opened "
                "from a bare PartitionedGraph, or with a non-streamable "
                "partitioner); use GraphSession.from_graph/from_edge_log "
                "with a pure routing partitioner, or pass ctx=")
        return self.buffer

    def update(self, adds=None, deletes=None) -> None:
        """Enqueue edge mutations: ``adds`` is ``(src, dst)`` or ``(src,
        dst, w)`` in global ids, ``deletes`` is ``(src, dst)``. Ops
        coalesce in the buffer and apply on ``flush()`` or when a buffer
        threshold trips."""
        buf = self._require_buffer("update()")
        if isinstance(adds, EdgeDelta) or isinstance(deletes, EdgeDelta):
            raise TypeError("pass an EdgeDelta through session.push()")
        if deletes is not None:
            buf.delete(*deletes[:2])
        if adds is not None:
            buf.add(*adds[:3])

    def push(self, delta: EdgeDelta) -> None:
        """Enqueue a whole producer ``EdgeDelta`` (deletes, then adds)."""
        self._require_buffer("push()").push(delta)

    def flush(self) -> Optional[DeltaStats]:
        """Apply every buffered mutation as one coalesced patch. Returns its
        ``DeltaStats`` — or, if a threshold already flushed everything, the
        last applied patch's (None only when nothing was ever applied). The
        device graph and the kernels' device lists are rebuilt on the next
        query; runners survive unless the padded shapes left their
        buckets."""
        buf = self._require_buffer("flush()")
        st = buf.flush()
        return st if st is not None else buf.last_flush

    def _on_flush(self, st: DeltaStats) -> None:
        self._host_version += 1
        self.stats.flushes += 1
        # an entry survives a patch of its program's polarity
        # (VertexProgram.warm_under): 'inserts' entries an insert-only
        # patch, 'deletes' entries a patch that added nothing
        keep = {"inserts": st.warm_start_safe, "deletes": st.n_added == 0}
        if any(keep.values()):
            # logged only; each entry replays the chain on its next use
            self._warm_epoch += 1
            self._remap_log.append((self._warm_epoch, st))
        if not all(keep.values()):
            for wkey in [k for k, e in self._warm.items()
                         if not keep.get(e.polarity, False)]:
                del self._warm[wkey]
        self._prune_remap_log()
        self._sync_warm_bytes()
        self._evict_stale_runners()
        # streaming churn drives the load monitor; under rebalance="auto" a
        # tripped gauge migrates here, before the flush's caller sees the
        # new graph version
        if self.monitor is not None and not self._rebalancing:
            self.stats.load_imbalance = self.monitor.observe_graph(self.pg)
            if (self._rebalance_mode == "auto"
                    and self.monitor.should_rebalance()):
                self.rebalance()

    def rebalance(self, *, target: Optional[float] = None
                  ) -> Optional[RebalanceStats]:
        """Migrate edges off overloaded partitions: plan a minimal
        cheapest-first move set (``partition.rebalance``), execute it
        through ``repack_partitions`` like ``compact`` (warm results ride
        the remap chain, in-bucket runners survive) and record the moved
        pairs in the routing context, so later deletes and re-adds find
        them. Returns the ``RebalanceStats``, or None when the plan is
        empty. Needs a ``StreamContext``, like every mutation."""
        self._require_buffer("rebalance()")
        if self._rebalancing:
            return None
        self._rebalancing = True
        try:
            if len(self.buffer):
                self.flush()
            # donors are chosen by the monitor's blended load vector when
            # one is live; the moved objects are still edges
            loads = self.monitor.blended_loads(self.pg.n_parts) \
                if self.monitor is not None else None
            plan = plan_rebalance(
                self.pg, target=self.rebalance_target
                if target is None else target, loads=loads)
            if plan.n_moves == 0:
                return None
            rs = execute_rebalance(self.pg, self.ctx, plan,
                                   shape_policy=self.shape_policy)
            self._host_version += 1
            self.stats.rebalances += 1
            # the migration reshaped the per-partition densities: the next
            # 'auto' query consults the policy again
            self._auto_pin.clear()
            self._warm_epoch += 1
            self._remap_log.append((self._warm_epoch, rs))
            self._prune_remap_log()
            self._evict_stale_runners()
            if self.monitor is not None:
                self.monitor.notify_rebalanced()
                self.stats.load_imbalance = self.monitor.observe_graph(
                    self.pg)
            return rs
        finally:
            self._rebalancing = False

    def compact(self) -> CompactStats:
        """Evict edge-less members, shrink the padded capacities to the
        policy's bucket floor, and carry every cached warm result across
        the re-layout (its device block through ``remap_state``, lazily).
        A compacted content that still fits the current buckets keeps the
        padded shapes and every runner."""
        self._require_buffer("compact()")
        if len(self.buffer):
            self.flush()
        cs = _compact_pg(self.pg, self.ctx, shape_policy=self.shape_policy)
        self._host_version += 1
        self.stats.compactions += 1
        self._auto_pin.clear()         # the geometry moved: re-resolve
        self._warm_epoch += 1
        self._remap_log.append((self._warm_epoch, cs))
        self._prune_remap_log()
        self._evict_stale_runners()
        return cs

    def _evict_stale_runners(self) -> None:
        """Drop runners built for padded shapes the graph no longer has:
        the base shape key, and for kernel runners the ``tiles``/``windows``
        layout key (a stale layout key stales only that backend's
        runners)."""
        cur = self.shape_key
        lay = self.pg.edge_layouts
        have_lay = lay is not None and lay.matches(self.pg)

        def stale(full_shape) -> bool:
            base, lkey = full_shape
            if base != cur:
                return True
            if lkey is None:
                return False
            if not have_lay:
                return True
            if lkey[0] == "auto":
                _, asg, tk, wk = lkey
                now = (lay.shape_key("pallas_tiles"),
                       lay.shape_key("pallas_windows"))
                if (tk, wk) != now:
                    return True
                # a re-resolved pin with other picks stales the runner
                pin = self._auto_pin.get((cur,) + now)
                return pin is not None and pin != asg
            backend = "pallas_tiles" if lkey[0] == "tiles" \
                else "pallas_windows"
            return lkey != lay.shape_key(backend)

        dead = [k for k in self._runners if stale(k[3])]
        for k in dead:
            del self._runners[k]
        self.stats.cache_evictions_shape += len(dead)
        self._prune_keepalive()
        self._identity_blocks = {
            k: v for k, v in self._identity_blocks.items()
            if k[:2] == (self.pg.n_parts, self.pg.v_max)}

    # ------------------------------------------------------------------ #
    # not ported yet
    # ------------------------------------------------------------------ #
    def query_batch(self, program, params_list, **kwargs):
        raise NotImplementedError(
            "query_batch waits for ROADMAP Queue 1, serving/batching")
