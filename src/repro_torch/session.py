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

Serving (the JAX package's ``repro.serving``): ``query_batch`` serves a
list of same-structure queries of one program in one runner call, each
lane exactly what ``query`` would return; ``runner_cache=`` shares a
``RunnerCache`` across sessions (a ``SessionPool``), ``result_cache=``
attaches a tiered ``ResultCache`` that answers repeated queries with no
launch, ``tenant=`` names the session in both; ``close()`` releases the
resident graph and the session's pins.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names``)
serves on the ``shard_map`` backend, SPMD: every rank of the job opens the
same session on the same graph and issues the same calls in the same
order. Each rank keeps the whole host graph (every rank applies each
delta, compaction and rebalance to its own copy) and uploads only its
block — its partition and, under ``cfg.edge_axes``, its chunk of the
partition's edge columns; every rank gets the global results. The
``'auto'`` assignment is resolved on the mesh's first rank and broadcast,
and each query's wall time is the mesh's maximum, so the load monitor
triggers a rebalance on every rank at the same flush.
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
                                     _device_subgraph,
                                     _exchange_bytes_per_step,
                                     _flops_per_sweep, _layout_block_from,
                                     _shard_layout_block, _warm_block,
                                     make_bsp_runner, make_sim_runner,
                                     normalize_edge_backend,
                                     resolve_mesh_backends,
                                     resolve_partition_backends, run_sim)
from repro_torch.core.graph import Graph
from repro_torch.core.mesh import MeshPlacement, placement
from repro_torch.core.metrics import ExecutionStats, span
from repro_torch.core.partition import (PARTITIONERS, STREAM_ROUTERS,
                                        is_stateful_router)
from repro_torch.core.subgraph import (PartitionedGraph, ShapePolicy,
                                       build_partitioned_graph)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.partition.monitor import LoadMonitor
from repro_torch.partition.rebalance import (RebalanceStats,
                                             execute_rebalance,
                                             plan_rebalance)
from repro_torch.serving.result_cache import ResultCache, result_key
from repro_torch.serving.runner_cache import (RunnerCache, RunnerEntry,
                                              canonical_params,
                                              params_fingerprint,
                                              params_leaves,
                                              params_struct_key, program_key,
                                              runner_nbytes)
from repro_torch.stream.buffer import DeltaBuffer
from repro_torch.stream.delta import CompactStats, DeltaStats, EdgeDelta
from repro_torch.stream.delta import compact as _compact_pg
from repro_torch.stream.ingest import StreamContext, streaming_ingest

__all__ = ["GraphSession", "SessionStats", "ShapePolicy"]


@dataclasses.dataclass(eq=False)
class _CollectPlan:
    """Where one membership version of a ``PartitionedGraph`` keeps its
    rows, flat over the [P * v_max] local layout: ``pad_rows`` (a tensor)
    outside every partition's members, ``src_rows`` the master replicas and
    ``dst_gids`` their global ids. The arrays are fresh, so no later
    in-place edit of the graph reaches a plan."""
    n_vertices: int
    pad_rows: torch.Tensor
    src_rows: np.ndarray
    dst_gids: np.ndarray

    @classmethod
    def of(cls, pg: PartitionedGraph) -> "_CollectPlan":
        src = np.flatnonzero(pg.vmask & pg.is_master)
        return cls(pg.n_vertices,
                   torch.from_numpy(np.flatnonzero(~pg.vmask)), src,
                   pg.gvid.ravel()[src])

    def collect(self, block: np.ndarray, fill, tail: tuple) -> np.ndarray:
        """``pg.collect`` of a [P, v_max, K] block under this plan's
        membership, as a [n_vertices, *tail] array."""
        out = np.full((self.n_vertices,) + tail, fill, dtype=block.dtype)
        out.reshape(self.n_vertices, -1)[self.dst_gids] = \
            block.reshape(-1, block.shape[2])[self.src_rows]
        return out


@dataclasses.dataclass(eq=False)
class _WarmEntry:
    """Last converged result of one (program, params) query.

    ``device_block`` ([P, v_max, K] numpy, the entry's own copy, combiner
    identity at padded rows) is valid at ``device_epoch`` of the session's
    remap log and is brought forward lazily on the entry's next use
    (``GraphSession._sync_warm_entry``). ``global_values`` ([n_vertices(,
    K)], combiner identity where no master holds a value) survives any
    membership change; it is gathered from the block as remembered, under
    ``plan`` (the membership of that moment), on its first read, and the
    session builds it before a remap replaces the block.
    ``SessionStats.warm_collects`` counts the gathers. ``nbytes`` charges
    both arrays, built or not, so the memory's bounds evict as they would
    with the global array held from the start. ``polarity`` is the
    program's ``warm_under``: the delta polarity the entry survives."""
    device_block: np.ndarray
    identity: object
    plan: _CollectPlan
    tail: tuple                  # the result's shape past [P, v_max]
    stats: "SessionStats" = dataclasses.field(repr=False)
    device_epoch: int = 0
    polarity: str = "inserts"
    _global: Optional[np.ndarray] = dataclasses.field(default=None,
                                                      repr=False)

    @property
    def global_values(self) -> np.ndarray:
        if self._global is None:
            with span("drone.session.warm_collect"):
                self._global = self.plan.collect(self.device_block,
                                                 self.identity, self.tail)
            self.stats.warm_collects += 1
        return self._global

    @property
    def nbytes(self) -> int:
        n = self.plan.n_vertices * int(np.prod(self.tail, dtype=np.int64))
        return n * self.device_block.itemsize + self.device_block.nbytes


@dataclasses.dataclass
class SessionStats:
    """Serving-side counters across the session lifetime."""
    queries: int = 0
    cache_hits: int = 0
    runner_builds: int = 0         # runner-cache misses (the reference's
                                   # cache_misses)
    warm_queries: int = 0          # queries served from a previous result
    flushes: int = 0               # delta batches applied to the host graph
    compactions: int = 0
    uploads: int = 0               # device-graph uploads
    compile_time_total: float = 0.0
    cache_evictions_lru: int = 0   # runners dropped by the max_runners /
                                   # max_runner_bytes bounds
    cache_evictions_shape: int = 0  # runners dropped by a bucket change
    warm_evictions: int = 0        # warm results dropped by
                                   # max_warm_entries / max_warm_bytes
    runner_cache_bytes: int = 0    # estimated device bytes of the runner
                                   # cache (runner_nbytes per entry)
    warm_cache_bytes: int = 0      # host bytes of the warm-result memory
    warm_remaps_applied: int = 0   # deferred warm-block remaps replayed
    device_launches: int = 0       # runner calls; a result-cache hit
                                   # serves with none
    batches: int = 0               # micro-batched runner calls (query_batch)
    batched_queries: int = 0       # queries served inside those calls
    result_cache_l1_hits: int = 0  # converged results served from the
    result_cache_l2_hits: int = 0  # in-process / external tier
    result_cache_misses: int = 0   # result-cache consultations that ran
    host_syncs: int = 0            # device->host reads across all queries
    warm_collects: int = 0         # warm results' global arrays gathered
                                   # (on first read: cfg.trace, the shape
                                   # fallback, a remap)
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
    setup_seconds: dict = dataclasses.field(default_factory=dict)
                                   # host seconds of the set-up work, the
                                   # latest of each: 'route' (partitioner
                                   # or router) and 'build' (partitioned
                                   # graph and session) in from_graph,
                                   # 'upload' (device graph), 'layouts'
                                   # (edge layouts and their device copy)


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
class GraphSession:
    """Resident-graph query session over one ``PartitionedGraph`` on one
    device (``device=None``: the CUDA card; ``device="cpu"``: the plain
    PyTorch path), or with ``mesh=`` this rank's block of it on the
    ``shard_map`` backend (the module docstring says how).

    ``ctx`` (a ``StreamContext``) enables ``update``/``push``/``flush``/
    ``compact``, through a coalescing buffer bounded by
    ``max_buffer_edges``/``max_buffer_parts`` (auto-flush thresholds);
    the factory constructors provide it for pure streaming routers. A
    session without one is read-only and pads the SBS slot count exactly;
    a mutable one builds runners on the policy's bucketed slot capacity.
    ``shape_policy`` governs the padded shapes as in the reference.
    ``max_runners`` / ``max_warm_entries`` bound the runner cache and the
    warm-result memory with LRU eviction (``None`` = unbounded);
    ``max_runner_bytes`` / ``max_warm_bytes`` bound the same caches by
    estimated bytes per entry (``runner_nbytes`` per runner, host bytes per
    warm result).

    Serving: ``runner_cache=`` injects a shared ``RunnerCache`` (how a
    ``SessionPool`` makes same-bucket tenants reuse one runner; the
    session's own bounds are then ignored for the shared ones),
    ``result_cache=`` attaches a tiered ``ResultCache`` that ``query``
    consults before launching anything, ``tenant=`` names the session in
    both caches' keys and pins. ``close()`` (or the context-manager form)
    drops the resident graph and releases every pin; a closed session
    raises ``RuntimeError`` on use. The reference's ``debug_sanitize``
    (its JAX retrace guard) has no counterpart: a PyTorch runner does not
    trace.

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
                 max_runner_bytes: Optional[int] = None,
                 max_warm_bytes: Optional[int] = None,
                 runner_cache: Optional[RunnerCache] = None,
                 result_cache: Optional[ResultCache] = None,
                 tenant: Optional[str] = None,
                 rebalance: str = "off",
                 monitor: Optional[LoadMonitor] = None,
                 rebalance_target: float = 1.05,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.pg = pg
        self.ctx = ctx
        self.mesh = mesh
        self.cfg = self._normalize_cfg(cfg or EngineConfig())
        self.shape_policy = self._resolve_policy(shape_policy, pad_multiple)
        self.max_warm_entries = max_warm_entries
        self.max_warm_bytes = max_warm_bytes
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
        self.tenant = f"session-{id(self):x}" if tenant is None else tenant
        self._runner_cache = runner_cache if runner_cache is not None \
            else RunnerCache(max_runners, max_runner_bytes)
        self.result_cache = result_cache
        self._closed = False
        self.stats = SessionStats()
        self.buffer = None if ctx is None else _SessionBuffer(
            self, pg, ctx, max_edges=max_buffer_edges,
            max_parts=max_buffer_parts, shape_policy=self.shape_policy)
        self._device_graph = None
        self._device_version = -1
        self._device_block = None      # (part, shard, n_shards) under a mesh
        self._host_version = 0         # bumped by every applied flush/compact
        self._warm: OrderedDict = OrderedDict()
        self._warm_plan: Optional[tuple] = None  # (_host_version, plan)
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
        t0 = time.perf_counter()
        if is_stateful_router(entry):
            router_state = entry.make_state(n_parts, g.n_vertices, seed)
            part = np.minimum(router_state.route_adds(g.src, g.dst),
                              n_parts - 1)
        else:
            part = PARTITIONERS[partitioner](g, n_parts, seed=seed)
        t1 = time.perf_counter()
        pg = build_partitioned_graph(g, part, n_parts, shape_policy=policy)
        ctx = None
        if partitioner in STREAM_ROUTERS:
            ctx = StreamContext(partitioner=partitioner, n_parts=n_parts,
                                seed=seed, n_vertices=g.n_vertices,
                                routing_degrees=g.total_degrees(),
                                router_state=router_state)
        sess = cls(pg, ctx=ctx, mesh=mesh, cfg=cfg, shape_policy=policy,
                   device=dev, **kwargs)
        sess.stats.setup_seconds.update(route=t1 - t0,
                                        build=time.perf_counter() - t1)
        return sess

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

    def _normalize_cfg(self, cfg: EngineConfig) -> EngineConfig:
        """The mesh picks the backend: ``shard_map`` with one, the
        simulator without, whatever the config asks for."""
        backend = "sim" if self.mesh is None else "shard_map"
        if cfg.backend != backend:
            cfg = dataclasses.replace(cfg, backend=backend)
        return cfg

    def _placement(self, cfg: EngineConfig) -> Optional[MeshPlacement]:
        """This rank's block of the mesh under ``cfg``'s axes (None
        without a mesh)."""
        if self.mesh is None:
            return None
        return placement(self.mesh, cfg.subgraph_axes, cfg.edge_axes)

    def _n_edge_shards(self, cfg: EngineConfig) -> int:
        pl = self._placement(cfg)
        return 1 if pl is None else pl.n_edge

    def _check_mesh(self, cfg: EngineConfig) -> MeshPlacement:
        pl = self._placement(cfg)
        if self.pg.n_parts != pl.n_sub:
            raise ValueError(
                f"the graph has {self.pg.n_parts} partitions, the mesh's "
                f"subgraph axes {cfg.subgraph_axes} {pl.n_sub}")
        if self.pg.e_max % pl.n_edge:
            raise ValueError(f"e_max={self.pg.e_max} must divide by the "
                             f"{pl.n_edge} edge shards")
        return pl

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

    @property
    def _runners(self):
        """The runner entries (key -> ``RunnerEntry``, LRU order); on a
        pool-shared cache the whole shared map. Mutate through
        ``self._runner_cache``."""
        return self._runner_cache.entries

    # the bounds live on the (possibly shared) cache; setting one re-bounds
    # the cache this session uses, applied on the next insert
    @property
    def max_runners(self) -> Optional[int]:
        return self._runner_cache.max_entries

    @max_runners.setter
    def max_runners(self, v: Optional[int]) -> None:
        self._runner_cache.max_entries = v

    @property
    def max_runner_bytes(self) -> Optional[int]:
        return self._runner_cache.max_bytes

    @max_runner_bytes.setter
    def max_runner_bytes(self, v: Optional[int]) -> None:
        self._runner_cache.max_bytes = v

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Release what the session holds: the resident device graph, its
        pins in the (possibly shared) runner cache, the warm memory,
        identity blocks and program pins. Idempotent; any later query or
        mutation raises ``RuntimeError``."""
        if self._closed:
            return
        self._closed = True
        self._runner_cache.release(self.tenant)
        self._warm.clear()
        self._remap_log.clear()
        self._identity_blocks.clear()
        self._keepalive.clear()
        self._device_graph = None
        self._device_version = -1
        self._sync_warm_bytes()
        self._sync_runner_bytes()

    def __enter__(self) -> "GraphSession":
        self._check_open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("GraphSession is closed")

    def device_graph(self, cfg: Optional[EngineConfig] = None):
        """The resident stacked DeviceSubgraph (under a mesh, this rank's
        block for ``cfg``'s axes), uploaded again only when the host graph
        or the block changed since the last upload."""
        self._check_open()
        block = None
        if self.mesh is not None:
            pl = self._check_mesh(self._normalize_cfg(cfg or self.cfg))
            block = (pl.part, pl.shard, pl.n_edge)
        if self._device_graph is None \
                or self._device_version != self._host_version \
                or self._device_block != block:
            self._device_graph = None      # free the old copy first
            t0 = time.perf_counter()
            self._device_graph = _device_subgraph(self.pg, self.device,
                                                  block=block)
            self.stats.setup_seconds["upload"] = time.perf_counter() - t0
            self._device_version = self._host_version
            self._device_block = block
            self.stats.uploads += 1
        return self._device_graph

    # ------------------------------------------------------------------ #
    # query path
    # ------------------------------------------------------------------ #
    def query(self, program: VertexProgram, params=None, *, warm="auto",
              cfg: Optional[EngineConfig] = None, use_result_cache=True):
        """Run ``program`` over the resident graph; returns
        ``(results, ExecutionStats)`` with numpy results in the
        [P, v_max(, K)] local layout (``self.pg.collect`` maps them to
        global ids).

        ``warm``: ``"auto"`` restarts a monotone program from this
        (program, params) pair's last converged result; ``False`` forces a
        cold start; ``True`` requires a warm start. ``cfg`` overrides the
        session config for this query; ``cfg.trace=True`` delegates to the
        uncached ``run_sim``. With a ``result_cache`` attached, the
        converged result of this exact (graph version, program, params,
        cfg) query may be served from the cache with no launch
        (``ExecutionStats.result_cache_tier`` names the tier);
        ``use_result_cache=False`` forces a run. Buffered updates are
        flushed first."""
        with span("drone.query"):
            return self._query(program, params, warm, cfg, use_result_cache)

    def _query(self, program, params, warm, cfg, use_result_cache):
        with span("drone.session.prepare"):
            self._check_open()
            if self.buffer is not None and len(self.buffer):
                self.flush()
            cfg = self._normalize_cfg(cfg or self.cfg)
            params_c = canonical_params(params)
            pkey = program_key(program)
            if isinstance(pkey[1], int):
                self._keepalive[pkey[1]] = program
            entry, wkey, use_warm = self._warm_lookup(program, pkey,
                                                      params_c, warm)
            if cfg.trace:
                init = entry.global_values if use_warm else None
                return run_sim(program, self.pg, params, cfg,
                               init_state=init, device=self.device)

            self.stats.queries += 1
            eb, cfg = normalize_edge_backend(program, cfg)
            use_rc = use_result_cache and self.result_cache is not None
            rkey = None
            if use_rc:
                rkey = result_key(self.tenant, self._host_version, program,
                                  params_c, cfg)
                t0 = time.perf_counter()
                val, tier = self.result_cache.get(rkey)
                if not self._mesh_all(val is not None, cfg):
                    val = None  # another rank missed (its own TTL clock)
                if val is not None:
                    self._bill_hit(tier)
                    return np.asarray(val["results"]), ExecutionStats(
                        supersteps=int(val["supersteps"]),
                        wall_time=time.perf_counter() - t0,
                        edge_backend=str(val.get("edge_backend", eb)),
                        result_cache_tier=tier)
                self.stats.result_cache_misses += 1

            warm_in = bool(program.monotone)
            sgs = self.device_graph(cfg)
            lay = self._layout_arg(program, eb, cfg) if eb != "coo" \
                else None
            wblk = self._warm_arg(program, entry, use_warm, cfg) \
                if warm_in else None
            runner, compile_time, evicted = self._get_runner(
                program, pkey, params_c, cfg, warm_in, eb)
        t0 = time.perf_counter()
        res, steps, msgs, sweeps, syncs, *coll = runner(sgs, lay, params,
                                                       wblk)
        coll, moved = coll or (0, {})
        self.stats.device_launches += 1
        with span("drone.session.fetch"):
            res = res.cpu().numpy()
        wall = time.perf_counter() - t0
        if use_warm:
            self.stats.warm_queries += 1
        self.stats.host_syncs += syncs + 1
        with span("drone.session.stats"):
            stats = self._execution_stats(program, cfg, steps, msgs, sweeps,
                                          wall, compile_time, eb)
        stats.host_syncs = syncs + 1
        stats.collectives = coll
        stats.collective_bytes = moved
        stats.evicted_runners = evicted
        if program.monotone:
            with span("drone.session.remember"):
                self._remember(program, wkey, res)
        if use_rc:
            stats.result_cache_tier = "miss"
            self.result_cache.put(rkey, dict(
                results=res, supersteps=stats.supersteps, edge_backend=eb))
        return res, stats

    def query_batch(self, program: VertexProgram, params_list, *,
                    warm="auto", cfg: Optional[EngineConfig] = None,
                    use_result_cache=True):
        """Serve ``len(params_list)`` queries of one program in ONE runner
        call (the entry point ``serving.MicroBatcher`` coalesces traffic
        into). Returns ``[(results, ExecutionStats), ...]`` in input order,
        each exactly what ``query`` would return: the batched runner runs
        each lane's BSP loop through the singleton superstep
        (``make_sim_runner(batch=True)``).

        Every lane must share the program and the param structure
        (``ValueError`` otherwise). The runner is built and keyed for the
        lane count padded up to the next power of two, so the cache holds
        O(log max_batch) batched runners per program; the pad lanes, whose
        outputs the reference discards, are not run. Leafless lanes of a
        non-monotone program are one computation: one singleton query
        answers them all. Warm starts and the result cache work per lane;
        the result cache short-circuits only when EVERY lane hits (a
        partial hit runs the whole batch)."""
        self._check_open()
        if self.buffer is not None and len(self.buffer):
            self.flush()
        B = len(params_list)
        if B == 0:
            return []
        cfg = self._normalize_cfg(cfg or self.cfg)
        if cfg.trace:
            raise ValueError("query_batch does not support cfg.trace — "
                             "trace one query at a time")
        params_cs = [canonical_params(p) for p in params_list]
        skey = params_struct_key(params_cs[0])
        if any(params_struct_key(pc) != skey for pc in params_cs[1:]):
            raise ValueError(
                "query_batch needs an identical param structure on every "
                "lane (same tree, leaf shapes and dtypes); mismatched "
                "requests must go through query()")
        if B == 1 or (not params_leaves(params_cs[0])
                      and not program.monotone):
            # one lane, or leafless lanes (nothing differs between them):
            # one singleton query answers every lane
            res, st = self.query(program, params_list[0], warm=warm,
                                 cfg=cfg, use_result_cache=use_result_cache)
            if B == 1:
                return [(res, st)]
            return [(res, dataclasses.replace(st, batch_size=B))
                    for _ in range(B)]

        pkey = program_key(program)
        if isinstance(pkey[1], int):
            self._keepalive[pkey[1]] = program
        eb, cfg = normalize_edge_backend(program, cfg)
        use_rc = use_result_cache and self.result_cache is not None
        rkeys = None
        if use_rc:
            rkeys = [result_key(self.tenant, self._host_version, program, pc,
                                cfg) for pc in params_cs]
            hits = None
            if all(self.result_cache.peek(k) is not None for k in rkeys):
                hits = []
                for k in rkeys:
                    t0 = time.perf_counter()
                    val, tier = self.result_cache.get(k)
                    hits.append((val, tier, time.perf_counter() - t0))
                if any(val is None for val, _, _ in hits):
                    hits = None             # a lane expired since the peek
            if not self._mesh_all(hits is not None, cfg):
                hits = None     # another rank missed (its own TTL clock)
            if hits is not None:
                out = []
                for val, tier, wall in hits:
                    self._bill_hit(tier)
                    out.append((np.asarray(val["results"]), ExecutionStats(
                        supersteps=int(val["supersteps"]), wall_time=wall,
                        edge_backend=str(val.get("edge_backend", eb)),
                        result_cache_tier=tier, batch_size=B)))
                self.stats.queries += B
                return out
            self.stats.result_cache_misses += B

        lanes = [self._warm_lookup(program, pkey, pc, warm)
                 for pc in params_cs]
        self.stats.queries += B
        self.stats.batches += 1
        self.stats.batched_queries += B
        warm_in = bool(program.monotone)
        Bp = 1 << (B - 1).bit_length()           # power-of-2 lane bucket
        sgs = self.device_graph(cfg)
        lay = self._layout_arg(program, eb, cfg) if eb != "coo" else None
        wstack = None
        if warm_in:
            wstack = torch.stack([self._warm_arg(program, e, u, cfg)
                                  for e, _, u in lanes])
        runner, compile_time, evicted = self._get_runner(
            program, pkey, params_cs[0], cfg, warm_in, eb, batch=Bp)
        t0 = time.perf_counter()
        res_b, steps_b, msgs_b, sweeps_b, syncs, *coll = runner(
            sgs, lay, list(params_list), wstack)
        coll, moved = coll or (0, {})
        self.stats.device_launches += 1
        res_b = res_b.cpu().numpy()
        wall = time.perf_counter() - t0
        self.stats.host_syncs += syncs + 1

        results = []
        for i, (_, wkey, use_warm) in enumerate(lanes):
            res = res_b[i]
            st = self._execution_stats(program, cfg, int(steps_b[i]),
                                       int(msgs_b[i]), sweeps_b[i], wall,
                                       compile_time, eb)
            st.host_syncs = syncs + 1
            st.collectives = coll
            st.collective_bytes = moved
            st.evicted_runners = evicted
            st.batch_size = B
            if use_warm:
                self.stats.warm_queries += 1
            if program.monotone:
                self._remember(program, wkey, res)
            if use_rc:
                st.result_cache_tier = "miss"
                self.result_cache.put(rkeys[i], dict(
                    results=res, supersteps=st.supersteps, edge_backend=eb))
            results.append((res, st))
        return results

    def result_cached(self, program: VertexProgram, params=None,
                      cfg: Optional[EngineConfig] = None) -> bool:
        """Whether ``query`` would answer this request from the result
        cache now: a cache is attached, no mutation is buffered and it
        holds the key — on every rank of the mesh (a TTL reads each rank's
        own clock). The batcher's fast path asks this before queueing."""
        if self.result_cache is None or (self.buffer is not None
                                         and len(self.buffer)):
            return False
        hit = self.result_cache.peek(
            self.result_key_for(program, params, cfg)) is not None
        return self._mesh_all(hit, self._normalize_cfg(cfg or self.cfg))

    def result_key_for(self, program: VertexProgram, params=None,
                       cfg: Optional[EngineConfig] = None) -> str:
        """The result-cache key ``query`` would consult for this request
        now (tenant, current graph version, normalized config): the
        batcher's fast path peeks it before queueing."""
        cfg = self._normalize_cfg(cfg or self.cfg)
        _, cfg = normalize_edge_backend(program, cfg)
        return result_key(self.tenant, self._host_version, program,
                          canonical_params(params), cfg)

    def _warm_lookup(self, program, pkey, params_c, warm) -> tuple:
        """``(entry, wkey, use_warm)`` of one query under the ``warm``
        rules of ``query``."""
        entry = wkey = None
        if program.monotone:
            wkey = (pkey, params_fingerprint(params_c))
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
        return entry, wkey, entry is not None and warm in ("auto", True)

    def _bill_hit(self, tier: str) -> None:
        if tier == "l1":
            self.stats.result_cache_l1_hits += 1
        else:
            self.stats.result_cache_l2_hits += 1

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
            if self.mesh is None:
                asg = resolve_partition_backends(program, cfg, self.pg,
                                                 lay=lay, device=self.device)
            else:
                asg = resolve_mesh_backends(program, cfg, self.pg,
                                            self.mesh, lay=lay,
                                            device=self.device)
            self._auto_pin[key] = asg
        return asg

    def _layout_arg(self, program, eb, cfg):
        """The device layout input of a kernel-backend runner; a call that
        builds the host layouts or a device copy of them is timed
        (``setup_seconds['layouts']``)."""
        before = self._layout_builds()
        t0 = time.perf_counter()
        blk = self._layout_block(program, eb, cfg)
        if self._layout_builds() != before:
            self.stats.setup_seconds["layouts"] = time.perf_counter() - t0
        return blk

    def _layout_builds(self) -> tuple:
        """The layouts object and how many device copies it caches: a
        change between two reads is a build."""
        lay = self.pg.edge_layouts
        return (None, 0) if lay is None else (id(lay), len(lay._device))

    def _layout_block(self, program, eb, cfg):
        lay = self.pg.ensure_edge_layouts(shape_policy=self.shape_policy)
        pl = self._placement(cfg)
        if pl is not None:
            backend = self._resolve_assignment(program, cfg)[pl.part] \
                if eb == "auto" else eb
            return _shard_layout_block(lay, self.pg, program, backend,
                                       self.device, pl)
        if eb == "auto":
            return _auto_layout_blocks(lay, self.pg, program,
                                       self._resolve_assignment(program, cfg),
                                       self.device)
        return _layout_block_from(lay, self.pg, program, eb, self.device)

    def _layout_key(self, program, eb, cfg):
        lay = self.pg.edge_layouts
        if eb == "coo" or lay is None:
            return None
        ns = self._n_edge_shards(cfg)
        if eb == "auto":
            # the pinned assignment joins the key: a re-resolution that
            # lands on other picks builds a runner of its own
            return ("auto", self._resolve_assignment(program, cfg),
                    lay.shape_key("pallas_tiles", n_shards=ns, pg=self.pg),
                    lay.shape_key("pallas_windows", n_shards=ns, pg=self.pg))
        return lay.shape_key(eb, n_shards=ns, pg=self.pg)

    def _warm_arg(self, program, entry, use_warm,
                  cfg: EngineConfig) -> torch.Tensor:
        """[P, v_max, K] warm tensor (under a mesh this rank's [1, v_max,
        K] row of it): the cached result when warming, the combiner
        identity (a no-op for ``warm_init``) when cold."""
        pg = self.pg
        K = program.payload
        pl = self._placement(cfg)
        rows = slice(None) if pl is None else slice(pl.part, pl.part + 1)
        n = pg.n_parts if pl is None else 1
        if not use_warm:
            ikey = (n, pg.v_max, K, numpy_dtype(program.dtype).str,
                    float(program.identity))
            blk = self._identity_blocks.get(ikey)
            if blk is None:
                blk = torch.full((n, pg.v_max, K), program.identity.item(),
                                 dtype=program.torch_dtype,
                                 device=self.device)
                self._identity_blocks[ikey] = blk
            return blk
        self._sync_warm_entry(entry)
        blk = entry.device_block
        if blk.shape != (pg.n_parts, pg.v_max, K):
            blk = _warm_block(program, pg, entry.global_values)
        return torch.from_numpy(np.ascontiguousarray(blk[rows])).to(
            self.device)

    def _sync_warm_entry(self, entry: _WarmEntry) -> None:
        """Replay on this entry's device block every remap logged since it
        was last brought forward (insert-only flushes, compactions)."""
        if entry.device_epoch == self._warm_epoch:
            return
        # the global array is gathered from the block as remembered: build
        # it before the first remap replaces the block
        entry.global_values
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

    def _get_runner(self, program, pkey, params_c, cfg, warm_in, eb,
                    batch=0):
        """Cached runner for this (program, param structure, config,
        shapes); returns ``(runner, build_seconds, n_lru_evictions)``
        (0.0 seconds on a hit). The cache may be shared (``SessionPool``):
        keys carry shapes and never the tenant, so a same-bucket lookup by
        another tenant hits the same entry. ``batch`` (``query_batch``'s
        padded lane count) joins the key, so a batched runner never
        collides with a singleton one."""
        full_shape = (self.shape_key, self._layout_key(program, eb, cfg))
        key = (pkey, params_struct_key(params_c), cfg, full_shape, warm_in)
        if batch:
            key = key + (("batch", batch),)
        hit = self._runner_cache.lookup(key, self.tenant)
        if hit is not None:
            self.stats.cache_hits += 1
            return hit.compiled, 0.0, 0
        self.stats.runner_builds += 1
        t0 = time.perf_counter()
        asg = full_shape[1][1] if eb == "auto" else None
        if self.mesh is None:
            runner = make_sim_runner(program, cfg, self.slot_capacity,
                                     warm_start=warm_in, batch=bool(batch),
                                     partition_backends=asg)
        else:
            self._check_mesh(cfg)
            runner = make_bsp_runner(program, self.mesh, cfg,
                                     self.slot_capacity, warm_start=warm_in,
                                     batch=bool(batch),
                                     partition_backends=asg)
        build_time = time.perf_counter() - t0
        self.stats.compile_time_total += build_time
        # a rank of a mesh allocates the blocks of its one partition
        n_local = self.pg.n_parts if self.mesh is None else 1
        entry = RunnerEntry(
            compiled=runner, shape_key=full_shape,
            program=type(program).__name__, compile_time=build_time,
            nbytes=runner_nbytes(program, n_local, self.pg.v_max,
                                 self.slot_capacity, max(batch, 1)))
        evicted = self._runner_cache.insert(key, entry, self.tenant)
        if evicted:
            self.stats.cache_evictions_lru += evicted
            self._prune_keepalive()
        self._sync_runner_bytes()
        return runner, build_time, evicted

    def _sync_runner_bytes(self) -> None:
        self.stats.runner_cache_bytes = self._runner_cache.total_bytes

    def _evict_lru(self, cache: OrderedDict, bound: Optional[int],
                   max_bytes: Optional[int] = None) -> int:
        """Pop least-recently-used entries until ``cache`` fits ``bound``
        and its bytes fit ``max_bytes`` (the most recent entry always
        stays); returns how many went."""
        evicted = 0
        if bound is not None:
            while len(cache) > bound:
                cache.popitem(last=False)
                evicted += 1
        if max_bytes is not None:
            total = sum(e.nbytes for e in cache.values())
            while total > max_bytes and len(cache) > 1:
                total -= cache.popitem(last=False)[1].nbytes
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
        ns = self._n_edge_shards(cfg)
        # billed on the bucketed exchange height the runner reduces; the
        # simulator always reduces the dense buffer
        total_bytes = steps * _exchange_bytes_per_step(
            cfg if self.mesh is not None else EngineConfig(),
            self.slot_capacity, K, program.dtype, pg.n_parts, ns)
        lay = pg.edge_layouts
        epp = pg.edges_per_part.astype(np.int64)
        asg = self._resolve_assignment(program, cfg) if eb == "auto" \
            else None
        if self.mesh is not None:
            # every rank has its own clock: the mesh's slowest rank is the
            # query's time, the same on every rank, so the monitor fed
            # from it triggers on every rank at once
            wall = self._mesh_max(wall, cfg)
        # per-partition sweep time: the wall time apportioned by each
        # partition's flops share (partitions run lock-step supersteps, so
        # the flops skew is the critical-path skew the monitor reads)
        flops_pp = sweeps * _flops_per_sweep(program, eb, pg, lay, asg,
                                             n_edge_shards=ns)
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
        if eb == "pallas_tiles" and lay is not None and self.mesh is not None:
            # a rank realizes only its own tiles: count from the geometry
            st.tile_density, dens = lay.geometric_density()
        elif eb == "pallas_tiles" and lay is not None:
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

    def _mesh_all(self, flag: bool, cfg: EngineConfig) -> bool:
        """Whether ``flag`` holds on every rank of the mesh (``flag``
        itself without one): a host decision read from a rank's own clock
        agrees on every rank before the collectives that follow it."""
        if self.mesh is None:
            return flag
        import torch.distributed as dist
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN,
                        group=self._placement(cfg).mesh_group)
        return bool(t.item())

    def _mesh_max(self, seconds: float, cfg: EngineConfig) -> float:
        """The maximum of ``seconds`` over every rank of the mesh."""
        import torch.distributed as dist
        t = torch.tensor([seconds], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=self._placement(cfg).mesh_group)
        return float(t.item())

    def _remember(self, program, wkey, res):
        """Cache this converged result as the warm seed for the next
        identical query: one copy of it, which the caller's ``res`` does not
        share, with the padded rows set to the combiner identity. Its global
        array waits for a first read (``_WarmEntry.global_values``)."""
        if self._warm_plan is None or \
                self._warm_plan[0] != self._host_version:
            self._warm_plan = (self._host_version, _CollectPlan.of(self.pg))
        plan = self._warm_plan[1]
        blk = torch.from_numpy(res if res.ndim == 3 else res[..., None])
        # torch copies and fills on every core; numpy on one
        blk = blk.clone(memory_format=torch.contiguous_format)
        blk.view(-1, blk.shape[2]).index_fill_(
            0, plan.pad_rows, np.asarray(program.identity, res.dtype).item())
        self._warm[wkey] = _WarmEntry(
            device_block=blk.numpy(), identity=program.identity, plan=plan,
            tail=res.shape[2:], stats=self.stats,
            device_epoch=self._warm_epoch, polarity=program.warm_under)
        self._warm.move_to_end(wkey)
        self.stats.warm_evictions += self._evict_lru(
            self._warm, self.max_warm_entries, self.max_warm_bytes)
        self._prune_remap_log()
        self._sync_warm_bytes()

    # ------------------------------------------------------------------ #
    # streaming lifecycle
    # ------------------------------------------------------------------ #
    def _require_buffer(self, what: str) -> DeltaBuffer:
        self._check_open()
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

        def key_now(backend, ns):
            # the layout key now, at the entry's own shard count; None when
            # the graph no longer splits into that many edge shards
            try:
                return lay.shape_key(backend, n_shards=ns, pg=self.pg)
            except ValueError:
                return None

        def stale(e: RunnerEntry) -> bool:
            base, lkey = e.shape_key
            if base != cur:
                return True
            if lkey is None:
                return False
            if not have_lay:
                return True
            if lkey[0] == "auto":
                _, asg, tk, wk = lkey
                ns = tk[1] if len(tk) == 5 else 1
                if (tk, wk) != (key_now("pallas_tiles", ns),
                                key_now("pallas_windows", ns)):
                    return True
                # a re-resolved pin with other picks stales the runner
                pin = self._auto_pin.get(
                    (cur, lay.shape_key("pallas_tiles"),
                     lay.shape_key("pallas_windows")))
                return pin is not None and pin != asg
            backend = "pallas_tiles" if lkey[0] == "tiles" \
                else "pallas_windows"
            return lkey != key_now(backend, lkey[1] if len(lkey) == 5 else 1)

        # on a shared cache this releases the session's pins: a tenant
        # leaving a bucket never invalidates its neighbours' runners
        self.stats.cache_evictions_shape += self._runner_cache.release_stale(
            self.tenant, stale)
        self._sync_runner_bytes()
        self._prune_keepalive()
        # keyed by (P, or 1 on a mesh rank, v_max, ...)
        self._identity_blocks = {
            k: v for k, v in self._identity_blocks.items()
            if k[1] == self.pg.v_max}

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def cache_info(self) -> list:
        """Snapshot of the runner cache in LRU order (next to be evicted
        first): per entry the program type, the (padded shape, layout) key
        it was built for, its hits, its build time, its estimated device
        bytes (what ``max_runner_bytes`` evicts against) and the tenants
        pinning it (more than one on a pool-shared cache)."""
        return self._runner_cache.info()
