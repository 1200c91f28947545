"""GraphSession — the resident-graph query API of the port.

    sess = GraphSession.from_graph(g, n_parts=16)          # on the CUDA card
    dist, st = sess.query(SSSP(), {"source": 0})           # builds a runner
    dist, st = sess.query(SSSP(), {"source": 7})           # runner cache hit
    dist, st = sess.query(SSSP(), {"source": 0})           # warm restart

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

This session is read-only: ``update``/``flush``/``compact``/``rebalance``
and ``query_batch`` raise ``NotImplementedError`` naming the ROADMAP item
that will port them. Only the simulator backend exists; a ``mesh`` is
refused.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core.api import VertexProgram, numpy_dtype
from repro_torch.core.engine import (EngineConfig, _check_supported,
                                     _device_subgraph, _flops_per_sweep,
                                     _layout_block_from, _warm_block,
                                     make_sim_runner, normalize_edge_backend,
                                     run_sim)
from repro_torch.core.graph import Graph
from repro_torch.core.metrics import ExecutionStats
from repro_torch.core.partition import PARTITIONERS, STREAM_ROUTERS
from repro_torch.core.subgraph import (PartitionedGraph, ShapePolicy,
                                       build_partitioned_graph)
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["GraphSession", "SessionStats", "ShapePolicy"]

_MUTATION_TODO = ("the port's GraphSession is read-only for now: {what} "
                  "waits for ROADMAP Queue 1, streaming and session mutation")


@dataclasses.dataclass
class _WarmEntry:
    """Last converged result of one (program, params) query:
    ``global_values`` [n_vertices(, K)] and ``device_block`` [P, v_max, K]
    (numpy, combiner identity at padded rows)."""
    global_values: np.ndarray
    device_block: np.ndarray

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
    uploads: int = 0               # device-graph uploads
    compile_time_total: float = 0.0
    cache_evictions_lru: int = 0   # runners dropped by max_runners
    warm_evictions: int = 0        # warm results dropped by max_warm_entries
    warm_cache_bytes: int = 0      # host bytes of the warm-result memory
    host_syncs: int = 0            # device->host reads across all queries
    tile_density_min: float = 0.0
    tile_density_mean: float = 0.0
    tile_density_max: float = 0.0


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

    ``shape_policy`` governs the padded shapes as in the reference;
    ``bucket_slots`` builds runners on the policy's bucketed slot capacity
    (what the reference does for sessions that can stream updates).
    ``max_runners`` / ``max_warm_entries`` bound the runner cache and the
    warm-result memory with LRU eviction (``None`` = unbounded)."""

    def __init__(self, pg: PartitionedGraph, *, mesh=None,
                 cfg: Optional[EngineConfig] = None,
                 pad_multiple: Optional[int] = None,
                 shape_policy: Optional[ShapePolicy] = None,
                 bucket_slots: bool = False,
                 max_runners: Optional[int] = 32,
                 max_warm_entries: Optional[int] = 64,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "the shard_map backend is not ported yet (ROADMAP Queue 1: "
                "multi-GPU backend over torch.distributed)")
        self.device = resolve_device(device)
        self.pg = pg
        self.cfg = self._normalize_cfg(cfg or EngineConfig())
        self.shape_policy = self._resolve_policy(shape_policy, pad_multiple)
        self._bucket_slots = bucket_slots
        self.max_runners = max_runners
        self.max_warm_entries = max_warm_entries
        self.stats = SessionStats()
        self._device_graph = None
        self._runners: OrderedDict = OrderedDict()
        self._warm: OrderedDict = OrderedDict()
        self._identity_blocks: dict = {}
        self._keepalive: dict = {}

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
        policy (and bucketed slot capacity), the others exact padding."""
        dev = resolve_device(device)
        if shape_policy is None and partitioner not in STREAM_ROUTERS:
            shape_policy = ShapePolicy.exact(
                8 if pad_multiple is None else pad_multiple)
        policy = cls._resolve_policy(shape_policy, pad_multiple)
        if partitioner not in PARTITIONERS:
            raise ValueError(
                f"partitioner={partitioner!r}: the port has "
                f"{sorted(PARTITIONERS)} (EBV waits for ROADMAP Queue 1, "
                "balanced vertex-cut)")
        part = PARTITIONERS[partitioner](g, n_parts, seed=seed)
        pg = build_partitioned_graph(g, part, n_parts, shape_policy=policy)
        return cls(pg, mesh=mesh, cfg=cfg, shape_policy=policy,
                   bucket_slots=partitioner in STREAM_ROUTERS, device=dev,
                   **kwargs)

    @staticmethod
    def _normalize_cfg(cfg: EngineConfig) -> EngineConfig:
        """Without a mesh the session serves on the simulator backend."""
        if cfg.backend != "sim":
            cfg = dataclasses.replace(cfg, backend="sim")
        return cfg

    @property
    def slot_capacity(self) -> int:
        if not self._bucket_slots:
            return int(self.pg.n_slots)
        return self.shape_policy.slot_capacity(self.pg.n_slots)

    @property
    def shape_key(self):
        pg = self.pg
        return (pg.n_parts, pg.v_max, pg.e_max, self.slot_capacity,
                pg.vlabel is not None)

    def device_graph(self):
        """The resident stacked DeviceSubgraph, uploaded on first use."""
        if self._device_graph is None:
            self._device_graph = _device_subgraph(self.pg, self.device)
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
        uncached ``run_sim``."""
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
        _check_supported(cfg, eb)
        warm_in = bool(program.monotone)
        sgs = self.device_graph()
        lay = self._layout_arg(program, eb) if eb != "coo" else None
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
        stats = self._execution_stats(program, steps, msgs, sweeps, wall,
                                      compile_time, eb)
        stats.host_syncs = syncs + 1
        if program.monotone:
            self._remember(program, wkey, res)
        return res, stats

    def _layout_arg(self, program, eb):
        lay = self.pg.ensure_edge_layouts(shape_policy=self.shape_policy)
        return _layout_block_from(lay, self.pg, program, eb, self.device)

    def _layout_key(self, eb):
        if eb == "coo" or self.pg.edge_layouts is None:
            return None
        return self.pg.edge_layouts.shape_key(eb)

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
        blk = entry.device_block
        if blk.shape != (pg.n_parts, pg.v_max, K):
            blk = _warm_block(program, pg, entry.global_values)
        return torch.from_numpy(np.ascontiguousarray(blk)).to(self.device)

    def _get_runner(self, program, pkey, params, cfg, warm_in, eb):
        """Cached runner for this (program, param structure, config,
        shapes); returns ``(runner, build_seconds)`` (0.0 on a hit)."""
        full_shape = (self.shape_key, self._layout_key(eb))
        key = (pkey, params_struct_key(params), cfg, full_shape, warm_in)
        hit = self._runners.get(key)
        if hit is not None:
            self._runners.move_to_end(key)
            self.stats.cache_hits += 1
            return hit, 0.0
        self.stats.runner_builds += 1
        t0 = time.perf_counter()
        runner = make_sim_runner(program, cfg, self.slot_capacity,
                                 warm_start=warm_in)
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
            live = {k[0][1] for k in self._runners} | \
                   {wk[0][1] for wk in self._warm}
            self._keepalive = {i: p for i, p in self._keepalive.items()
                               if i in live}
        return evicted

    def _execution_stats(self, program, steps, msgs, sweeps, wall,
                         compile_time, eb) -> ExecutionStats:
        pg = self.pg
        K = program.payload
        itemsize = numpy_dtype(program.dtype).itemsize
        total_bytes = steps * (self.slot_capacity + 1) * K * itemsize \
            * pg.n_parts
        lay = pg.edge_layouts
        epp = pg.edges_per_part.astype(np.int64)
        flops_pp = sweeps * _flops_per_sweep(program, eb, pg, lay)
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
            partition_sweep_time=[float(x) for x in wall * share])
        if eb == "pallas_tiles" and lay is not None:
            spec = program.sweep_spec
            st.tile_density = lay.density(pg, spec.semiring,
                                          spec.edge_values, program.dtype)
            dens = lay.partition_density(pg, spec.semiring,
                                         spec.edge_values, program.dtype)
            st.partition_tile_density = [float(x) for x in dens]
            self.stats.tile_density_min = float(dens.min())
            self.stats.tile_density_mean = float(dens.mean())
            self.stats.tile_density_max = float(dens.max())
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
            device_block=blk)
        self._warm.move_to_end(wkey)
        self.stats.warm_evictions += self._evict_lru(self._warm,
                                                     self.max_warm_entries)
        self.stats.warm_cache_bytes = sum(e.nbytes
                                          for e in self._warm.values())

    # ------------------------------------------------------------------ #
    # not ported yet
    # ------------------------------------------------------------------ #
    def query_batch(self, program, params_list, **kwargs):
        raise NotImplementedError(
            "query_batch waits for ROADMAP Queue 1, serving/batching")

    def update(self, adds=None, deletes=None):
        raise NotImplementedError(_MUTATION_TODO.format(what="update()"))

    def flush(self):
        raise NotImplementedError(_MUTATION_TODO.format(what="flush()"))

    def compact(self):
        raise NotImplementedError(_MUTATION_TODO.format(what="compact()"))

    def rebalance(self, **kwargs):
        raise NotImplementedError(
            "rebalance() waits for ROADMAP Queue 1, balanced vertex-cut")
