"""SVHM BSP engine (paper §4): the simulator on one device and the
``shard_map`` backend over ``torch.distributed``.

Executes a ``VertexProgram`` over a ``PartitionedGraph`` in bulk-synchronous
supersteps:

  superstep =  apply merged frontier data (paper: incoming messages M_i)
             → iterate local sweeps to a fixed point    ["think like a graph"]
             → emit frontier contributions ΔD_i
             → SBS combine over the stacked partitions (§4.3)
             → vote-to-halt when no partition changed anything and no
               messages are pending.

``mode='vc'`` bounds local iteration at one hop — the vertex-centric
baseline; ``mode='sc'`` iterates to the local fixed point.

All P partitions live stacked on one device as ``[P, ...]`` tensors. The
local phase is the stacked loop with select-frozen partitions
(``_batched_local_phase``): every sweep runs the whole stack — the semiring
product flattened over P into one scatter (``coo``) or one kernel launch
(``pallas_tiles``: ``bsp_spmv``; ``pallas_windows``:
``segment_combine_windowed``), or under ``edge_backend='auto'`` one of each
per backend group of partitions (``_mixed_product``, on group-sliced
device lists) — and a partition whose local fixed point is
reached keeps its state while the others continue, so per-partition sweep
counts equal those of the JAX package's vmapped ``_local_phase``. The
``while`` loops are Python loops; each local sweep and each superstep reads
one flag from the device (``ExecutionStats.host_syncs`` counts them).
Trace mode (``cfg.trace``) can write BSP checkpoints every
``cfg.checkpoint_every`` supersteps and resume from one
(``run_sim(resume_from=...)``), in the JAX package's ``.npz`` layout.

The backend names ``pallas_tiles``/``pallas_windows`` are kept from the
reference so configurations carry across; here they select the CUDA
kernels. ``edge_backend='auto'`` picks a backend per partition from the
calibration table of the device (``core/autotune.py``,
``resolve_partition_backends``).

``backend='shard_map'`` (``make_bsp_runner`` / ``run_shard_map``) keeps
the reference's name and semantics but runs SPMD: every rank of a
``torch.distributed`` job runs the same program on its own block of a
``DeviceMesh`` (``core/mesh.py``) — one partition, and under
``cfg.edge_axes`` one contiguous chunk of its edge columns — as a stacked
``DeviceSubgraph`` of one, so ``_batched_local_phase`` and the device
lists apply unchanged. SBS is an ``all_reduce`` with the program's
combiner over the subgraph process group (``sbs.ShardExchange``), or the
compacted all-gather (``cfg.sparse_sync_capacity``), or the slot-sharded
exchange (``cfg.shard_slots``); ``EdgeCombine`` all-reduces edge-derived
aggregates over the edge group. Each superstep reads one host value,
``(messages, active partitions)`` all-reduced as one int32 pair, so every
rank halts at the same superstep; at the end results and sweep counts are
all-gathered, and every rank returns the global ``[P, ...]`` results.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import sbs
from repro_torch.core.api import (DeviceSubgraph, SemiringSweep,
                                  VertexProgram, coo_semiring_product,
                                  numpy_dtype)
from repro_torch.core.layouts import EdgeLayouts, TileBlock, WindowBlock
from repro_torch.core.mesh import placement
from repro_torch.core.metrics import ExecutionStats, span
from repro_torch.core.subgraph import PartitionedGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.bsp_spmv import TM, TN, bsp_spmv
from repro_torch.kernels.ref import combine_identity, tile_pad_identity
from repro_torch.kernels.segment_combine import W, segment_combine_windowed
from repro_torch.npz_io import load_flat, save_flat

__all__ = ["EngineConfig", "EdgeCombine", "ShardStep", "run", "run_sim",
           "run_shard_map", "make_sim_runner", "make_bsp_runner",
           "resolve_edge_backend", "normalize_edge_backend",
           "resolve_partition_backends", "resolve_mesh_backends",
           "params_to_device", "save_checkpoint", "load_checkpoint"]


class EdgeCombine:
    """Merges edge-parallel partial aggregates inside a partition. Programs
    call ``ec.sum/min/max`` on every value derived from a reduction over
    the partition's edges. With no ``group`` (the simulator, or a mesh
    without edge sharding) every partition's edges are local and this is
    the identity; under ``shard_map`` with ``edge_axes`` it all-reduces
    over the edge group, the ranks holding the partition's edge shards.
    ``calls`` counts the collectives issued, ``bytes`` their payload bytes
    by kind, as ``sbs.ShardExchange`` does."""

    def __init__(self, group=None):
        self.group = group
        self.calls = 0
        self.bytes = {"all_reduce": 0, "all_gather": 0}

    def _reduce(self, x, combiner: str):
        if self.group is None:
            return x
        self.calls += 1
        self.bytes["all_reduce"] += x.numel() * x.element_size()
        return sbs.all_combine(x, combiner, self.group)

    def sum(self, x):
        return self._reduce(x, "sum")

    def min(self, x):
        return self._reduce(x, "min")

    def max(self, x):
        return self._reduce(x, "max")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration — the reference's fields, values and
    validation."""

    mode: str = "sc"                  # 'sc' | 'vc'
    max_local_iters: int = 10_000     # straggler bound
    max_supersteps: int = 100_000
    backend: str = "sim"              # 'sim' | 'shard_map'
    edge_backend: str = "coo"         # 'coo' | 'pallas_tiles' |
                                      # 'pallas_windows' | 'auto'
    trace: bool = False               # per-superstep stats
    sparse_sync_capacity: int = 0     # >0: compacted all-gather SBS
                                      # (shard_map)
    shard_slots: bool = False         # shard the SBS buffer over edge_axes
    lean_frontier: bool = False       # detect changes vs the merged view
    subgraph_axes: tuple = ("sub",)   # mesh axes carrying partitions
    edge_axes: tuple = ()             # mesh axes sharding edges in-partition
    checkpoint_every: int = 0         # supersteps; 0 = off (trace mode)
    checkpoint_dir: Optional[str] = None

    _MODES = ("sc", "vc")
    _BACKENDS = ("sim", "shard_map")
    _CONCRETE_EDGE_BACKENDS = ("coo", "pallas_tiles", "pallas_windows")
    _EDGE_BACKENDS = _CONCRETE_EDGE_BACKENDS + ("auto",)

    def __post_init__(self):
        if self.mode not in self._MODES:
            raise ValueError(
                f"EngineConfig.mode={self.mode!r}: allowed values are "
                f"{self._MODES}")
        if self.backend not in self._BACKENDS:
            raise ValueError(
                f"EngineConfig.backend={self.backend!r}: allowed values are "
                f"{self._BACKENDS}")
        if self.edge_backend not in self._EDGE_BACKENDS:
            raise ValueError(
                f"EngineConfig.edge_backend={self.edge_backend!r}: allowed "
                f"values are {self._EDGE_BACKENDS}")
        for name in ("subgraph_axes", "edge_axes"):
            axes = getattr(self, name)
            if isinstance(axes, str) or not all(
                    isinstance(a, str) for a in tuple(axes)):
                raise ValueError(
                    f"EngineConfig.{name}={axes!r} must be a tuple of mesh "
                    f"axis names, e.g. ('pod', 'data')")
            object.__setattr__(self, name, tuple(axes))
        for name in ("max_local_iters", "max_supersteps"):
            if getattr(self, name) < 1:
                raise ValueError(f"EngineConfig.{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        for name in ("sparse_sync_capacity", "checkpoint_every"):
            if getattr(self, name) < 0:
                raise ValueError(f"EngineConfig.{name} must be >= 0, got "
                                 f"{getattr(self, name)}")

    @property
    def local_bound(self) -> int:
        return 1 if self.mode == "vc" else self.max_local_iters


# --------------------------------------------------------------------------- #
def _device_subgraph(pg: PartitionedGraph, device,
                     block=None) -> DeviceSubgraph:
    """Stacked [P, ...] DeviceSubgraph on ``device``; with ``block = (part,
    shard, n_shards)`` only a ``shard_map`` rank's block: a stack of one
    holding partition ``part``'s vertex tables and its edge columns
    ``[shard * Se, (shard + 1) * Se)``, ``Se = e_max / n_shards``."""
    if pg.n_vertices >= 2**31:
        raise ValueError("vertex ids must fit int32 on the device")
    rows, cols = slice(None), slice(None)
    if block is not None:
        part, shard, n_shards = block
        if pg.e_max % n_shards:
            raise ValueError(f"e_max={pg.e_max} must divide by the "
                             f"{n_shards} edge shards")
        se = pg.e_max // n_shards
        rows, cols = slice(part, part + 1), slice(shard * se,
                                                  (shard + 1) * se)
    vid32 = pg.gvid[rows].astype(np.int64)
    vid32[~pg.vmask[rows]] = np.iinfo(np.int32).max

    def t(a, edge=False):
        a = a[rows, cols] if edge else a[rows]
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DeviceSubgraph(
        esrc=t(pg.esrc, True), edst=t(pg.edst, True), ew=t(pg.ew, True),
        emask=t(pg.emask, True), slot=t(pg.slot), vmask=t(pg.vmask),
        vid32=torch.from_numpy(vid32.astype(np.int32)).to(device),
        is_frontier=t(pg.is_frontier), out_deg=t(pg.out_deg),
        in_deg=t(pg.in_deg), is_master=t(pg.is_master),
        vlabel=None if pg.vlabel is None else t(pg.vlabel),
    )


def params_to_device(params, device):
    """``params`` with every array leaf (``ndim >= 1``, numpy or torch) a
    tensor on ``device`` of its own dtype; scalars stay as they are. Dicts,
    lists and tuples keep their structure."""
    if isinstance(params, dict):
        return {k: params_to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to_device(v, device) for v in params)
    if isinstance(params, torch.Tensor):
        return params.to(device) if params.dim() else params
    if isinstance(params, np.ndarray) and params.ndim:
        return torch.from_numpy(np.ascontiguousarray(params)).to(device)
    return params


# --------------------------------------------------------------------------- #
# Edge-compute backends
# --------------------------------------------------------------------------- #
def resolve_edge_backend(program: VertexProgram, cfg: EngineConfig) -> str:
    """The backend this (program, config) pair actually runs: declarative
    ``sweep_spec`` programs run on ``cfg.edge_backend``; hand-rolled sweeps
    run on the first backend they declare unless they support the asked
    one; a hand-rolled sweep that declares nothing is refused."""
    declared = program.supports_edge_backends
    if declared is not None:
        allowed = EngineConfig._CONCRETE_EDGE_BACKENDS
        unknown = tuple(b for b in declared if b not in allowed)
        if unknown or not declared:
            raise ValueError(
                f"{type(program).__name__}.supports_edge_backends={declared!r}"
                f" contains unknown backends {unknown!r}; allowed values are "
                f"{allowed}")
        if cfg.edge_backend in declared:
            return cfg.edge_backend
        return declared[0]
    if program.sweep_spec is not None:
        return cfg.edge_backend
    raise ValueError(
        f"{type(program).__name__} overrides sweep but does not declare "
        "supports_edge_backends: a hand-rolled sweep must name the edge "
        "backends it implements (e.g. supports_edge_backends = ('coo',))")


def normalize_edge_backend(program: VertexProgram,
                           cfg: EngineConfig) -> tuple:
    """``(resolved backend, config rewritten to it)``."""
    eb = resolve_edge_backend(program, cfg)
    if eb != cfg.edge_backend:
        cfg = dataclasses.replace(cfg, edge_backend=eb)
    return eb, cfg


def resolve_partition_backends(program: VertexProgram, cfg: EngineConfig,
                               pg: PartitionedGraph, *, lay=None,
                               table=None, device: DeviceLike = None
                               ) -> tuple:
    """Per-partition concrete backend assignment. Uniform (non-``'auto'``)
    configs broadcast the resolved backend; ``'auto'`` consults the
    calibration table of ``device``'s platform (``core/autotune.py``) over
    the partitions' layout-geometry unit counts. Deterministic for a given
    (table, geometry); sessions also pin the assignment per shape bucket."""
    eb = resolve_edge_backend(program, cfg)
    if eb != "auto":
        return (eb,) * pg.n_parts
    from repro_torch.core import autotune
    if lay is None:
        lay = pg.ensure_edge_layouts()
    if table is None:
        table = autotune.get_table(device=device)
    return autotune.pick_backends(table, pg, lay)


def _tile_inputs(blk: TileBlock, vals: torch.Tensor, spec: SemiringSweep,
                 v_max: int) -> tuple:
    """The ``bsp_spmv`` arguments for the stacked [P, v_max, K] values: the
    compact tile list of every partition goes into ONE launch (its ids are
    offset by partition in the layout), and the values are padded to whole
    source tiles with the semiring's absorbing pad. Returns ``(tiles,
    tile_dst, tile_src, vals, n_dst_tiles, plan)``."""
    ident = tile_pad_identity(spec.semiring, numpy_dtype(vals.dtype)).item()
    if not vals.dtype.is_floating_point:
        # integer min_plus: pads are ADDED to values — clamp so that
        # ident + ident cannot wrap (sound below 2**30)
        vals = torch.clamp(vals, max=ident)
    ndt = max(-(-v_max // TM), 1)
    nst = max(-(-v_max // TN), 1)
    P, _, K = vals.shape
    v = torch.full((P, nst * TN, K), ident, dtype=vals.dtype,
                   device=vals.device)
    v[:, :v_max] = vals
    return (blk.tiles, blk.tile_dst, blk.tile_src, v.reshape(P * nst, TN, K),
            P * ndt, blk.plan)


def _tile_product(blk: TileBlock, vals: torch.Tensor, spec: SemiringSweep,
                  v_max: int) -> torch.Tensor:
    """Semiring product of the stacked [P, v_max, K] values through one
    ``bsp_spmv`` launch."""
    P, _, K = vals.shape
    tiles, td, ts, v, n_dst, plan = _tile_inputs(blk, vals, spec, v_max)
    out = bsp_spmv(tiles, td, ts, v, n_dst_tiles=n_dst,
                   semiring=spec.semiring, plan=plan)
    return out.reshape(P, -1, K)[:, :v_max]


def _edge_messages(sg: DeviceSubgraph, spec: SemiringSweep,
                   vals: torch.Tensor, esrc, ew) -> torch.Tensor:
    """Per-edge semiring messages ``vals[src] (+|*) ev`` ([P, e_max, K];
    padding edges are computed too — their buffer slot is dropped)."""
    sv = sg.gather(vals, esrc)
    if spec.edge_values == "weight":
        ev = ew.to(vals.dtype)[..., None]
        return sv + ev if spec.semiring == "min_plus" else sv * ev
    if spec.edge_values == "zero":
        return sv if spec.semiring == "min_plus" else torch.zeros_like(sv)
    # 'one': * 1 is the identity, but + 1 is NOT — min_plus over unit edge
    # values is hop counting; the COO product and the tile layouts add it
    return sv + 1 if spec.semiring == "min_plus" else sv


def _window_inputs(sg: DeviceSubgraph, blk: WindowBlock,
                   vals: torch.Tensor, spec: SemiringSweep,
                   v_max: int) -> tuple:
    """The ``segment_combine_windowed`` arguments for the stacked
    [P, v_max, K] values: the per-edge messages are copied into an
    identity-filled buffer of the compact block list at the slots the
    layout precomputed (padding edges go to a dump row past the end — the
    reference's ``mode="drop"`` scatter); the window ids are already offset
    by partition, so ONE launch reduces all P partitions. Returns ``(msgs,
    local_dst, block_window, n_windows, plan)``."""
    ident = combine_identity(spec.combiner, numpy_dtype(vals.dtype)).item()
    nw = max(-(-v_max // W), 1)
    msgs = _edge_messages(sg, spec, vals, sg.esrc, sg.ew)
    P, _, K = vals.shape
    buf = torch.full((blk.ldst.shape[0] + 1, K), ident, dtype=vals.dtype,
                     device=vals.device)
    buf.index_copy_(0, blk.slot, msgs.reshape(-1, K))
    return buf[:-1], blk.ldst, blk.bwin, P * nw, blk.plan


def _window_product(sg: DeviceSubgraph, blk: WindowBlock,
                    vals: torch.Tensor, spec: SemiringSweep,
                    v_max: int) -> torch.Tensor:
    """Semiring product of the stacked [P, v_max, K] values through one
    ``segment_combine_windowed`` launch."""
    P, _, K = vals.shape
    msgs, ldst, bwin, nw, plan = _window_inputs(sg, blk, vals, spec, v_max)
    out = segment_combine_windowed(msgs, ldst, bwin, n_windows=nw,
                                   combiner=spec.combiner, plan=plan)
    return out.reshape(P, -1, K)[:, :v_max]


def _check_tile_ids(program: VertexProgram, pg: PartitionedGraph) -> None:
    if not np.issubdtype(numpy_dtype(program.dtype), np.floating) \
            and pg.n_vertices >= 2**30:
        raise ValueError(
            "integer min_plus through the tile kernel clamps values to "
            "iinfo.max >> 1 (kernels/ref.py tile_pad_identity); ids must "
            "stay below 2**30")


def _layout_block_from(lay: EdgeLayouts, pg: PartitionedGraph,
                       program: VertexProgram, edge_backend: str, device):
    """Device layout tensors a kernel-backend runner takes as input."""
    spec = program.sweep_spec
    if edge_backend == "pallas_tiles":
        _check_tile_ids(program, pg)
        return lay.device_tiles(pg, spec.semiring, spec.edge_values,
                                program.dtype, device)
    return lay.device_windows(device)


def _assignment_groups(assignment) -> tuple:
    """Per-backend partition groups of an ``'auto'`` assignment:
    ``((backend, [P_g] int64 ascending indices), ...)`` in a fixed order."""
    groups = []
    for b in EngineConfig._CONCRETE_EDGE_BACKENDS:
        idx = np.asarray([p for p, a in enumerate(assignment) if a == b],
                         np.int64)
        if idx.size:
            groups.append((b, idx))
    return tuple(groups)


def _auto_layout_blocks(lay: EdgeLayouts, pg: PartitionedGraph,
                        program: VertexProgram, assignment, device):
    """Layout input of an ``'auto'`` runner: ``(tiles, windows)``, each the
    device list of just the partitions its backend owns (``None`` when it
    owns none), cached on the layouts like the full lists."""
    spec = program.sweep_spec
    t_idx = [p for p, b in enumerate(assignment) if b == "pallas_tiles"]
    w_idx = [p for p, b in enumerate(assignment) if b == "pallas_windows"]
    # a group of every partition is the uniform backend's full list
    t_grp = None if len(t_idx) == len(assignment) else t_idx
    w_grp = None if len(w_idx) == len(assignment) else w_idx
    t_blk = w_blk = None
    if t_idx:
        _check_tile_ids(program, pg)
        t_blk = lay.device_tiles(pg, spec.semiring, spec.edge_values,
                                 program.dtype, device, parts=t_grp)
    if w_idx:
        w_blk = lay.device_windows(device, parts=w_grp)
    return t_blk, w_blk


#: backend ids of an ``'auto'`` assignment on the wire (the reference's
#: ``lax.switch`` branch ids)
_BACKEND_IDS = {"coo": 0, "pallas_tiles": 1, "pallas_windows": 2}


def resolve_mesh_backends(program: VertexProgram, cfg: EngineConfig,
                          pg: PartitionedGraph, mesh, *, lay=None,
                          device: DeviceLike = None) -> tuple:
    """``resolve_partition_backends`` for a ``shard_map`` job: under
    ``'auto'`` the rank at the mesh's first coordinate resolves the
    assignment (a measured calibration runs there alone, or its cache file
    is read) and broadcasts it over the mesh, so every rank sweeps with
    the same picks; uniform configs broadcast nothing. Collective: every
    rank of the mesh calls it at the same point."""
    import torch.distributed as dist
    eb = resolve_edge_backend(program, cfg)
    if eb != "auto":
        return (eb,) * pg.n_parts
    pl = placement(mesh, cfg.subgraph_axes, cfg.edge_axes)
    dev = resolve_device(device)
    ids = torch.zeros(pg.n_parts, dtype=torch.int32, device=dev)
    if dist.get_rank() == pl.root:
        asg = resolve_partition_backends(program, cfg, pg, lay=lay,
                                         device=dev)
        ids = torch.tensor([_BACKEND_IDS[b] for b in asg],
                           dtype=torch.int32, device=dev)
    dist.broadcast(ids, src=pl.root, group=pl.mesh_group)
    names = {i: b for b, i in _BACKEND_IDS.items()}
    return tuple(names[i] for i in ids.tolist())


def _shard_layout_block(lay: EdgeLayouts, pg: PartitionedGraph,
                        program: VertexProgram, backend: str, device, pl):
    """A ``shard_map`` rank's device list for its partition's concrete
    ``backend`` (None on ``coo``): the group list of its one partition,
    or under edge sharding the list of its (partition, shard)."""
    if backend == "coo":
        return None
    spec = program.sweep_spec
    parts = None if pg.n_parts == 1 else [pl.part]
    if backend == "pallas_tiles":
        _check_tile_ids(program, pg)
        if pl.n_edge > 1:
            return lay.device_tiles_sharded(
                pg, spec.semiring, spec.edge_values, program.dtype,
                pl.n_edge, device, pl.part, pl.shard)
        return lay.device_tiles(pg, spec.semiring, spec.edge_values,
                                program.dtype, device, parts=parts)
    if pl.n_edge > 1:
        return lay.device_windows_sharded(pg, pl.n_edge, device, pl.part,
                                          pl.shard)
    return lay.device_windows(device, parts=parts)


def _mixed_inputs(groups, sgs: DeviceSubgraph, lay_blks) -> list:
    """Per group ``(backend, index tensor, sub-stack, device list)`` for one
    runner call: the sub-stack (COO and windows groups) holds the group's
    rows of every graph tensor, sliced once and reused by every sweep."""
    t_blk, w_blk = lay_blks
    out = []
    for backend, idx in groups:
        gi = torch.from_numpy(idx).to(sgs.device)
        sub = None
        if backend != "pallas_tiles":
            sub = DeviceSubgraph(*[None if x is None else x.index_select(0, gi)
                                   for x in sgs])
        blk = {"coo": None, "pallas_tiles": t_blk,
               "pallas_windows": w_blk}[backend]
        if backend != "coo" and blk is None:
            raise ValueError(f"the 'auto' assignment has a {backend} group "
                             "but no device list for it")
        out.append((backend, gi, sub, blk))
    return out


def _mixed_product(spec: SemiringSweep, mix: list, v: torch.Tensor,
                   v_max: int) -> torch.Tensor:
    """Stacked [P, v_max, K] semiring product under a mixed per-partition
    assignment: one launch per backend group over its partition sub-stack,
    written back with ``index_copy_`` (the groups cover every partition, so
    every row is overwritten). Each partition gets the bits its backend
    gives it in a uniform run."""
    agg = torch.empty_like(v)
    for backend, gi, sub, blk in mix:
        vg = v.index_select(0, gi)
        if backend == "coo":
            part = coo_semiring_product(sub, spec, vg)
        elif backend == "pallas_tiles":
            part = _tile_product(blk, vg, spec, v_max)
        else:
            part = _window_product(sub, blk, vg, spec, v_max)
        agg.index_copy_(0, gi, part)
    return agg


def _state_where(live: torch.Tensor, new: dict, old: dict) -> dict:
    """Per-partition select over a state dict: ``new`` where ``live``."""
    out = {}
    for k, b in new.items():
        a = old[k]
        out[k] = torch.where(live.reshape((-1,) + (1,) * (b.dim() - 1)),
                             b, a)
    return out


def _any_live(live: torch.Tensor) -> bool:
    """The local phase's continue test: one flag read from the device."""
    with span("drone.engine.sync"):
        return bool(live.any())


def _batched_local_phase(program: VertexProgram, sgs: DeviceSubgraph,
                         lay_blk, params, state, merged_v,
                         ec: EdgeCombine, bound: int, first: bool,
                         edge_backend: str,
                         keep_going: Callable[[torch.Tensor], bool]
                         = _any_live):
    """apply incoming -> sweep the whole stack to every partition's local
    fixed point (or one hop). A partition whose fixed point is reached is
    select-frozen while the others continue, giving the per-partition sweep
    counts of the reference's vmapped ``_local_phase``. Under ``'auto'``
    ``lay_blk`` is the group list of ``_mixed_inputs``. ``keep_going(live)``
    decides, before each further sweep, whether to run it (``live`` the
    [P] partitions still below their fixed point and the bound): the
    engine reads the flag; the capacity dry run counts sweeps instead, so
    that a superstep runs with no host read. Returns ``(state, out,
    sweeps [P], last_changed [P], host_syncs)``."""
    if not first:       # superstep 0 has no incoming messages (Alg. 1)
        state = program.apply_frontier(sgs, params, state, merged_v, ec)[0]
    spec = program.sweep_spec
    v_max = sgs.v_max

    def sweep_all(st):
        if edge_backend == "coo":
            return program.sweep(sgs, params, st, ec)
        vals = program.sweep_values(sgs, params, st)
        squeeze = vals.dim() == 2
        v = vals[..., None] if squeeze else vals
        with span("drone.edge.product"):
            if edge_backend == "auto":
                agg = _mixed_product(spec, lay_blk, v, v_max)
            elif edge_backend == "pallas_tiles":
                agg = _tile_product(lay_blk, v, spec, v_max)
            else:
                agg = _window_product(sgs, lay_blk, v, spec, v_max)
        agg = ec.min(agg) if spec.semiring == "min_plus" else ec.sum(agg)
        if squeeze:
            agg = agg[..., 0]
        return program.sweep_fold(sgs, params, st, agg)

    with span("drone.engine.sweep"):
        state, ch = sweep_all(state)
    i = torch.ones(sgs.n_parts, dtype=torch.int32, device=sgs.device)
    syncs = 0
    while True:
        live = (ch > 0) & (i < bound)
        syncs += 1
        if not keep_going(live):
            break
        with span("drone.engine.sweep"):
            st2, ch2 = sweep_all(state)
        state = _state_where(live, st2, state)
        i = torch.where(live, i + 1, i)
        ch = torch.where(live, ch2, ch)
    out = program.frontier_out(sgs, params, state)
    return state, out, i, ch, syncs


def _warm_block(program: VertexProgram, pg: PartitionedGraph,
                init_state) -> np.ndarray:
    """Map a previous *global* converged result [n_vertices(, K)] into the
    [P, v_max, K] local layout — combiner identity at padded rows, cast to
    the program dtype on entry. Shorter arrays (the graph grew) are padded
    with the identity."""
    K = program.payload
    ident = program.identity
    dt = numpy_dtype(program.dtype)
    warm = np.asarray(init_state)
    if warm.ndim == 1:
        warm = warm[:, None]
    warm = warm.astype(dt, copy=False)
    if warm.shape[0] < pg.n_vertices:
        warm = np.concatenate(
            [warm, np.full((pg.n_vertices - warm.shape[0], warm.shape[1]),
                           ident, dtype=dt)])
    wv = np.full((pg.n_parts, pg.v_max, K), ident, dtype=dt)
    wv[pg.vmask] = warm[pg.gvid[pg.vmask]]
    return wv


def _exchange_bytes_per_step(cfg: EngineConfig, n_slots: int, K: int,
                             dtype, n_parts: int, n_edge_shards: int) -> int:
    """Collective bytes one superstep's SBS exchange moves, for the
    exchange the runner runs: the inter-partition (subgraph group)
    collective only, as the reference counts it (edge-group combines are
    left out, like the paper's network-message metric)."""
    itemsize = numpy_dtype(dtype).itemsize
    if cfg.shard_slots and n_edge_shards > 1:
        # each of the n_edge_shards slot slices is all-reduced over the
        # subgraph group: n_loc + 1 rows per rank, n_parts * n_edge_shards
        # ranks
        n_loc = -(-(n_slots + 1) // n_edge_shards)
        return (n_loc + 1) * K * itemsize * n_parts * n_edge_shards
    if cfg.sparse_sync_capacity > 0:
        # compacted all-gather: capacity (int32 idx, K-vector val) pairs
        cap = min(cfg.sparse_sync_capacity, n_slots + 1)
        return cap * (4 + K * itemsize) * n_parts
    return (n_slots + 1) * K * itemsize * n_parts


def _flops_per_sweep(program: VertexProgram, edge_backend: str,
                     pg: PartitionedGraph, lay: Optional[EdgeLayouts],
                     assignment=None, n_edge_shards: int = 1) -> np.ndarray:
    """[P] semiring ops one local sweep issues per partition: 2*K per
    resident edge on COO, the dense tile/block work on the kernels (every
    edge shard's list, fillers included, under edge sharding); under
    ``'auto'`` each partition at its assigned backend's rate."""
    K = program.payload
    flops = 2 * K * pg.edges_per_part.astype(np.int64)
    if edge_backend == "coo" or lay is None:
        return flops
    if edge_backend == "auto":
        asg = np.asarray(assignment)
        for b in ("pallas_tiles", "pallas_windows"):
            m = asg == b
            if m.any():
                flops[m] = lay.flops_per_sweep(
                    b, K, n_shards=n_edge_shards, pg=pg)[m]
        return flops
    return lay.flops_per_sweep(edge_backend, K, n_shards=n_edge_shards,
                               pg=pg)


# --------------------------------------------------------------------------- #
# Simulator backend
# --------------------------------------------------------------------------- #
def _make_sim_superstep(program: VertexProgram, cfg: EngineConfig,
                        n_slots: int, edge_backend: str = "coo"):
    """One BSP superstep over the stacked [P, ...] graph."""
    ident = program.identity
    ec = EdgeCombine()
    ex = sbs.SimExchange()

    def superstep(sgs, lay, params, state, last_out, merged_buf, first):
        merged_v = sbs.gather_merged(merged_buf, sgs.slot)
        state, out, sweeps, last_ch, syncs = _batched_local_phase(
            program, sgs, lay, params, state, merged_v, ec,
            cfg.local_bound, first, edge_backend)
        changed = program.changed_mask(out, last_out) & sgs.frontier
        bufs = sbs.scatter_combine(out, sgs.slot, changed, n_slots,
                                   program.combiner, ident)
        merged_buf = ex.all_combine(bufs, program.combiner)
        merged_buf[n_slots] = ident.item()
        msgs = changed.sum(dtype=torch.int32)
        active = (last_ch > 0).sum(dtype=torch.int32)
        return state, out, merged_buf, msgs, active, sweeps, syncs

    return superstep


def make_sim_runner(program: VertexProgram, cfg: EngineConfig, n_slots: int,
                    *, warm_start: bool = False, batch: bool = False,
                    partition_backends=None) -> Callable:
    """Build the simulator BSP loop

        runner(sgs, lay, params, warm=None, on_step=None, resume=None) ->
            (results, supersteps, total_messages, sweeps_per_part,
             host_syncs)

    ``sgs`` is the stacked DeviceSubgraph, ``lay`` the device layout
    (``TileBlock``/``WindowBlock``; None on ``coo``; under ``'auto'`` the
    group-sliced ``(tiles, windows)`` pair of ``_auto_layout_blocks`` for
    the ``partition_backends`` assignment the runner is built for, which
    ``'auto'`` requires), ``warm``
    (``warm_start=True``) a [P, v_max, K] previous-result tensor threaded
    into ``program.warm_init``. ``on_step(msgs, active, sweeps, carry)`` is
    called after every superstep (trace mode) with ``carry`` the loop state
    ``dict(state, last_out, merged, step)``; ``resume`` is such a carry to
    continue from (a BSP checkpoint). ``results`` stays on the device; the
    counts are host ints (``sweeps_per_part`` a [P] int64 array) and cover
    the supersteps this call ran.

    ``batch=True`` builds the micro-batching variant

        runner(sgs, lay, params_list, warm=None) ->
            (results [B, ...], supersteps [B], messages [B],
             sweeps [B, P], host_syncs)

    over ``B = len(params_list)`` lanes that share ``sgs`` / ``lay``, with
    ``warm`` a [B, P, v_max, K] stack (``warm_start=True``). On every
    backend it runs each lane's whole BSP loop in turn through the
    singleton superstep — what the reference's ``lax.scan`` branch does
    for its kernel backends — so each lane gets exactly its singleton's
    results, supersteps, messages and per-partition sweeps (which the
    reference's vmapped ``coo`` branch also guarantees). ``host_syncs`` is
    the lanes' sum. ``GraphSession.query_batch`` keys the runner by the
    lane count padded to a power of two but passes only the real lanes:
    the reference discards the pad lanes' outputs, so they are not run."""
    edge_backend = resolve_edge_backend(program, cfg)
    groups = None
    if edge_backend == "auto":
        if partition_backends is None:
            raise ValueError("edge_backend='auto' runners need the resolved "
                             "partition_backends assignment "
                             "(resolve_partition_backends)")
        groups = _assignment_groups(partition_backends)
    # one backend owning every partition sweeps as that backend's uniform
    # runner does: no sub-stacks, no write-back
    sweep_backend = groups[0][0] if groups and len(groups) == 1 \
        else edge_backend
    K = program.payload
    ident = program.identity.item()
    ec = EdgeCombine()
    superstep = _make_sim_superstep(program, cfg, n_slots, sweep_backend)

    def runner(sgs: DeviceSubgraph, lay, params, warm=None,
               on_step: Optional[Callable] = None, resume=None):
        with span("drone.engine.run"):
            if (warm is not None) != warm_start:
                raise ValueError(f"this runner was built with warm_start="
                                 f"{warm_start}; pass warm accordingly")
            dev = sgs.device
            dt = program.torch_dtype
            params = params_to_device(params, dev)
            if sweep_backend == "auto":
                lay = _mixed_inputs(groups, sgs, lay)
            elif groups is not None:
                lay = {"coo": None, "pallas_tiles": lay[0],
                       "pallas_windows": lay[1]}[sweep_backend]
            if resume is None:
                state = program.init(sgs, params, ec)
                if warm_start:
                    state = program.warm_init(sgs, params, state, warm)
                last_out = torch.full((sgs.n_parts, sgs.v_max, K), ident,
                                      dtype=dt, device=dev)
                merged_buf = torch.full((n_slots + 1, K), ident, dtype=dt,
                                        device=dev)
                step = 0
            else:
                state, last_out, merged_buf = (resume["state"],
                                               resume["last_out"],
                                               resume["merged"])
                step = int(resume["step"])
            tot_msgs = syncs = 0
            tot_sweeps = torch.zeros(sgs.n_parts, dtype=torch.int32,
                                     device=dev)
            msgs = active = 1
            while step == 0 or ((msgs > 0 or active > 0)
                                and step < cfg.max_supersteps):
                with span("drone.engine.superstep"):
                    state, last_out, merged_buf, m, a, sweeps, s = superstep(
                        sgs, lay, params, state, last_out, merged_buf,
                        step == 0)
                tot_sweeps += sweeps
                with span("drone.engine.sync"):
                    msgs, active = torch.stack([m, a]).tolist()
                syncs += s + 1
                tot_msgs += msgs
                step += 1
                if on_step is not None:
                    on_step(msgs, active, sweeps.cpu().numpy(),
                            dict(state=state, last_out=last_out,
                                 merged=merged_buf, step=step))
            results = program.result(sgs, params, state)
            return (results, step, tot_msgs,
                    tot_sweeps.cpu().numpy().astype(np.int64), syncs)

    if not batch:
        return runner

    def batched(sgs: DeviceSubgraph, lay, params_list, warm=None):
        if (warm is not None) != warm_start:
            raise ValueError(f"this runner was built with warm_start="
                             f"{warm_start}; pass warm accordingly")
        lanes = [runner(sgs, lay, p, None if warm is None else warm[i])
                 for i, p in enumerate(params_list)]
        res, steps, msgs, sweeps, syncs = zip(*lanes)
        return (torch.stack(res), np.asarray(steps, np.int64),
                np.asarray(msgs, np.int64), np.stack(sweeps), sum(syncs))

    return batched


# --------------------------------------------------------------------------- #
# shard_map backend (SPMD over torch.distributed)
# --------------------------------------------------------------------------- #
class ShardStep:
    """One ``shard_map`` rank's share of a BSP query over its block ``sgs``
    (a stacked ``DeviceSubgraph`` of one), built per query: the pieces of
    ``make_bsp_runner``'s loop, split out so that a superstep can run with
    no host read (the capacity dry run, ``launch/dryrun_graph.py``, runs
    them on fake tensors in a fake world of ranks).

      - ``start(warm)`` -> ``(state, merged_v, last_out)``: the initial
        state (warm-started when ``warm`` is given) and merged view;
      - ``self(state, merged_v, last_out, first, keep_going)`` -> one
        superstep, ``(state, merged_v, last_out, counts, sweeps,
        host_syncs)``: ``counts`` is the int32 pair ``(messages, active
        partitions)`` all-reduced over the subgraph group and left on the
        device, ``keep_going`` the local phase's continue test;
      - ``finish(state, tot_sweeps)`` -> the global [P, ...] results and
        [P] sweeps, all-gathered over the subgraph group in partition
        order (still on the device).

    ``ex`` (a ``sbs.ShardExchange`` over ``pl.sub_group``) and ``ec`` (an
    ``EdgeCombine`` over ``pl.edge_group``) count the collectives' calls
    and payload bytes; ``payload()`` sums their bytes by kind."""

    def __init__(self, program: VertexProgram, cfg: EngineConfig, pl,
                 n_slots: int, sweep_backend: str, sgs: DeviceSubgraph, lay,
                 params, ex: "sbs.ShardExchange", ec: EdgeCombine):
        self.program, self.cfg, self.pl = program, cfg, pl
        self.n_slots, self.sweep_backend = n_slots, sweep_backend
        self.sgs, self.lay, self.params, self.ex, self.ec = (
            sgs, lay, params, ex, ec)
        self.ident = program.identity
        self.S = pl.n_edge
        self.n_loc = -(-(n_slots + 1) // self.S)
        self.exchange = self._exchange_sharded \
            if cfg.shard_slots and self.S > 1 else self._exchange_dense
        self.slot = sgs.slot.long()
        self.own = (self.slot % self.S) == pl.shard

    def payload(self) -> dict:
        """Payload bytes both contexts' collectives moved so far, by kind."""
        return {k: self.ex.bytes[k] + self.ec.bytes[k] for k in self.ex.bytes}

    def _exchange_dense(self, out, changed):
        sgs, n_slots, ident = self.sgs, self.n_slots, self.ident
        buf = sbs.scatter_combine(out, sgs.slot, changed, n_slots,
                                  self.program.combiner, ident)[0]
        if self.cfg.sparse_sync_capacity > 0:
            merged = sbs.compact_allgather_exchange(
                buf, ident, self.program.combiner, n_slots,
                self.cfg.sparse_sync_capacity, self.ex)
        else:
            merged = self.ex.all_combine(buf, self.program.combiner)
        merged[n_slots] = ident.item()
        return sbs.gather_merged(merged, sgs.slot)

    def _exchange_sharded(self, out, changed):
        # frontier slots belong to the edge shard slot % S; the subgraph
        # all-reduce runs on that 1/S slice and the merged view is rebuilt
        # with an edge-group combine
        S, n_loc, slot, iv = self.S, self.n_loc, self.slot, self.ident.item()
        owned = changed & self.own
        slot_loc = torch.where(owned, slot // S, n_loc)
        buf = sbs.scatter_combine(out, slot_loc, owned, n_loc,
                                  self.program.combiner, self.ident)[0]
        merged = self.ex.all_combine(buf, self.program.combiner)
        gather_own = self.sgs.frontier & self.own
        mv = torch.where(gather_own[..., None],
                         merged[torch.clamp(slot // S, 0, n_loc)], iv)
        if self.program.combiner == "min":
            return self.ec.min(mv)
        if self.program.combiner == "max":
            return self.ec.max(mv)
        return self.ec.sum(torch.where(gather_own[..., None], mv,
                                       torch.zeros_like(mv)))

    def start(self, warm=None):
        program, sgs = self.program, self.sgs
        state = program.init(sgs, self.params, self.ec)
        if warm is not None:
            state = program.warm_init(sgs, self.params, state, warm)
        merged_v = torch.full((1, sgs.v_max, program.payload),
                              self.ident.item(), dtype=program.torch_dtype,
                              device=sgs.device)
        return state, merged_v, merged_v

    def __call__(self, state, merged_v, last_out, first: bool,
                 keep_going: Callable[[torch.Tensor], bool] = _any_live):
        program, sgs, cfg = self.program, self.sgs, self.cfg
        state, out, sweeps, last_ch, syncs = _batched_local_phase(
            program, sgs, self.lay, self.params, state, merged_v, self.ec,
            cfg.local_bound, first, self.sweep_backend, keep_going)
        ref = merged_v if cfg.lean_frontier else last_out
        changed = program.changed_mask(out, ref) & sgs.frontier
        merged_v = self.exchange(out, changed)
        counts = self.ex.all_sum(torch.stack([
            changed.sum(dtype=torch.int32),
            (last_ch > 0).sum(dtype=torch.int32)]))
        return state, merged_v, out, counts, sweeps, syncs

    def finish(self, state, tot_sweeps, gather_results: bool = True):
        """(results, sweeps): the global [P, ...] result and [P] sweeps
        all-gathered over the subgraph group, or with ``gather_results=
        False`` this rank's own [1, ...] block and [1] sweeps, with no
        collective (the reference's sharded ``out_specs``)."""
        res = self.program.result(self.sgs, self.params, state)
        if not gather_results:
            return res, tot_sweeps
        order = np.argsort(np.asarray(self.pl.sub_parts))  # rank -> part
        parts = self.ex.all_gather(res)
        sw = self.ex.all_gather(tot_sweeps)
        return (torch.cat([parts[i] for i in order]),
                torch.cat([sw[i] for i in order]))


def make_bsp_runner(program: VertexProgram, mesh, cfg: EngineConfig,
                    n_slots: int, *, warm_start: bool = False,
                    batch: bool = False,
                    partition_backends=None,
                    gather_results: bool = True) -> Callable:
    """Build this rank's ``shard_map`` BSP loop

        runner(sgs, lay, params, warm=None, on_step=None) ->
            (results, supersteps, total_messages, sweeps_per_part,
             host_syncs, collectives, payload_bytes)

    over the rank's block of ``mesh`` (``core/mesh.py``): ``sgs`` is its
    stacked ``DeviceSubgraph`` of one (``_device_subgraph(block=)``),
    ``lay`` its device list (``_shard_layout_block``; None on ``coo``),
    ``warm`` (``warm_start=True``) its [1, v_max, K] warm block. Every rank
    of the mesh calls the runner together. ``results`` is the global
    [P, v_max(, ...)] result on every rank, ``sweeps_per_part`` a [P]
    int64 array (with ``gather_results=False``: the rank's own [1,
    v_max(, ...)] block and its [1] sweeps, nothing gathered), ``collectives`` the collective calls this rank issued and
    ``payload_bytes`` their payload bytes by kind (``{"all_reduce": n,
    "all_gather": n}``: the bytes of the tensor the rank contributes, a
    bool as the uint8 it sends). ``on_step(msgs, active, sweeps, moved)``
    is called after every superstep with the rank's [1] sweeps tensor and
    the payload bytes that superstep moved, by kind. The superstep itself
    is ``ShardStep``.

    Per superstep, as the reference's ``shard_map`` body: apply the merged
    view, sweep to the local fixed point (``_batched_local_phase``; each
    edge-derived aggregate all-reduced over the edge group by
    ``EdgeCombine``), mark the frontier values that changed against the
    last emitted ones (or, with ``cfg.lean_frontier``, against the merged
    view), exchange — the dense buffer all-reduced over the subgraph
    group, or the compacted all-gather (``cfg.sparse_sync_capacity``), or
    with ``cfg.shard_slots`` each edge shard owning the slots ``slot %
    n_edge == shard`` and the merged view rebuilt over the edge group —
    then all-reduce ``(messages, active partitions)`` as one int32 pair:
    the superstep's one host read, the same on every rank, so every rank
    halts together. The local-sweep loop reads one flag per sweep; under
    edge sharding it agrees across the edge group, because each sweep's
    changed count comes from aggregates the group already reduced.

    Under ``'auto'`` each rank sweeps its partition with the backend the
    ``partition_backends`` assignment gives it (the reference's
    ``lax.switch`` on backend ids); the caller passes the same assignment
    on every rank (``resolve_mesh_backends``). ``batch=True`` builds

        runner(sgs, lay, params_list, warm=None) ->
            (results [B, ...], supersteps [B], messages [B],
             sweeps [B, P], host_syncs, collectives, payload_bytes)

    running the lanes in turn, as the reference's ``lax.scan`` over
    lanes does."""
    edge_backend = resolve_edge_backend(program, cfg)
    if edge_backend == "auto" and partition_backends is None:
        raise ValueError("edge_backend='auto' runners need the resolved "
                         "partition_backends assignment "
                         "(resolve_mesh_backends)")
    pl = placement(mesh, cfg.subgraph_axes, cfg.edge_axes)
    if edge_backend == "auto":
        sweep_backend = partition_backends[pl.part]
    else:
        sweep_backend = edge_backend

    def runner(sgs: DeviceSubgraph, lay, params, warm=None,
               on_step: Optional[Callable] = None):
        if (warm is not None) != warm_start:
            raise ValueError(f"this runner was built with warm_start="
                             f"{warm_start}; pass warm accordingly")
        if sgs.n_parts != 1:
            raise ValueError(f"a shard_map rank holds one partition's "
                             f"block, got {sgs.n_parts}")
        ex = sbs.ShardExchange(pl.sub_group)
        ec = EdgeCombine(pl.edge_group)
        params = params_to_device(params, sgs.device)
        rs = ShardStep(program, cfg, pl, n_slots, sweep_backend, sgs, lay,
                       params, ex, ec)
        state, merged_v, last_out = rs.start(warm)
        step = tot_msgs = syncs = 0
        msgs = active = 1
        tot_sweeps = torch.zeros(1, dtype=torch.int32, device=sgs.device)
        moved = rs.payload()
        while step == 0 or ((msgs > 0 or active > 0)
                            and step < cfg.max_supersteps):
            state, merged_v, last_out, counts, sweeps, s = rs(
                state, merged_v, last_out, step == 0)
            msgs, active = counts.tolist()
            tot_sweeps += sweeps
            tot_msgs += msgs
            syncs += s + 1
            step += 1
            if on_step is not None:
                now = rs.payload()
                on_step(msgs, active, sweeps,
                        {k: now[k] - moved[k] for k in now})
                moved = now
        results, sweeps_all = rs.finish(state, tot_sweeps, gather_results)
        return (results, step, tot_msgs,
                sweeps_all.cpu().numpy().astype(np.int64), syncs,
                ex.calls + ec.calls, rs.payload())

    if not batch:
        return runner

    def batched(sgs: DeviceSubgraph, lay, params_list, warm=None):
        if (warm is not None) != warm_start:
            raise ValueError(f"this runner was built with warm_start="
                             f"{warm_start}; pass warm accordingly")
        lanes = [runner(sgs, lay, p, None if warm is None else warm[i])
                 for i, p in enumerate(params_list)]
        res, steps, msgs, sweeps, syncs, calls, moved = zip(*lanes)
        return (torch.stack(res), np.asarray(steps, np.int64),
                np.asarray(msgs, np.int64), np.stack(sweeps), sum(syncs),
                sum(calls), {k: sum(m[k] for m in moved) for k in moved[0]})

    return batched


def run_shard_map(program: VertexProgram, pg: PartitionedGraph, mesh,
                  params=None, cfg: EngineConfig = EngineConfig(), *,
                  init_state=None, device: DeviceLike = None):
    """One-shot ``shard_map`` job on this rank's block of ``mesh`` (every
    rank holds the same host ``pg`` and calls this together). Uploads the
    rank's block to ``device``, runs, and returns ``(numpy results
    [P, v_max(, K)], ExecutionStats)`` — the global results on every rank.
    ``pg.n_parts`` must equal the subgraph axes' size and ``pg.e_max``
    divide by the edge axes' size. ``init_state`` warm-starts monotone
    programs as in ``run_sim``."""
    pl = placement(mesh, cfg.subgraph_axes, cfg.edge_axes)
    if pg.n_parts != pl.n_sub:
        raise ValueError(f"the graph has {pg.n_parts} partitions, the "
                         f"subgraph axes {cfg.subgraph_axes} {pl.n_sub}")
    if pg.e_max % pl.n_edge:
        raise ValueError(f"e_max={pg.e_max} must divide by the edge axes' "
                         f"{pl.n_edge} shards; pad edges to a multiple")
    dev = resolve_device(device)
    n_slots, K = pg.n_slots, program.payload
    warm = init_state is not None and program.monotone
    edge_backend = resolve_edge_backend(program, cfg)
    sgs = _device_subgraph(pg, dev, block=(pl.part, pl.shard, pl.n_edge))
    lay = lay_blk = assignment = None
    if edge_backend != "coo":
        lay = pg.ensure_edge_layouts()
        backend = edge_backend
        if edge_backend == "auto":
            assignment = resolve_mesh_backends(program, cfg, pg, mesh,
                                               lay=lay, device=dev)
            backend = assignment[pl.part]
        lay_blk = _shard_layout_block(lay, pg, program, backend, dev, pl)
    runner = make_bsp_runner(program, mesh, cfg, n_slots, warm_start=warm,
                             partition_backends=assignment)
    wblk = None
    if warm:
        wblk = torch.from_numpy(np.ascontiguousarray(_warm_block(
            program, pg, init_state)[pl.part:pl.part + 1])).to(dev)
    stats = ExecutionStats()

    def on_step(msgs, active, sweeps, moved):
        stats.messages_per_step.append(msgs)
        stats.active_parts_per_step.append(active)
        stats.rank_sweeps_per_step.append(int(sweeps.item()))
        stats.collective_bytes_per_step.append(sum(moved.values()))

    t0 = time.perf_counter()
    results, steps, tot_msgs, sweeps_h, syncs, calls, moved = runner(
        sgs, lay_blk, params, wblk, on_step=on_step if cfg.trace else None)
    results = results.cpu().numpy()
    stats = dataclasses.replace(
        stats, supersteps=steps, total_messages=tot_msgs,
        processed_edges=int(
            (sweeps_h * pg.edges_per_part.astype(np.int64)).sum()),
        total_bytes=steps * _exchange_bytes_per_step(
            cfg, n_slots, K, program.dtype, pg.n_parts, pl.n_edge),
        wall_time=time.perf_counter() - t0, edge_backend=edge_backend,
        backend_flops=int((sweeps_h * _flops_per_sweep(
            program, edge_backend, pg, lay, assignment,
            n_edge_shards=pl.n_edge)).sum()),
        host_syncs=syncs, collectives=calls, collective_bytes=moved,
        partition_sweeps=[int(x) for x in sweeps_h])
    if edge_backend in ("pallas_tiles", "auto"):
        # counted from the geometry: a rank realizes only its own tiles
        stats.tile_density, dens = lay.geometric_density()
        stats.partition_tile_density = list(dens)
    if assignment is not None:
        stats.partition_edge_backends = list(assignment)
    return results, stats


# --------------------------------------------------------------------------- #
# BSP checkpoints (the JAX package's .npz layout, ``repro_torch.npz_io``)
# --------------------------------------------------------------------------- #
_SEP = "|"


def _flatten_carry(tree, path=()) -> dict:
    """{keypath: numpy leaf} with the reference's key spelling: each dict
    key as ``['name']`` (JAX ``keystr``), nested keys joined by ``|``, dict
    keys in sorted order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_carry(tree[k], path + (f"[{k!r}]",)))
        return out
    leaf = tree.cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return {_SEP.join(path): leaf}


def save_checkpoint(path: str, carry: dict) -> str:
    """Atomically write a BSP carry ``dict(state, last_out, merged, step)``
    in the format of the JAX package's ``save_pytree``, with its key
    spelling, so either engine resumes the other's checkpoints."""
    return save_flat(path, _flatten_carry(carry))


def load_checkpoint(path: str, like: dict, device) -> dict:
    """Read a BSP checkpoint into the structure of ``like`` (a carry of
    tensors), each leaf cast to the dtype of its ``like`` leaf and moved to
    ``device``; ``step`` comes back as an int."""
    flat, _ = load_flat(path)
    want = _flatten_carry(like)
    if sorted(want) != sorted(flat):
        raise ValueError(f"checkpoint {path} holds {sorted(flat)}, the "
                         f"program's carry is {sorted(want)}")

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (f"[{k!r}]",))
                    for k, v in tree.items()}
        arr = flat[_SEP.join(path)]
        if arr.shape != want[_SEP.join(path)].shape:
            raise ValueError(f"checkpoint leaf {_SEP.join(path)} has shape "
                             f"{arr.shape}, expected "
                             f"{want[_SEP.join(path)].shape}")
        if not isinstance(tree, torch.Tensor):
            return arr.item()
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=tree.dtype)

    return build(like)


def run_sim(program: VertexProgram, pg: PartitionedGraph, params=None,
            cfg: EngineConfig = EngineConfig(), *, init_state=None,
            resume_from=None, device: DeviceLike = None):
    """One-shot simulator job: upload ``pg`` to ``device``, build the
    runner, execute. Returns ``(numpy results [P, v_max(, K)],
    ExecutionStats)``.

    ``init_state``: global per-vertex values [n_vertices(, K)] from a
    previous converged run — a warm start, used only for monotone programs
    (non-monotone programs such as PageRank start cold). ``cfg.trace``
    fills the per-superstep lists of the stats, and with
    ``cfg.checkpoint_every``/``cfg.checkpoint_dir`` writes
    ``bsp_{step:06d}.npz`` every that many supersteps; ``resume_from``
    (trace mode only) continues a job from such a checkpoint — one this
    engine or the JAX package's wrote."""
    if resume_from is not None and not cfg.trace:
        raise ValueError("resume_from requires trace mode (cfg.trace=True)")
    dev = resolve_device(device)
    edge_backend = resolve_edge_backend(program, cfg)
    sgs = _device_subgraph(pg, dev)
    params = params_to_device(params, dev)
    n_slots, K = pg.n_slots, program.payload
    warm = init_state is not None and program.monotone
    lay = lay_blk = assignment = None
    if edge_backend == "auto":
        lay = pg.ensure_edge_layouts()
        assignment = resolve_partition_backends(program, cfg, pg, lay=lay,
                                                device=dev)
        lay_blk = _auto_layout_blocks(lay, pg, program, assignment, dev)
    elif edge_backend != "coo":
        lay = pg.ensure_edge_layouts()
        lay_blk = _layout_block_from(lay, pg, program, edge_backend, dev)

    stats = ExecutionStats(edge_backend=edge_backend)
    epp_host = pg.edges_per_part.astype(np.int64)
    flops_pp = _flops_per_sweep(program, edge_backend, pg, lay, assignment)
    if edge_backend == "pallas_tiles":
        spec = program.sweep_spec
        stats.tile_density = lay.density(pg, spec.semiring, spec.edge_values,
                                         program.dtype)
        stats.partition_tile_density = list(lay.partition_density(
            pg, spec.semiring, spec.edge_values, program.dtype))
    elif edge_backend == "auto":
        # counted from the geometry: realizing every partition's tile
        # values is what 'auto' avoids on a graph like kron-20
        stats.tile_density, dens = lay.geometric_density()
        stats.partition_tile_density = list(dens)
        stats.partition_edge_backends = list(assignment)
    itemsize = numpy_dtype(program.dtype).itemsize
    step_bytes = (n_slots + 1) * K * itemsize * pg.n_parts

    def on_step(msgs, active, sweeps, carry):
        stats.messages_per_step.append(msgs)
        stats.active_parts_per_step.append(active)
        step = carry["step"]
        if cfg.checkpoint_every and cfg.checkpoint_dir \
                and step % cfg.checkpoint_every == 0:
            save_checkpoint(os.path.join(cfg.checkpoint_dir,
                                         f"bsp_{step:06d}.npz"), carry)

    runner = make_sim_runner(program, cfg, n_slots, warm_start=warm,
                             partition_backends=assignment)
    wblk = None
    if warm:
        wblk = torch.from_numpy(_warm_block(program, pg, init_state)).to(dev)
    resume = None
    if resume_from is not None:
        dt = program.torch_dtype
        like = dict(
            state=program.init(sgs, params, EdgeCombine()),
            last_out=torch.empty((pg.n_parts, pg.v_max, K), dtype=dt),
            merged=torch.empty((n_slots + 1, K), dtype=dt), step=0)
        resume = load_checkpoint(resume_from, like, dev)
    t0 = time.perf_counter()
    results, steps, tot_msgs, sweeps_h, syncs = runner(
        sgs, lay_blk, params, wblk, on_step=on_step if cfg.trace else None,
        resume=resume)
    results = results.cpu().numpy()
    stats.wall_time = time.perf_counter() - t0
    stats.supersteps = steps
    stats.total_messages = tot_msgs
    stats.host_syncs = syncs
    stats.processed_edges = int((sweeps_h * epp_host).sum())
    stats.partition_sweeps = [int(x) for x in sweeps_h]
    stats.backend_flops = int((sweeps_h * flops_pp).sum())
    stats.total_bytes = (steps - (0 if resume is None else resume["step"])) \
        * step_bytes
    return results, stats


def run(program: VertexProgram, pg: PartitionedGraph, params=None,
        cfg: EngineConfig = EngineConfig(), mesh: Any = None, *,
        init_state=None, resume_from=None, device: DeviceLike = None):
    """Dispatch on ``cfg.backend``: the simulator, or ``shard_map`` on
    ``mesh`` (which it needs; checkpoint resume is a simulator trace-mode
    feature, as in the reference)."""
    if cfg.backend == "sim":
        return run_sim(program, pg, params, cfg, init_state=init_state,
                       resume_from=resume_from, device=device)
    if mesh is None:
        raise ValueError("shard_map backend needs a mesh")
    if resume_from is not None:
        raise NotImplementedError(
            "checkpoint resume is a trace-mode feature of the simulator "
            "backend; rerun with cfg.backend='sim' (and cfg.trace=True)")
    return run_shard_map(program, pg, mesh, params, cfg,
                         init_state=init_state, device=device)
