"""Partitioning + execution metrics (paper §6.2).

Partitioning metrics:
  - Imbalance          = max_i |E_i| / (|E| / n)
  - Replication Factor = sum_i |V_i| / |V|

Execution metrics (gathered by the engine): supersteps, network messages
((key,value) pairs, i.e. changed frontier slots per superstep), bytes moved,
PEPS (processed edges per second, paper Fig 9), and the port's count of
device-to-host synchronisations (one per local sweep and superstep).

Spans: ``span(name)`` marks a stretch of the query path under
``torch.profiler``, on the clock and timeline of the kernels it launches,
so that the device's idle gaps can be put down to a layer of the program.
Every name is in ``SPANS``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.subgraph import PartitionedGraph

__all__ = ["PartitionMetrics", "partition_metrics", "ExecutionStats",
           "SPANS", "span"]

#: every span of the query path, outermost first
SPANS = (
    "drone.query",              # GraphSession.query, whole
    "drone.session.prepare",    # warm lookup, device graph, layouts, runner
    "drone.session.fetch",      # the result's copy to the host
    "drone.session.stats",      # ExecutionStats of the call
    "drone.session.remember",   # the warm-start memory of a converged result
    "drone.session.warm_collect",  # a warm result's global array, built
                                   # on its first read
    "drone.engine.run",         # the simulator runner's BSP loop
    "drone.engine.superstep",   # one superstep: local phase and exchange
    "drone.engine.sweep",       # one batched sweep of every partition
    "drone.edge.product",       # the edge product: message buffer, kernel
    "drone.engine.sync",        # a flag or count read from the device
)

_NO_SPAN = contextlib.nullcontext()
_profiler_on = torch._C._autograd._profiler_enabled


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs, else
    one shared no-op context: an idle span costs a flag test and allocates
    nothing."""
    if _profiler_on():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@dataclasses.dataclass
class PartitionMetrics:
    n_parts: int
    imbalance: float
    replication_factor: float
    edges_per_part_max: int
    edges_per_part_min: int
    n_frontier: int
    master_balance: float  # max masters per part / mean

    def __str__(self):
        return (f"P={self.n_parts} imbalance={self.imbalance:.4f} "
                f"RF={self.replication_factor:.4f} frontier={self.n_frontier} "
                f"master_balance={self.master_balance:.3f}")


def partition_metrics(pg: PartitionedGraph) -> PartitionMetrics:
    epp = pg.edges_per_part
    vpp = pg.vertices_per_part
    masters = (pg.is_master & pg.vmask & (pg.slot < pg.n_slots)).sum(axis=1)
    mmean = masters.mean() if pg.n_slots else 1.0
    return PartitionMetrics(
        n_parts=pg.n_parts,
        imbalance=float(epp.max() / max(epp.mean(), 1e-12)),
        replication_factor=float(vpp.sum() / max(pg.n_vertices, 1)),
        edges_per_part_max=int(epp.max()),
        edges_per_part_min=int(epp.min()),
        n_frontier=pg.n_slots,
        master_balance=float(masters.max() / max(mmean, 1e-12))
        if pg.n_slots else 1.0,
    )


@dataclasses.dataclass
class ExecutionStats:
    """Filled in by the engine; per-superstep lists only when tracing."""
    supersteps: int = 0
    total_messages: int = 0            # changed (key,value) pairs
    total_bytes: int = 0               # dense SBS buffer bytes reduced
    messages_per_step: list = dataclasses.field(default_factory=list)
    active_parts_per_step: list = dataclasses.field(default_factory=list)
    wall_time: float = 0.0             # execution, ending in a device sync
    compile_time: float = 0.0          # runner build on a session cache miss
    evicted_runners: int = 0           # runner-cache evictions this query's
                                       # runner admission forced (sessions)
    processed_edges: int = 0
    edge_backend: str = "coo"
    backend_flops: int = 0             # semiring ops the backend issued
    tile_density: float = 0.0          # non-identity fraction of real tiles
    host_syncs: int = 0                # device->host reads the loop made
    collectives: int = 0               # torch.distributed calls this rank
                                       # made (shard_map backend)
    collective_bytes: dict = dataclasses.field(default_factory=dict)
                                       # their payload bytes by kind
                                       # ('all_reduce', 'all_gather')
    collective_bytes_per_step: list = dataclasses.field(
        default_factory=list)          # shard_map trace: payload bytes of
                                       # each superstep, every kind
    rank_sweeps_per_step: list = dataclasses.field(default_factory=list)
                                       # shard_map trace: this rank's
                                       # partition's sweeps each superstep
    queue_time: float = 0.0            # admission-queue dwell before launch
                                       # (serving/batcher.py fills it in)
    batch_size: int = 1                # lanes of the micro-batched launch
                                       # that served this query (1 = alone)
    result_cache_tier: str = ""        # '' when no result cache was asked;
                                       # 'l1'/'l2' when the converged result
                                       # was served without a launch, 'miss'
                                       # when it ran and was stored
    partition_edge_counts: list = dataclasses.field(default_factory=list)
    partition_flops: list = dataclasses.field(default_factory=list)
    partition_sweep_time: list = dataclasses.field(default_factory=list)
    partition_tile_density: list = dataclasses.field(default_factory=list)
    partition_sweeps: list = dataclasses.field(default_factory=list)
    partition_edge_backends: list = dataclasses.field(default_factory=list)
                                       # edge_backend='auto' only: the
                                       # concrete backend of each partition

    @property
    def peps(self) -> float:
        """Processed edges per second (paper §8.5)."""
        return self.processed_edges / self.wall_time if self.wall_time else 0.0

    @property
    def total_time(self) -> float:
        return self.wall_time + self.compile_time
