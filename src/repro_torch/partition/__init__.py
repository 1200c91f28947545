"""Balanced vertex-cut partitioning of the port: the JAX package's
``repro.partition`` in numpy, on top of the pure-hash routers in
``core/partition.py``.

  - ``ebv``        — the EBV (efficiency-and-balance vertex-cut) stateful
    streaming router (Zhang et al., arXiv:2010.09007 — DRONE's follow-up):
    scores each edge against running per-partition replication sets and
    edge/vertex load counters instead of a memoryless hash.
  - ``monitor``    — ``LoadMonitor`` folds per-partition signals (edge
    counts, frontier occupancy, per-shard sweep time / ``backend_flops``)
    into an imbalance gauge with hysteresis.
  - ``rebalance``  — online rebalancer: picks a minimal set of boundary
    edges to migrate and executes the move through the same
    ``repack_partitions`` remap machinery that carries warm device state
    across ``compact()``.
"""
from repro_torch.partition.ebv import (EBVConfig, EBVRouterState,
                                       RelocationOverlay, ebv_vertex_cut)
from repro_torch.partition.monitor import LoadMonitor, MonitorConfig
from repro_torch.partition.rebalance import (RebalancePlan, RebalanceStats,
                                             execute_rebalance,
                                             plan_rebalance)

__all__ = [
    "EBVConfig", "EBVRouterState", "RelocationOverlay", "ebv_vertex_cut",
    "LoadMonitor", "MonitorConfig",
    "RebalancePlan", "RebalanceStats", "execute_rebalance", "plan_rebalance",
]
