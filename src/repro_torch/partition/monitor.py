"""Per-partition load monitoring: imbalance gauge with hysteresis.

The monitor folds whatever per-partition signals the serving layer already
produces into one scalar gauge (1.0 = perfectly balanced, max/mean of the
blended load vector otherwise):

  - **edge counts** — ``PartitionedGraph.edges_per_part`` at every graph
    event (flush/compact), the structural signal;
  - **frontier occupancy** — active frontier slots per partition, the
    SBS-exchange pressure signal;
  - **measured work** — per-shard sweep time / ``backend_flops`` from
    ``ExecutionStats`` (``partition_sweep_time`` / ``partition_flops``),
    EWMA-smoothed across queries, the realized-latency signal.

Hysteresis: ``should_rebalance()`` arms only after the gauge has sat at or
above ``high`` for ``patience`` consecutive graph observations, and after a
rebalance (``notify_rebalanced``) stays disarmed until the gauge drops
below ``low`` — so a borderline graph neither thrashes migrations nor
re-triggers on the first post-migration wobble. A graph the rebalancer
cannot improve (e.g. one partition pinned by a single hub) therefore
triggers exactly once, not every flush.

The JAX package's monitor (``repro.partition.monitor``) unchanged: the
same observations give the same gauge and trigger sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["MonitorConfig", "LoadMonitor"]


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Thresholds + signal weights for the imbalance gauge."""

    high: float = 1.5        # gauge >= high (for `patience` obs) -> trigger
    low: float = 1.15        # re-arm only once the gauge drops below this
    patience: int = 2        # consecutive high observations before arming
    ema: float = 0.5         # EWMA factor for the measured-work signals
    w_edges: float = 1.0     # edge-count signal weight
    w_time: float = 1.0      # per-shard sweep-time signal weight
    w_frontier: float = 0.25  # frontier-occupancy signal weight


def _imbalance(loads: Optional[np.ndarray]) -> float:
    if loads is None or loads.size == 0:
        return 1.0
    mean = float(loads.mean())
    if mean <= 0.0:
        return 1.0
    return float(loads.max()) / mean


class LoadMonitor:
    """Folds per-partition load signals into a hysteresis-gated gauge.

    ``observe_graph(pg)`` feeds the structural signals at every graph event;
    ``observe_query(stats)`` feeds the measured per-shard work from an
    ``ExecutionStats``. ``gauge`` blends the per-signal imbalances by the
    configured weights (signals never observed contribute nothing).
    """

    def __init__(self, cfg: Optional[MonitorConfig] = None):
        self.cfg = cfg or MonitorConfig()
        self._edge_loads: Optional[np.ndarray] = None
        self._frontier_loads: Optional[np.ndarray] = None
        self._time_loads: Optional[np.ndarray] = None   # EWMA seconds
        self._streak = 0          # consecutive high graph observations
        self._armed = True        # False between a rebalance and re-arm
        self.observations = 0
        self.triggers = 0

    # ------------------------------------------------------------------ #
    def observe_graph(self, pg) -> float:
        """Fold the structural signals of a ``PartitionedGraph`` (edge
        counts + frontier occupancy) and advance the hysteresis state.
        Returns the updated gauge."""
        self._edge_loads = pg.edges_per_part.astype(np.float64)
        live = pg.vmask & pg.is_frontier
        self._frontier_loads = live.sum(axis=1).astype(np.float64)
        self.observations += 1
        g = self.gauge
        if g >= self.cfg.high:
            self._streak += 1
        else:
            self._streak = 0
        if not self._armed and g < self.cfg.low:
            self._armed = True
        return g

    def observe_query(self, stats) -> None:
        """EWMA-fold a query's measured per-shard work (``ExecutionStats``
        with ``partition_sweep_time``/``partition_flops`` filled in)."""
        t = getattr(stats, "partition_sweep_time", None)
        if not t:
            flops = getattr(stats, "partition_flops", None)
            if not flops:
                return
            t = flops
        t = np.asarray(t, np.float64)
        if self._time_loads is None or self._time_loads.size != t.size:
            self._time_loads = t
        else:
            a = self.cfg.ema
            self._time_loads = a * t + (1.0 - a) * self._time_loads

    # ------------------------------------------------------------------ #
    @property
    def gauge(self) -> float:
        """Weighted blend of the per-signal max/mean imbalances."""
        parts = [(self.cfg.w_edges, _imbalance(self._edge_loads)),
                 (self.cfg.w_time, _imbalance(self._time_loads)),
                 (self.cfg.w_frontier, _imbalance(self._frontier_loads))]
        num = den = 0.0
        for w, g in parts:
            if w > 0.0:
                num += w * g
                den += w
        return num / den if den else 1.0

    def blended_loads(self, n_parts: int) -> Optional[np.ndarray]:
        """[n_parts] weighted blend of the observed per-partition load
        vectors (each mean-normalized so the weights compare signal
        *shapes*, not units) — what ``plan_rebalance(loads=...)`` wants for
        sweep-time-weighted donor selection. Signals never observed — or
        observed for a different partition count — contribute nothing;
        returns None when nothing usable has been observed at all (the
        planner then falls back to raw edge counts)."""
        out = np.zeros(n_parts, np.float64)
        tot = 0.0
        for w, arr in ((self.cfg.w_edges, self._edge_loads),
                       (self.cfg.w_time, self._time_loads),
                       (self.cfg.w_frontier, self._frontier_loads)):
            if w <= 0.0 or arr is None or arr.size != n_parts:
                continue
            mean = float(arr.mean())
            if mean <= 0.0:
                continue
            out += w * (arr / mean)
            tot += w
        return out / tot if tot > 0.0 else None

    def signals(self) -> dict:
        """Per-signal imbalance snapshot (benchmark tables / debugging)."""
        return {
            "edges": _imbalance(self._edge_loads),
            "sweep_time": _imbalance(self._time_loads),
            "frontier": _imbalance(self._frontier_loads),
            "gauge": self.gauge,
            "armed": self._armed,
            "streak": self._streak,
        }

    def should_rebalance(self) -> bool:
        """True when armed and the gauge has sat at/above ``high`` for
        ``patience`` consecutive graph observations."""
        return self._armed and self._streak >= self.cfg.patience

    def notify_rebalanced(self) -> None:
        """A migration ran: reset the streak and disarm until the gauge
        drops below ``low`` (thrash protection)."""
        self.triggers += 1
        self._streak = 0
        self._armed = False
