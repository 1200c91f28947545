"""PageRank — asynchronous accumulative formulation (paper §7.2, after
Zhang et al. [17]).

State per vertex: rank ``pr`` and accumulator ``delta``. Processing a vertex:
``pr += delta``; push ``alpha * delta / out_deg`` to each out-neighbour's
accumulator; reset ``delta``. Fixed point: ``pr = sum_n alpha^n M^n r`` with
``r = (1-alpha)/N`` (dangling mass not redistributed, as in [17]).

Internal vertices are processed by local sweeps; frontier vertices only at
superstep boundaries, where SBS sums their accumulators and every replica
consumes the merged delta identically (pr update + push along its local
out-edges). Frontier vertices are seeded on their master replica only. All
methods work on the stacked ``[P, v_max]`` batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.api import DeviceSubgraph, SemiringSweep, VertexProgram


@dataclasses.dataclass
class PageRank(VertexProgram):
    combiner: str = "sum"
    payload: int = 1
    dtype: object = np.float32
    delta_based: bool = True
    tol: float = 1e-7
    alpha: float = 0.85

    # plus-times over unit edges: the alpha/out_deg rate rides the vertex
    # values (sweep_values), so the edge-value map stays declarative
    sweep_spec = SemiringSweep("plus_times", "one")

    def _rate(self, sg: DeviceSubgraph) -> torch.Tensor:
        alpha = torch.tensor(self.alpha, dtype=torch.float32,
                             device=sg.device)
        return torch.where(sg.out_deg > 0,
                           alpha / torch.clamp(sg.out_deg, min=1.0), 0.0)

    def _push(self, sg: DeviceSubgraph, d, ec):
        """Push alpha*d/out_deg along local out-edges; returns inflow."""
        send = d * self._rate(sg)
        contrib = torch.where(sg.emask, sg.gather(send, sg.esrc), 0.0)
        recv = torch.zeros_like(d).scatter_add_(1, sg.edst.long(), contrib)
        return ec.sum(recv)

    def init(self, sg: DeviceSubgraph, params, ec):
        n = float(params["n_vertices"])
        seed = float(np.float32((1.0 - self.alpha) / n))
        # master-only seeding for frontier vertices (mirrors start at 0)
        d0 = torch.where(sg.internal | (sg.frontier & sg.is_master), seed, 0.0)
        d0 = torch.where(sg.vmask, d0, 0.0).to(torch.float32)
        return {"pr": torch.zeros_like(d0), "delta": d0}

    def apply_frontier(self, sg, params, state, merged, ec):
        m = torch.where(sg.frontier, merged[..., 0], 0.0)
        sig = m.abs() > self.tol
        mm = torch.where(sig, m, 0.0)
        pr = state["pr"] + mm
        inflow = self._push(sg, mm, ec)
        # frontier accumulators were globally consumed: reset to the new
        # inflow; internal accumulators keep pending value + new inflow
        delta = torch.where(sg.frontier, inflow, state["delta"] + inflow)
        changed = (sig & sg.frontier).sum(dim=-1, dtype=torch.int32)
        return {"pr": pr, "delta": delta}, changed

    def _processable(self, sg, state):
        """Internal vertices whose pending accumulator is significant, and
        the value they consume."""
        d = state["delta"]
        proc = sg.internal & (d.abs() > self.tol)
        return proc, torch.where(proc, d, 0.0)

    def sweep_values(self, sg, params, state):
        _, dp = self._processable(sg, state)
        return dp * self._rate(sg)

    def sweep_fold(self, sg, params, state, agg):
        proc, dp = self._processable(sg, state)
        pr = state["pr"] + dp
        delta = torch.where(proc, 0.0, state["delta"]) \
            + torch.where(sg.vmask, agg, 0.0)
        return {"pr": pr, "delta": delta}, proc.sum(dim=-1, dtype=torch.int32)

    def frontier_out(self, sg, params, state):
        return torch.where(sg.frontier, state["delta"], 0.0)[..., None]

    def result(self, sg, params, state):
        # remaining sub-tolerance delta is folded in for a tighter answer
        return state["pr"] + state["delta"]
