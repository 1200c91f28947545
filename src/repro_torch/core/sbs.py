"""Subgraph Boundary Synchronization (paper §4.3).

The paper's SBS routes (key,value) pairs mirror->master, Aggregates with a
user combiner, then Disseminates master->mirrors. Over a dense frontier-slot
vector this protocol is a reduction with that combiner: each partition
scatters its frontier contributions into an ``[n_slots + 1, K]`` buffer
(row ``n_slots`` is the dump row for non-frontier vertices), the buffers
are combined across partitions, and every vertex gathers its slot's merged
value back.

``SimExchange`` is the single-device exchange: the per-partition buffers
are stacked on a leading P axis and reduced over it.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["scatter_combine", "gather_merged", "SimExchange"]

_REDUCE = {"min": "amin", "max": "amax", "sum": "sum"}


def scatter_combine(out: torch.Tensor, slot: torch.Tensor,
                    vmask: torch.Tensor, n_slots: int, combiner: str,
                    identity) -> torch.Tensor:
    """[P, v_max, K] contributions -> [P, n_slots + 1, K] per-partition
    buffers (``identity`` a numpy scalar). Vertices outside ``vmask``
    contribute the identity; row ``n_slots`` is the dump row."""
    if combiner not in _REDUCE:
        raise ValueError(combiner)
    P, v_max, K = out.shape
    ident = torch.full((), identity.item(), dtype=out.dtype,
                       device=out.device)
    # slot ids beyond the buffer are dropped (the reference's mode="drop")
    keep = slot.long() <= n_slots
    rows = torch.where(keep, slot.long(), 0)
    contrib = torch.where((vmask & keep)[..., None], out, ident)
    buf = torch.full((P, n_slots + 1, K), identity.item(), dtype=out.dtype,
                     device=out.device)
    idx = rows[..., None].expand(-1, -1, K)
    buf.scatter_reduce_(1, idx, contrib, _REDUCE[combiner],
                        include_self=True)
    return buf


def gather_merged(buf: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """[n_slots + 1, K] merged buffer -> [P, v_max, K] per-vertex view (the
    identity-valued dump row lands on non-frontier vertices)."""
    return buf[slot.long()]


@dataclasses.dataclass(frozen=True)
class SimExchange:
    """Reduce stacked buffers [P, n_slots+1, K] over the partition axis."""

    def all_combine(self, bufs: torch.Tensor, combiner: str) -> torch.Tensor:
        if combiner == "min":
            return bufs.amin(dim=0)
        if combiner == "max":
            return bufs.amax(dim=0)
        if combiner == "sum":
            return bufs.sum(dim=0)
        raise ValueError(combiner)
