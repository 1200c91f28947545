"""Subgraph Boundary Synchronization (paper §4.3).

The paper's SBS routes (key,value) pairs mirror->master, Aggregates with a
user combiner, then Disseminates master->mirrors. Over a dense frontier-slot
vector this protocol is a reduction with that combiner: each partition
scatters its frontier contributions into an ``[n_slots + 1, K]`` buffer
(row ``n_slots`` is the dump row for non-frontier vertices), the buffers
are combined across partitions, and every vertex gathers its slot's merged
value back.

Two exchange contexts share one scatter/gather implementation:

  - ``SimExchange`` — the single-device exchange: the per-partition buffers
    are stacked on a leading P axis and reduced over it.
  - ``ShardExchange`` — the ``shard_map`` backend: each rank holds its own
    partition's buffer, and the reduce is a ``torch.distributed``
    ``all_reduce`` (MIN, MAX or SUM) over the subgraph process group.

``compact_allgather_exchange`` is the reference's compacted sparse
exchange (``EngineConfig.sparse_sync_capacity > 0``): each rank keeps at
most ``capacity`` changed slots as (idx, val) pairs, all-gathers them and
re-combines locally. It keeps the reference's pick exactly — a stable sort
of the 0/1 changed scores, so the lowest changed slots go first — and so
also its fault: changed slots beyond ``capacity`` are dropped, and nothing
resends them (ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["scatter_combine", "gather_merged", "SimExchange",
           "ShardExchange", "all_combine", "compact_allgather_exchange"]

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


def all_combine(x: torch.Tensor, combiner: str, group) -> torch.Tensor:
    """``x`` combined (``min`` / ``max`` / ``sum``) over the ranks of
    ``group``: a new tensor, ``x`` is left as it is."""
    import torch.distributed as dist
    ops = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
           "sum": dist.ReduceOp.SUM}
    if combiner not in ops:
        raise ValueError(combiner)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=ops[combiner], group=group)
    return out


class ShardExchange:
    """Collectives over one process group (one rank per partition: the
    ranks of one edge shard). ``calls`` counts the collectives issued,
    ``bytes`` their payload by kind: the bytes of the tensor this rank
    contributes (an all-gather's input, a bool as the uint8 it sends)."""

    def __init__(self, group):
        self.group = group
        self.calls = 0
        self.bytes = {"all_reduce": 0, "all_gather": 0}

    def all_combine(self, buf: torch.Tensor, combiner: str) -> torch.Tensor:
        self.calls += 1
        self.bytes["all_reduce"] += buf.numel() * buf.element_size()
        return all_combine(buf, combiner, self.group)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_combine(x, "sum")

    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` in the group's rank order (bool goes over
        the wire as uint8)."""
        import torch.distributed as dist
        src = x.contiguous()
        wire = src.to(torch.uint8) if src.dtype == torch.bool else src
        out = [torch.empty_like(wire)
               for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(out, wire, group=self.group)
        self.calls += 1
        self.bytes["all_gather"] += wire.numel() * wire.element_size()
        return [o.to(torch.bool) for o in out] if src.dtype == torch.bool \
            else out


def compact_allgather_exchange(buf: torch.Tensor, identity, combiner: str,
                               n_slots: int, capacity: int,
                               ex: ShardExchange) -> torch.Tensor:
    """All-gather the compacted (idx, val) pairs of ``buf`` ([n_slots + 1,
    K]) over ``ex``'s group and re-combine them locally into a merged
    [n_slots + 1, K] buffer (dump row reset to the identity)."""
    ident = identity.item()
    changed = torch.any(buf[:-1] != ident, dim=-1)
    scores = changed.to(torch.int32)
    idx = torch.argsort(-scores, stable=True)[:capacity]
    idx = torch.where(scores[idx] > 0, idx, n_slots)
    vals = buf[idx]
    all_idx = torch.cat(ex.all_gather(idx.to(torch.int32))).long()
    all_vals = torch.cat(ex.all_gather(vals))
    merged = torch.full_like(buf, ident)
    merged.scatter_reduce_(0, all_idx[:, None].expand(-1, buf.shape[1]),
                           all_vals, _REDUCE[combiner], include_self=True)
    merged[n_slots] = ident
    return merged
