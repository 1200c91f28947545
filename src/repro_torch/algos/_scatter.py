"""Edge scatters over the stacked ``[P, v_max(, K)]`` batch for the
hand-rolled COO sweeps: the JAX package's per-partition ``.at[idx].add`` /
``.at[idx].min`` become one ``scatter_add_`` / ``scatter_reduce_`` along the
vertex axis (edge indices are partition-local).

A float ``scatter_sum`` on a CUDA tensor runs PyTorch's deterministic
``scatter_add_`` (sort-based, no atomics). The delta-accumulation programs
(SigmaCount, BrandesAccum) emit ``pin - emitted`` and halt only when a
sweep recomputes its partial sum to the same bits it synced; with atomics
the sum's order, and so its last bits, change from sweep to sweep, and the
emitted deltas never reach zero.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.api import DeviceSubgraph


def scatter_min(sg: DeviceSubgraph, cand: torch.Tensor, idx: torch.Tensor,
                ident) -> torch.Tensor:
    """[P, v_max, K] ``min`` of the per-edge ``cand`` [P, e_max, K] at the
    local vertex ``idx`` [P, e_max] of each edge, from ``ident``."""
    K = cand.shape[-1]
    out = torch.full((sg.n_parts, sg.v_max, K), ident, dtype=cand.dtype,
                     device=cand.device)
    i = idx.long()[..., None].expand(-1, -1, K)
    return out.scatter_reduce_(1, i, cand, "amin", include_self=True)


def scatter_sum(sg: DeviceSubgraph, vals: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """[P, v_max(, K)] sum of the per-edge ``vals`` [P, e_max(, K)] at the
    local vertex ``idx`` [P, e_max] of each edge."""
    shape = (sg.n_parts, sg.v_max) + tuple(vals.shape[2:])
    i = idx.long()
    if vals.dim() == 3:
        i = i[..., None].expand(-1, -1, vals.shape[-1])
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    with _deterministic(vals):
        return out.scatter_add_(1, i, vals)


@contextlib.contextmanager
def _deterministic(vals: torch.Tensor):
    """PyTorch's deterministic algorithms for a float CUDA ``vals`` (the
    caller's setting is restored after); a no-op otherwise."""
    if vals.device.type != "cuda" or not vals.is_floating_point():
        yield
        return
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def changed_rows(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """[P] int32: vertices with any lane that tightened (``new < old`` on
    [P, v_max] or [P, v_max, K] values)."""
    less = new < old
    if less.dim() == 3:
        less = less.any(dim=-1)
    return less.sum(dim=-1, dtype=torch.int32)
