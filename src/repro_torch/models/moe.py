"""Mixture-of-Experts layer: the port of the JAX package's ``models/moe.py``.

Sort-based token dispatch with a capacity drop: each token picks its
``top_k`` experts, the (token, expert) pairs are sorted by expert (a stable
sort), the first ``cap`` pairs of each expert fill its slots of a
``[E, cap, d]`` buffer and the rest are dropped; the experts run as grouped
products over their slots (``torch.bmm``), and each token sums its kept
experts' outputs weighted by their renormalized router probabilities.
DeepSeek's shared experts (an always-on ``MLP``) and the aux-loss-free
router bias (added to the probabilities for the choice only, nudged by
``update_router_bias`` outside the gradient) are options of the config.

The numerics follow the reference's: the router product and softmax in
float32 on the router cast to the activation dtype (``_cast_floats``), the
top-k choice with ties to the lower expert index (``jax.lax.top_k``), the
capacity from the same Python expression, and each token's expert outputs
added in the activation dtype one by one in ascending expert order, the
order of the sorted dispatch. That sum has no atomics, so a run on the card
gives the same bits every time.

``moe_apply_hierarchical`` dispatches per data-parallel group:
``_dp_groups`` reads the ambient mesh's ``pod x data`` (1 without a mesh,
as the reference's); ``_moe_apply_grouped`` takes the group count ``G``
itself. On a mesh the layer runs ``models.sharded.moe``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (MLP, _cast_params, _own, _param,
                                       mlp_apply, mlp_specs)
from repro_torch.sharding import rules as R


def moe_specs(cfg) -> dict:
    m = cfg.moe
    specs = {"router": ("embed", "experts"), "router_bias": ("experts",),
             "w_gate": ("experts", "embed", "ff_expert"),
             "w_up": ("experts", "embed", "ff_expert"),
             "w_down": ("experts", "ff_expert", "embed")}
    if m.n_shared:
        specs["shared"] = mlp_specs(cfg.act)
    return specs


def _capacity(capacity_factor: float, T: int, k: int, E: int) -> int:
    """Slots per expert for ``T`` tokens: the reference's expression, so the
    integer is the same (``min`` with ``T * k``: the dropless ceiling)."""
    cap = int(math.ceil(capacity_factor * T * k / E / 8.0) * 8)
    return min(cap, T * k)


def _route(params: dict, xt: torch.Tensor, m):
    """Router over tokens ``xt`` [..., T, d]: (selection scores [..., T,
    E], expert_idx, gate [..., T, k]). The top k of the scores are the
    first k of a stable descending sort, so ties go to the lower expert
    index as in ``jax.lax.top_k``; the gates are the chosen probabilities
    (without the bias) renormalized to sum to one."""
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    sel = probs + params["router_bias"].float() if m.router_aux_free_bias \
        else probs
    expert_idx = torch.sort(sel, dim=-1, descending=True,
                            stable=True).indices[..., :m.top_k]
    gate = probs.gather(-1, expert_idx)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return sel, expert_idx, gate


def _dispatch(xt: torch.Tensor, expert_idx: torch.Tensor, E: int, cap: int):
    """Sort-based dispatch of ``xt`` [T, d] by ``expert_idx`` [T, k]:
    (buf [E, cap, d], order, slot, keep). A dropped pair's slot is the row
    ``E * cap`` past the buffer, where the reference's ``mode="drop"``
    scatter ignores it; here the buffer has that row and it is cut off."""
    T, k = expert_idx.shape
    d = xt.shape[-1]
    dev = xt.device
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - seg_start[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, E * cap)
    buf = xt.new_zeros((E * cap + 1, d))
    buf[slot] = torch.where(keep[:, None], xt[order // k], 0)
    return buf[:E * cap].view(E, cap, d), order, slot, keep


def _combine(y: torch.Tensor, order, slot, keep, gate, expert_idx,
             dtype: torch.dtype) -> torch.Tensor:
    """Each token's weighted expert outputs summed into [T, d] of
    ``dtype``. The reference scatter-adds the sorted pairs in turn, so a
    token's k terms are added in ascending expert order, each sum rounded
    to ``dtype``; the port adds them in that order, term by term."""
    T, k = expert_idx.shape
    d = y.shape[-1]
    y_tok = F.pad(y.reshape(-1, d), (0, 0, 0, 1))[slot]   # the drop row: 0
    w = torch.where(keep, gate.reshape(-1)[order], 0.0).to(y_tok.dtype)
    terms = torch.empty_like(y_tok)
    terms[order] = y_tok * w[:, None]                     # (token, choice)
    terms = terms.view(T, k, d)
    by_expert = expert_idx.argsort(dim=-1)   # a token's experts are distinct
    out = torch.zeros((T, d), dtype=dtype, device=y.device)
    rows = torch.arange(T, device=y.device)
    for j in range(k):
        out = out + terms[rows, by_expert[:, j]]
    return out


def _experts(params: dict, h: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU over their slots: h [E, C, d] -> [E, C,
    d] (the reference's grouped einsums)."""
    g = torch.bmm(h, params["w_gate"])
    u = torch.bmm(h, params["w_up"])
    return torch.bmm(F.silu(g) * u, params["w_down"])


def _moe_apply_grouped(params: dict, x: torch.Tensor, cfg, G: int):
    """Dispatch per group of ``T / G`` tokens, capacity per group, one
    grouped expert product over every group's slots: (out [B, S, d], load
    [E], keep [T * k]). ``G = 1`` is the global dispatch."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    Tg = T // G
    xt = x.reshape(G, Tg, d)
    _, expert_idx, gate = _route(params, xt, m)               # [G, Tg, k]
    cap = _capacity(m.capacity_factor, Tg, k, E)
    parts = [_dispatch(xt[g], expert_idx[g], E, cap) for g in range(G)]
    # [G, E, cap, d] -> [E, G * cap, d]: the reference's all-to-all
    h = torch.stack([p[0] for p in parts], dim=1).reshape(E, G * cap, d)
    y = _experts(params, h).reshape(E, G, cap, d)
    out = torch.cat([_combine(y[:, g], *parts[g][1:], gate[g],
                              expert_idx[g], x.dtype)
                     for g in range(G)]).reshape(T, d)
    if m.n_shared:
        out = out + mlp_apply(params["shared"], x.reshape(T, d), cfg.act)
    # the reference's load divides by T * k as XLA does: times the float32
    # reciprocal
    load = torch.bincount(expert_idx.reshape(-1), minlength=E).float() \
        * float(np.float32(1.0) / np.float32(T * k))
    keep = torch.cat([p[3] for p in parts])
    return out.reshape(B, S, d), load, keep


def _dropped(keep: torch.Tensor) -> torch.Tensor:
    """``1 - keep.mean()`` in float32 as the reference's compiled program
    computes it: the count times the float32 reciprocal of the length,
    subtracted from 1 in one fused multiply-add (exact in float64 here),
    rounded once."""
    inv = float(np.float32(1.0) / np.float32(keep.numel()))
    return (1.0 - keep.sum().double() * inv).float()


def _dp_groups(total_tokens: int) -> int:
    """Data-parallel groups of the hierarchical dispatch: the ambient
    mesh's ``pod x data`` where it divides the tokens, else 1 (1 without
    a mesh)."""
    from repro_torch.models.sharded import dp_groups
    return dp_groups(total_tokens)


def moe_apply(params: dict, x: torch.Tensor, cfg):
    """x [B, S, d] -> ([B, S, d], {"load": [E] float32, "dropped": the
    share of (token, expert) pairs past capacity, float32})."""
    if cfg.moe.dispatch == "hierarchical":
        return moe_apply_hierarchical(params, x, cfg)
    out, load, keep = _moe_apply_grouped(params, x, cfg, 1)
    return out, {"load": load, "dropped": _dropped(keep)}


def moe_apply_hierarchical(params: dict, x: torch.Tensor, cfg):
    """Per-group dispatch (``_dp_groups`` groups). As in the reference,
    ``dropped`` is 0.0 on this path whatever the groups drop."""
    B, S, _ = x.shape
    out, load, _ = _moe_apply_grouped(params, x, cfg, _dp_groups(B * S))
    return out, {"load": load, "dropped": 0.0}


def update_router_bias(params: dict, load: torch.Tensor, *,
                       rate: float = 1e-3) -> dict:
    """DeepSeek's aux-loss-free balancing: raise the bias of under-loaded
    experts and lower it for over-loaded ones (applied outside the
    gradient). Returns ``params`` with the new ``router_bias``."""
    target = 1.0 / load.shape[-1]
    bias = params["router_bias"] + rate * torch.sign(target - load)
    return dict(params, router_bias=bias)


class MoE(nn.Module):
    """router [d, E] and router_bias [E] in float32 whatever the parameter
    dtype; w_gate / w_up [E, d, d_ffe] and w_down [E, d_ffe, d]; ``shared``,
    an ``MLP`` of width ``d_ffe * n_shared``, when the config has shared
    experts. ``forward`` returns (out, stats) as ``moe_apply`` does."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = cfg.moe
        d, E = cfg.d_model, m.n_experts
        d_ffe = m.d_ff_expert or cfg.d_ff
        self.cfg = cfg
        self.router = _param(generator, (d, E), d, torch.float32, device)
        self.router_bias = nn.Parameter(torch.zeros(E, dtype=torch.float32,
                                                    device=device))
        self.w_gate = _param(generator, (E, d, d_ffe), d, dtype, device)
        self.w_up = _param(generator, (E, d, d_ffe), d, dtype, device)
        self.w_down = _param(generator, (E, d_ffe, d), d_ffe, dtype, device)
        self.shared = (MLP(d, d_ffe * m.n_shared, cfg.act, dtype=dtype,
                           device=device, generator=generator)
                       if m.n_shared else None)

    def logical_axes(self) -> dict:
        return _own(moe_specs(self.cfg))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
        params = _cast_params(self, dtype)
        if self.shared is not None:
            params["shared"] = _cast_params(self.shared, dtype)
        if R.get_mesh() is not None:
            from repro_torch.models import sharded
            return sharded.moe(params, x, self.cfg)
        return moe_apply(params, x, self.cfg)
