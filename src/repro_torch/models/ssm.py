"""Sequence-mixing recurrences: the port of the Mamba half of the JAX
package's ``models/ssm.py`` (Jamba's selective SSM, diagonal ``A``).

``Mamba`` holds the reference's leaves under its names and shapes:
``in_proj`` [d, 2·di], ``conv_w`` [d_conv, di], ``conv_b`` [di],
``x_proj`` [di, dt_rank + 2n], ``dt_proj`` [dt_rank, di], ``dt_bias``
[di], ``A_log`` [di, n] and ``D`` [di] (float32 whatever the parameter
dtype) and ``out_proj`` [di, d], with ``di = int(expand·d)`` and
``dt_rank = max(d // 16, 1)``. Like every mixer it is applied with its
float parameters cast to the activation dtype (the reference's
``_cast_floats``), ``A_log`` and ``D`` too.

``_mamba_scan`` computes ``h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t·u_t`` and
``y_t = C_t·h_t + D·u_t`` in ``u``'s dtype: at most ``_MAMBA_CHUNK`` steps
in one inclusive scan of the pairs ``(dA, dBu)`` under ``(ga·gb, xa·gb +
xb)``, longer sequences chunk by chunk, carrying ``h`` (``h = hloc + cumA ·
h_in``). PyTorch has no ``associative_scan``, so the in-chunk scan is a
log-depth doubling over the chunk axis (9 passes for 512 steps); it adds
in another order than ``lax.associative_scan``, so it matches the
reference to rounding, not to the bit.

The decode cache of a Mamba layer is ``{"conv": [B, d_conv - 1, di],
"h": [B, di, n], "idx": int}``. A prefill replaces ``conv`` and ``h`` with
the prompt's (``h`` then has the activation dtype, as ``_mamba_scan``
returns it); a decode step replaces them with the next ones and advances
``idx`` by one. The state has a fixed size, so there is no ``max_len`` and
no write that could run past the cache.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _cast_params, _param

_MAMBA_CHUNK = 512


def _assoc_combine(a, b):
    """The composition of two affine steps ``h -> g·h + x``, ``a`` first."""
    (ga, xa), (gb, xb) = a, b
    return ga * gb, xa * gb + xb


def _inclusive_scan(g: torch.Tensor, x: torch.Tensor):
    """Inclusive scan of ``(g, x)`` [b, c, ...] under ``_assoc_combine``
    along axis 1: ``ceil(log2 c)`` doubling passes (Hillis–Steele), each
    over the whole chunk. Returns (cumulative g, h from a zero start)."""
    c = g.shape[1]
    s = 1
    while s < c:
        gs, xs = _assoc_combine((g[:, :-s], x[:, :-s]), (g[:, s:], x[:, s:]))
        g = torch.cat([g[:, :s], gs], 1)
        x = torch.cat([x[:, :s], xs], 1)
        s *= 2
    return g, x


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two (``jnp.einsum``'s rule)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _mamba_scan(u, dt, B, C, A, D, chunk: int = _MAMBA_CHUNK):
    """u [b,s,di], dt [b,s,di], B/C [b,s,n], A [di,n], D [di] -> (y
    [b,s,di], h_last [b,di,n]), both in ``u``'s dtype. Past ``chunk``
    steps the sequence is cut into chunks of ``chunk`` (the last one
    zero-padded) scanned one after the other, so O(b·chunk·di·n) is live
    instead of O(b·s·di·n)."""
    b, s, di = u.shape
    n = B.shape[-1]

    def block(uj, dtj, Bj, Cj, h_in):
        dA = torch.exp(dtj[..., None] * A)                   # [b,c,di,n]
        dBu = dtj[..., None] * Bj[..., None, :] * uj[..., None]
        cumA, h = _inclusive_scan(dA, dBu)
        if h_in is not None:
            h = h + cumA * h_in[:, None]                     # carry folded in
        y = (h @ Cj[..., None])[..., 0] + D * uj
        return y, h[:, -1].clone()       # not a view pinning [b,c,di,n]

    if s <= chunk:
        return block(u, dt, B, C, None)
    nb = -(-s // chunk)
    pad = nb * chunk - s

    def _pad(t):
        return F.pad(t, (0, 0, 0, pad))

    u, dt, B, C = _pad(u), _pad(dt), _pad(B), _pad(C)
    h = torch.zeros((b, di, n), dtype=u.dtype, device=u.device)
    ys = []
    for j in range(nb):
        sl = slice(j * chunk, (j + 1) * chunk)
        y, h = block(u[:, sl], dt[:, sl], B[:, sl], C[:, sl], h)
        ys.append(y)
    return torch.cat(ys, 1)[:, :s], h


def mamba_apply(params: dict, x: torch.Tensor, cfg, *,
                cache: Optional[dict] = None):
    """x [B,S,d] -> (y [B,S,d], new_cache). cache: None (full sequence),
    or dict(conv [B,K-1,di], h [B,di,n], idx int): with S > 1 the prefill
    (the full-sequence path from a zero state, handing its final conv
    window and state to decode), with S == 1 one recurrence step. A
    float32 ``h`` (a fresh cache) promotes the step to float32, as in the
    reference."""
    mc = cfg.mamba
    K = mc.d_conv
    di = params["in_proj"].shape[1] // 2
    dt_rank = params["dt_proj"].shape[0]
    xz = x @ params["in_proj"]
    u, z = xz[..., :di], xz[..., di:]

    A = -torch.exp(params["A_log"])

    def ssm_inputs(uc):
        proj = uc @ params["x_proj"]
        dt = F.softplus(proj[..., :dt_rank] @ params["dt_proj"]
                        + params["dt_bias"])
        return dt, proj[..., dt_rank:dt_rank + mc.d_state], \
            proj[..., dt_rank + mc.d_state:]

    if cache is None or x.shape[1] > 1:
        # full-sequence path (a forward, or the prefill when a cache is given)
        S = u.shape[1]
        up = F.pad(u, (0, 0, K - 1, 0))
        uc = 0
        for i in range(K):
            uc = uc + up[:, i:i + S] * params["conv_w"][i]
        uc = F.silu(uc + params["conv_b"])
        dt, Bm, Cm = ssm_inputs(uc)
        y, h_last = _mamba_scan(uc, dt, Bm, Cm, A, params["D"])
        new_cache = None
        if cache is not None:     # copies: a view would pin ``up``
            new_cache = {"conv": up[:, S:].clone(), "h": h_last,
                         "idx": cache["idx"] + S}
    else:
        conv_hist = torch.cat([cache["conv"], u], 1)            # [B,K,di]
        uc = torch.einsum("bkd,kd->bd", conv_hist, params["conv_w"]) \
            + params["conv_b"]
        uc = F.silu(uc)[:, None]
        dt, Bm, Cm = ssm_inputs(uc)
        dA = torch.exp(dt[:, 0, :, None] * A)
        h = dA * cache["h"] + dt[:, 0, :, None] * Bm[:, 0, None, :] \
            * uc[:, 0, :, None]
        y = _mm(h, Cm[:, 0, :, None])[..., 0][:, None] + params["D"] * uc
        new_cache = {"conv": conv_hist[:, 1:].clone(), "h": h,
                     "idx": cache["idx"] + 1}
    y = y * F.silu(z)
    return _mm(y, params["out_proj"]), new_cache


def mamba_cache_shape(cfg, batch: int, dtype: torch.dtype, *,
                      device=None) -> dict:
    """A zeroed Mamba decode cache: ``conv`` in the activation dtype, ``h``
    float32 (the reference's ``mamba_cache_shape``; the port allocates it).
    A prefill replaces both."""
    mc = cfg.mamba
    di = int(mc.expand * cfg.d_model)
    return {"conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                             device=device),
            "idx": 0}


class Mamba(nn.Module):
    """Jamba's Mamba mixer (the reference's ``init_mamba``): the dense
    weights drawn by ``_dense_init`` from the generator in the reference's
    order, ``conv_b`` and ``dt_bias`` zero, ``A_log = log(1..n)`` on every
    channel and ``D`` one, both float32."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mc = cfg.mamba
        d = cfg.d_model
        di = int(mc.expand * d)
        dt_rank = max(d // 16, 1)
        n = mc.d_state
        self.cfg = cfg
        self.in_proj = _param(generator, (d, 2 * di), d, dtype, device)
        self.conv_w = _param(generator, (mc.d_conv, di), mc.d_conv, dtype,
                             device)
        self.conv_b = nn.Parameter(torch.zeros(di, dtype=dtype,
                                               device=device))
        self.x_proj = _param(generator, (di, dt_rank + 2 * n), di, dtype,
                             device)
        self.dt_proj = _param(generator, (dt_rank, di), dt_rank, dtype,
                              device)
        self.dt_bias = nn.Parameter(torch.zeros(di, dtype=dtype,
                                                device=device))
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
        self.A_log = nn.Parameter(a.expand(di, n).clone())
        self.D = nn.Parameter(torch.ones(di, dtype=torch.float32,
                                         device=device))
        self.out_proj = _param(generator, (di, d), di, dtype, device)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor = None,
                causal: bool = True, cache: Optional[dict] = None,
                dtype: Optional[torch.dtype] = None):
        return mamba_apply(_cast_params(self, dtype), x, self.cfg,
                           cache=cache)
