"""Sequence-mixing recurrences: the port of the JAX package's
``models/ssm.py``: Jamba's Mamba (selective SSM, diagonal ``A``) and
xLSTM's two cells, the mLSTM (matrix memory, an attention-like parallel
form) and the sLSTM (scalar memory, a strictly sequential loop).

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

``MLSTM`` holds ``wq``, ``wk``, ``wv``, ``og`` [d, H, dh], ``wo`` [H, dh,
d] and the gate projections ``wi``, ``wf`` [d, H], stored float32 (used,
like every float leaf, in the activation dtype, so a bf16 model rounds
them to bf16 before ``x`` in float32 multiplies them). ``mlstm_apply``
takes one of three forms, chosen by the reference's conditions: past
``_MLSTM_CHUNK`` tokens without a one-token cache step, the chunkwise form
(``_mlstm_chunked``: the ``(C, n, m)`` state carried over chunks of 512,
the masked parallel form inside each); otherwise, without a cache or over
more than one token, the fully parallel form over a ``[B, S, S, H]``
decay matrix (a prefill folds the prompt into the state); and one token
on a cache, one step of the recurrence. Its cache is ``{"C": [B, H, dh,
dh], "n": [B, H, dh], "m": [B, H]}``, float32 in every form, plus
``idx``; ``idx == 0`` means no state (``m = -1e30``).

``SLSTM`` holds ``w``, ``r`` [d, 4d] and the bias ``b`` [4d] (stored
float32). ``slstm_apply`` runs ``_slstm_step`` token by token over the
input gates ``x @ w``: the carried ``h`` in ``x``'s dtype, ``c``, ``n``,
``m`` and each step's output in float32. Its cache is ``{"h": [B, d]}`` in
the activation dtype and ``{"c", "n", "m": [B, d]}`` float32, plus
``idx``.

Neither xLSTM cell has the xLSTM paper's causal conv or up-projection:
the reference's cells have none (``XLSTMCfg.conv_dim`` and the
``proj_factor_*`` fields are config data that nothing reads).
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _cast_params, _param
from repro_torch.sharding import rules as R


def mamba_specs(cfg) -> dict:
    return {"in_proj": ("embed", "inner"), "conv_w": (None, "inner"),
            "conv_b": ("inner",), "x_proj": ("inner", None),
            "dt_proj": (None, "inner"), "dt_bias": ("inner",),
            "A_log": ("inner", None), "D": ("inner",),
            "out_proj": ("inner", "embed")}


def mlstm_specs(cfg) -> dict:
    return {"wq": ("embed", "heads", "qkv"), "wk": ("embed", "heads", "qkv"),
            "wv": ("embed", "heads", "qkv"), "wi": ("embed", "heads"),
            "wf": ("embed", "heads"), "wo": ("heads", "qkv", "embed"),
            "og": ("embed", "heads", "qkv")}


def slstm_specs(cfg) -> dict:
    return {"w": ("embed", "ff"), "r": ("embed", "ff"), "b": ("ff",)}


class _Trips:
    # trip windows of the recurrences' loops (None: every trip): the
    # sLSTM's time steps, the chunkwise mLSTM's and the Mamba scan's
    # chunks, and the window's factory of stand-ins for the skipped
    # trips; set only through ``trip_window``
    slstm = None
    mlstm = None
    mamba = None
    stand_in = None


_TRIPS = _Trips()

#: the windowed loops and their full trip counts at ``S`` tokens
TRIP_LOOPS = {"slstm": lambda S: S,
              "mlstm": lambda S: -(-S // _MLSTM_CHUNK),
              "mamba": lambda S: -(-S // _MAMBA_CHUNK)}


@contextlib.contextmanager
def trip_window(stand_in, **trips) -> Iterator[None]:
    """Run at most ``trips[loop]`` trips of each named loop in the block
    (``slstm``: time steps, ``mlstm`` / ``mamba``: chunks): a dry run's
    window. ``stand_in(outs, n)`` pads a loop's list of per-trip outputs
    to ``n`` entries of the same shapes for the trips it skipped (the
    dry run makes them uncounted). Their values are garbage, so the
    window is refused outside ``FakeTensorMode``."""
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is None:
        raise RuntimeError("a trip window runs only under FakeTensorMode")
    prev = {k: getattr(_TRIPS, k) for k in (*trips, "stand_in")}
    for k, v in dict(trips, stand_in=stand_in).items():
        setattr(_TRIPS, k, v)
    try:
        yield
    finally:
        for k, v in prev.items():
            setattr(_TRIPS, k, v)


def _trips(loop: str, n: int) -> int:
    """The trips of ``loop`` to run out of ``n``."""
    w = getattr(_TRIPS, loop)
    return n if w is None else min(n, w)


def _all_trips(outs: list, n: int) -> list:
    """``outs`` with the window's stand-ins for the trips it skipped."""
    return outs if len(outs) >= n else _TRIPS.stand_in(outs, n)


def _run(module, apply, x, cache, dtype):
    """A recurrent mixer's forward: ``apply`` on its cast parameters, or
    on a mesh ``models.sharded.recurrent``."""
    params = _cast_params(module, dtype)
    if R.get_mesh() is not None:
        from repro_torch.models import sharded
        return sharded.recurrent(apply, params, x, module.cfg, cache)
    return apply(params, x, module.cfg, cache=cache)

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
    for j in range(_trips("mamba", nb)):
        sl = slice(j * chunk, (j + 1) * chunk)
        y, h = block(u[:, sl], dt[:, sl], B[:, sl], C[:, sl], h)
        ys.append(y)
    return torch.cat(_all_trips(ys, nb), 1)[:, :s], h


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
        return _run(self, mamba_apply, x, cache, dtype)

    def logical_axes(self) -> dict:
        return mamba_specs(self.cfg)


# --------------------------------------------------------------------------- #
# mLSTM (xLSTM's matrix-memory cell): parallel, chunkwise and recurrent forms
# --------------------------------------------------------------------------- #
_MLSTM_CHUNK = 512
_NO_STATE = -1e30      # the log-scale stabilizer of an empty state


_SUM_BLOCK = 16


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _cumsum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` in ``x``'s dtype, blocked: a
    running sum inside each block of ``_SUM_BLOCK`` elements, plus the
    (recursively blocked) exclusive prefix of the block totals. This is the
    order in which the reference's ``jnp.cumsum`` adds (XLA rewrites the
    cumulative reduce-window into blocks of 16), so the decay exponents
    ``a[t] - a[s]`` agree bit for bit; ``torch.cumsum`` adds in another
    order (on the CPU in float64), which moves a 512-token ``a`` by ~1e-4.
    About 20 small ops per level, ``ceil(log16 S)`` levels."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    nb = -(-n // _SUM_BLOCK)
    cols = list(F.pad(x, (0, nb * _SUM_BLOCK - n))
                .unflatten(-1, (nb, _SUM_BLOCK)).unbind(-1))
    for i in range(1, _SUM_BLOCK):
        cols[i] = cols[i] + cols[i - 1]
    out = torch.stack(cols, -1)
    if nb > 1:
        pre = _cumsum(out[..., -1], -1)
        out = out + F.pad(pre[..., :-1], (1, 0))[..., None]
    return out.flatten(-2)[..., :n].movedim(-1, dim)


def _mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int = _MLSTM_CHUNK):
    """Chunkwise mLSTM: a loop over ``ceil(S / chunk)`` chunks carrying
    the ``(C, n, m)`` matrix-memory state (float32), the masked parallel
    form inside each chunk, so O(B·chunk²·H) is live instead of the fully
    parallel form's O(B·S²·H). q/k/v [B,S,H,dh], i_pre/f_pre [B,S,H]
    float32 -> (h [B,S,H,dh] in ``v``'s dtype, (C, n, m))."""
    B, S, H, dh = q.shape
    nb = -(-S // chunk)
    pad = nb * chunk - S

    def _pad(t, fill=0.0):
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad), value=fill)

    lf = _pad(F.logsigmoid(f_pre))                       # [B,S',H]
    ic = _pad(i_pre, _NO_STATE)
    q, k, v = _pad(q), _pad(k), _pad(v)
    ar = torch.arange(chunk, device=q.device)
    tri = (ar[:, None] >= ar[None, :])[None, :, :, None]
    Cst = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
    nst = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    m_in = torch.full((B, H), _NO_STATE, dtype=torch.float32,
                      device=q.device)
    hs = []
    for j in range(_trips("mlstm", nb)):
        sl = slice(j * chunk, (j + 1) * chunk)
        qj, kj, vj, lfj, ij = q[:, sl], k[:, sl], v[:, sl], lf[:, sl], \
            ic[:, sl]
        a = _cumsum(lfj)                                 # [B,C,H]
        logw = a[:, :, None, :] - a[:, None, :, :] + ij[:, None, :, :]
        logw = torch.where(tri, logw, -math.inf)
        inter = a + m_in[:, None, :]                     # [B,C,H]
        m_t = torch.maximum(logw.amax(dim=2), inter)
        m_t = torch.clamp_min(m_t, _NO_STATE)
        wD = torch.exp(logw - m_t[:, :, None, :])        # [B,C,C,H]
        qk = _f32(torch.einsum("bthd,bshd->btsh", qj, kj))
        qkw = qk * wD
        intra = torch.einsum("btsh,bshe->bthe", qkw.to(vj.dtype), vj)
        winter = torch.exp(inter - m_t)                  # [B,C,H]
        qC = torch.einsum("bthd,bhde->bthe", _f32(qj), Cst)
        num = winter[..., None] * qC + _f32(intra)
        qn = torch.einsum("bthd,bhd->bth", _f32(qj), nst)
        n_t = winter * qn + qkw.sum(dim=2)
        den = torch.maximum(n_t.abs(), torch.exp(-m_t))
        hs.append((num / den[..., None]).to(vj.dtype))   # [B,C,H,dh]
        # the state at the chunk's end
        a_end = a[:, -1]                                 # [B,H]
        w_end = a_end[:, None, :] - a + ij               # [B,C,H]
        m_out = torch.maximum(a_end + m_in, w_end.amax(dim=1))
        m_out = torch.clamp_min(m_out, _NO_STATE)
        carry = torch.exp(a_end + m_in - m_out)
        we = torch.exp(w_end - m_out[:, None, :])
        kw = we[..., None] * _f32(kj)                    # [B,C,H,dh]
        Cst = carry[..., None, None] * Cst + torch.einsum(
            "bshd,bshe->bhde", kw, _f32(vj))
        nst = carry[..., None] * nst + kw.sum(dim=1)
        m_in = m_out
    return torch.cat(_all_trips(hs, nb), dim=1)[:, :S], (Cst, nst, m_in)


def _mlstm_parallel(q, k, v, i_pre, f_pre):
    """The fully parallel mLSTM over a ``[B, S, S, H]`` decay matrix
    (``D[t, s] = exp(a[t] - a[s] + i[s] - m[t])`` for ``s <= t``, ``a`` the
    prefix sum of the log forget gates, ``m[t]`` its row maximum): q/k/v
    [B,S,H,dh], i_pre/f_pre [B,S,H] float32 -> (h [B,S,H,dh] in ``v``'s
    dtype, divided in ``v``'s dtype; ``a`` [B,S,H]). Each [B,S,S,H]
    intermediate is freed as soon as the next one exists."""
    S = q.shape[1]
    a = _cumsum(F.logsigmoid(f_pre))                     # [B,S,H]
    # log D[t, s] = a[t] - a[s] + i_pre[s], s <= t
    logD = a[:, :, None, :] - a[:, None, :, :] + i_pre[:, None, :, :]
    ar = torch.arange(S, device=q.device)
    causal = (ar[:, None] >= ar[None, :])[None, :, :, None]
    logD = torch.where(causal, logD, -math.inf)
    mrow = torch.clamp_min(logD.amax(dim=2, keepdim=True), _NO_STATE)
    Dmat = torch.exp(logD - mrow)                        # [B,S,S,H]
    del logD
    scores = _f32(torch.einsum("bthk,bshk->btsh", q, k)) * Dmat
    del Dmat
    # the stabilized floor exp(-m) is the true-scale floor 1.0
    norm = torch.maximum(scores.sum(dim=2).abs(),
                         torch.exp(-mrow[:, :, 0, :]))   # [B,S,H]
    h = torch.einsum("btsh,bshk->bthk", scores.to(v.dtype), v)
    del scores
    return h / norm[..., None].to(v.dtype), a


def mlstm_apply(params: dict, x: torch.Tensor, cfg, *,
                cache: Optional[dict] = None):
    """x [B,S,d] -> (y [B,S,d], new_cache). cache: None, or dict(C [B,H,
    dh,dh], n [B,H,dh], m [B,H], idx int). The form is the reference's
    choice: chunkwise when ``(cache is None or S > 1) and S >
    _MLSTM_CHUNK``; fully parallel (a prefill folding the prompt into the
    state) when ``cache is None or S > 1``; else one recurrence step."""
    H = cfg.n_heads
    B, S, d = x.shape
    dh = d // H

    def heads(w):
        return (x @ w.flatten(1)).unflatten(-1, (H, dh))

    q = heads(params["wq"]) / math.sqrt(dh)
    k = heads(params["wk"]) / math.sqrt(dh)
    v = heads(params["wv"])
    i_pre = _mm(_f32(x), params["wi"])                   # [B,S,H] float32
    f_pre = _mm(_f32(x), params["wf"])
    og = torch.sigmoid(heads(params["og"]))

    def out(h):
        return (h * og).flatten(2) @ params["wo"].flatten(0, 1)

    if (cache is None or S > 1) and S > _MLSTM_CHUNK:
        h, (Cs, ns, ms) = _mlstm_chunked(q, k, v, i_pre, f_pre)
        new_cache = None
        if cache is not None:
            new_cache = {"C": Cs, "n": ns, "m": ms, "idx": cache["idx"] + S}
        return out(h), new_cache

    if cache is None or S > 1:
        h, a = _mlstm_parallel(q, k, v, i_pre, f_pre)
        new_cache = None
        if cache is not None:      # prefill: fold the prompt into the state
            w = (a[:, -1:, :] - a) + i_pre                   # [B,S,H]
            m_fin = w.amax(dim=1)                            # [B,H]
            kw = torch.exp(w - m_fin[:, None, :])[..., None] * _f32(k)
            new_cache = {"C": torch.einsum("bshk,bshl->bhkl", kw, _f32(v)),
                         "n": kw.sum(dim=1), "m": m_fin,
                         "idx": cache["idx"] + S}
        return out(h), new_cache

    # one recurrence step: C [B,H,dh,dh], n [B,H,dh], m [B,H]
    C, n, m, idx = cache["C"], cache["n"], cache["m"], cache["idx"]
    if idx == 0:                   # a zeroed cache holds no state
        m = torch.full_like(m, _NO_STATE)
    logf = F.logsigmoid(f_pre[:, 0])                     # [B,H]
    m_new = torch.maximum(logf + m, i_pre[:, 0])
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(i_pre[:, 0] - m_new)
    k0, v0, q0 = _f32(k[:, 0]), _f32(v[:, 0]), _f32(q[:, 0])
    C = fg[..., None, None] * C + ig[..., None, None] * (
        k0[..., :, None] * v0[..., None, :])
    n = fg[..., None] * n + ig[..., None] * k0
    num = (q0[..., None, :] @ C)[..., 0, :]              # [B,H,dh]
    den = torch.maximum((q0 * n).sum(-1).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).to(v.dtype)[:, None]
    return out(h), {"C": C, "n": n, "m": m_new, "idx": idx + 1}


def mlstm_cache_shape(cfg, batch: int, dtype: torch.dtype = None, *,
                      device=None) -> dict:
    """A zeroed mLSTM decode cache, float32 whatever the activation dtype
    (the reference's ``mlstm_cache_shape``; the port allocates it)."""
    H = cfg.n_heads
    dh = cfg.d_model // H

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"C": zeros(batch, H, dh, dh), "n": zeros(batch, H, dh),
            "m": zeros(batch, H), "idx": 0}


class MLSTM(nn.Module):
    """xLSTM's mLSTM mixer (the reference's ``init_mlstm``): every weight
    drawn by ``_dense_init`` with fan-in d, ``wi`` and ``wf`` float32."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        dh = d // H
        self.cfg = cfg
        self.wq = _param(generator, (d, H, dh), d, dtype, device)
        self.wk = _param(generator, (d, H, dh), d, dtype, device)
        self.wv = _param(generator, (d, H, dh), d, dtype, device)
        self.wi = _param(generator, (d, H), d, torch.float32, device)
        self.wf = _param(generator, (d, H), d, torch.float32, device)
        self.wo = _param(generator, (H, dh, d), d, dtype, device)
        self.og = _param(generator, (d, H, dh), d, dtype, device)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor = None,
                causal: bool = True, cache: Optional[dict] = None,
                dtype: Optional[torch.dtype] = None):
        return _run(self, mlstm_apply, x, cache, dtype)

    def logical_axes(self) -> dict:
        return mlstm_specs(self.cfg)


# --------------------------------------------------------------------------- #
# sLSTM (xLSTM's scalar-memory cell, exponential gating): a sequential loop
# --------------------------------------------------------------------------- #
def _slstm_step(params: dict, carry: tuple, xw: torch.Tensor):
    """One token: carry (h in ``x``'s dtype, c, n, m float32), xw [B, 4d]
    float32 -> (the next carry, h_new float32)."""
    h, c, n, m = carry
    gates = xw + _f32(h @ params["r"]) + params["b"]
    i_pre, f_pre, z_pre, o_pre = gates.chunk(4, dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    ig = torch.exp(i_pre - m_new)
    fg = torch.exp(logf + m - m_new)
    c = fg * c + ig * torch.tanh(z_pre)
    n = fg * n + ig
    # the stabilized floor exp(-m) is the true-scale floor 1.0
    h_new = torch.sigmoid(o_pre) * c / torch.maximum(n, torch.exp(-m_new))
    return (h_new.to(h.dtype), c, n, m_new), h_new


def slstm_apply(params: dict, x: torch.Tensor, cfg, *,
                cache: Optional[dict] = None):
    """x [B,S,d] -> (y [B,S,d] in ``x``'s dtype, new_cache): ``S``
    sequential steps from the zero state (``m = -1e30``) or from the
    cache's (dict(h [B,d], c, n, m [B,d], idx int); ``idx == 0`` means no
    state)."""
    B, S, d = x.shape
    xw = _f32(x @ params["w"])                           # [B,S,4d]

    def zeros():
        return torch.zeros((B, d), dtype=torch.float32, device=x.device)

    if cache is None:
        carry = (torch.zeros((B, d), dtype=x.dtype, device=x.device),
                 zeros(), zeros(),
                 torch.full((B, d), _NO_STATE, dtype=torch.float32,
                            device=x.device))
    else:
        m0 = (torch.full_like(cache["m"], _NO_STATE) if cache["idx"] == 0
              else cache["m"])
        carry = (cache["h"], cache["c"], cache["n"], m0)
    hs = []
    for t in range(_trips("slstm", S)):
        carry, h_t = _slstm_step(params, carry, xw[:, t])
        hs.append(h_t)
    y = torch.stack(_all_trips(hs, S), dim=1).to(x.dtype)
    new_cache = None
    if cache is not None:
        h, c, n, m = carry
        new_cache = {"h": h.to(x.dtype), "c": c, "n": n, "m": m,
                     "idx": cache["idx"] + S}
    return y, new_cache


def slstm_cache_shape(cfg, batch: int, dtype: torch.dtype, *,
                      device=None) -> dict:
    """A zeroed sLSTM decode cache: ``h`` in the activation dtype, ``c``,
    ``n``, ``m`` float32 (the reference's ``slstm_cache_shape``)."""
    d = cfg.d_model

    def zeros(dt):
        return torch.zeros((batch, d), dtype=dt, device=device)

    return {"h": zeros(dtype), "c": zeros(torch.float32),
            "n": zeros(torch.float32), "m": zeros(torch.float32), "idx": 0}


class SLSTM(nn.Module):
    """xLSTM's sLSTM mixer (the reference's ``init_slstm``): the gates i,
    f, z, o from the input (``w``) and the recurrent ``h`` (``r``), both
    [d, 4d] with fan-in d, and a zero bias ``b`` [4d] stored float32."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.w = _param(generator, (d, 4 * d), d, dtype, device)
        self.r = _param(generator, (d, 4 * d), d, dtype, device)
        self.b = nn.Parameter(torch.zeros(4 * d, dtype=torch.float32,
                                          device=device))

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor = None,
                causal: bool = True, cache: Optional[dict] = None,
                dtype: Optional[torch.dtype] = None):
        return _run(self, slstm_apply, x, cache, dtype)

    def logical_axes(self) -> dict:
        return slstm_specs(self.cfg)
