"""Neural layers of the LM stack: the port of the JAX package's
``models/layers.py``.

Each layer is a pure function over tensors under the reference's name
(``norm_apply``, ``rope``, ``mlp_apply``, ``_sdpa_dense``,
``_sdpa_blockwise``, ``_sdpa``, ``attention_apply``, ``mla_apply``,
``cross_attention_apply``) and an
``nn.Module`` (``Norm``, ``MLP``, ``Attention``, ``MLA``) that holds the
parameters in the reference's shapes and calls it, with its float parameters cast to the
compute dtype it is given (the reference's ``_cast_floats``).

The numerics are the reference's own: norms in float32 cast back; attention
scores in float32 with a ``-1e30`` mask, the probabilities cast to ``v``'s
dtype; past ``_SDPA_BLOCK_THRESHOLD`` the online-softmax ``(m, l, acc)``
loop over KV blocks of 1024, ``acc`` in ``v``'s dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import rules as R


# --------------------------------------------------------------------------- #
# initializers
# --------------------------------------------------------------------------- #
_INIT_CHUNK = 1 << 27     # float32 elements drawn at a time (512 MB)


def _dense_init(generator: torch.Generator, shape, in_axis_size: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1 / in_axis_size) drawn in float32 from ``generator`` on
    its device, then cast to ``dtype``. A tensor of more than
    ``_INIT_CHUNK`` elements is drawn in slices along its first axis, one
    after the other from the same generator, so the float32 draw of an
    expert stack never sits beside the whole stack."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    shape = tuple(shape)

    def draw(shp):
        w = torch.randn(shp, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(scale).to(dtype)

    if math.prod(shape) <= _INIT_CHUNK or len(shape) < 2:
        return draw(shape)
    rows = max(1, _INIT_CHUNK // math.prod(shape[1:]))
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    for r in range(0, shape[0], rows):
        out[r:r + rows] = draw((min(rows, shape[0] - r),) + shape[1:])
    return out


def _param(generator: Optional[torch.Generator], shape, in_axis_size: int,
           dtype: torch.dtype, device) -> nn.Parameter:
    """A dense weight: drawn by ``_dense_init``, or left uninitialized when
    there is no generator (weights about to be loaded)."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    return nn.Parameter(_dense_init(generator, shape, in_axis_size, dtype))


def _cast_params(module: nn.Module, dtype: Optional[torch.dtype]) -> dict:
    """``module``'s own parameters by name, the float ones cast to
    ``dtype`` (``None`` leaves them as stored). On a mesh, inside a block
    under ``fsdp_gather_weights``, each is then redistributed with its
    FSDP axis gathered (``rules.constrain_gathered``)."""
    out = {n: p if dtype is None or not p.is_floating_point()
           else p.to(dtype)
           for n, p in module.named_parameters(recurse=False)}
    if R.gathering_weights():
        out = R.constrain_gathered(out, module.logical_axes())
    return out


def _own(specs: dict) -> dict:
    """A module's own leaves of a specs tree (its submodules' dropped)."""
    return {k: v for k, v in specs.items() if not isinstance(v, dict)}


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def norm_specs(kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ("embed",)}
    if kind == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {}


def norm_apply(params: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


class Norm(nn.Module):
    """``rmsnorm`` (scale), ``layernorm`` (scale, bias) or ``nonparam_ln``
    (OLMo: no learned affine)."""

    def __init__(self, d: int, kind: str, *, dtype: torch.dtype, device=None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm", "nonparam_ln"):
            raise ValueError(kind)
        self.kind = kind
        if kind != "nonparam_ln":
            self.scale = nn.Parameter(torch.ones(d, dtype=dtype,
                                                 device=device))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype,
                                                 device=device))

    def logical_axes(self) -> dict:
        return norm_specs(self.kind)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return norm_apply(_cast_params(self, dtype), x, self.kind)


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0,
         pct: float = 1.0) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S] integer."""
    D = x.shape[-1]
    rot = int(D * pct) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    # positions [..., S] -> [..., S, 1(H), half]
    ang = positions[..., :, None, None].to(torch.float32) * freq
    x1, x2 = xr[..., :half], xr[..., half:]
    c, s = torch.cos(ang), torch.sin(ang)
    y = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)
    return torch.cat([y.to(x.dtype), xp], -1)


# --------------------------------------------------------------------------- #
# dense MLP (swiglu / gelu)
# --------------------------------------------------------------------------- #
def mlp_specs(act: str) -> dict:
    if act == "swiglu":
        return {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
                "w_down": ("ff", "embed")}
    return {"w_in": ("embed", "ff"), "w_out": ("ff", "embed")}


def mlp_apply(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ params["w_in"], approximate="tanh")
    return h @ params["w_out"]


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, act: str, *, dtype: torch.dtype,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = act
        if act == "swiglu":
            self.w_gate = _param(generator, (d, d_ff), d, dtype, device)
            self.w_up = _param(generator, (d, d_ff), d, dtype, device)
            self.w_down = _param(generator, (d_ff, d), d_ff, dtype, device)
        else:
            self.w_in = _param(generator, (d, d_ff), d, dtype, device)
            self.w_out = _param(generator, (d_ff, d), d_ff, dtype, device)

    def logical_axes(self) -> dict:
        return mlp_specs(self.act)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if R.get_mesh() is not None:
            from repro_torch.models import sharded
            return sharded.mlp(_cast_params(self, dtype), x, self.act)
        return mlp_apply(_cast_params(self, dtype), x, self.act)


# --------------------------------------------------------------------------- #
# GQA attention (with optional decode cache)
# --------------------------------------------------------------------------- #
def attention_specs(cfg) -> dict:
    return {"wq": ("embed", "heads", "qkv"),
            "wk": ("embed", "kv_heads", "qkv"),
            "wv": ("embed", "kv_heads", "qkv"),
            "wo": ("heads", "qkv", "embed")}


_SDPA_BLOCK_THRESHOLD = 4096 * 4096   # T*S above this -> blockwise path
_SDPA_KV_BLOCK = 1024
_MASKED = -1e30


def _scores(qg, k, soft_cap: float = 0.0):
    """Grouped queries qg [B,T,Hkv,G,D] against keys k [B,S,Hkv,D]: the
    float32 scores [B,Hkv,G,T,S], scaled by 1/sqrt(D) and soft-capped."""
    s = torch.einsum("bthgd,bshd->bhgts", qg, k) / math.sqrt(qg.shape[-1])
    s = s.float()
    if soft_cap > 0:
        s = soft_cap * torch.tanh(s / soft_cap)
    return s


def _sdpa_dense(q, k, v, *, causal: bool, q_offset: int,
                kv_len_valid: Optional[int] = None, soft_cap: float = 0.0):
    """q [B,T,H,D], k/v [B,S,Hkv,D] -> [B,T,H,D]; GQA via head grouping."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scores = _scores(q.reshape(B, T, Hkv, G, D), k, soft_cap)
    tpos = torch.arange(T, device=q.device)[:, None] + q_offset
    spos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= spos <= tpos
    if kv_len_valid is not None:
        mask &= spos < kv_len_valid
    scores = torch.where(mask, scores, _MASKED)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", p, v)
    return out.reshape(B, T, H, v.shape[-1])


def _sdpa_blockwise(q, k, v, *, causal: bool, q_offset: int,
                    kv_len_valid: Optional[int] = None, soft_cap: float = 0.0,
                    kv_block: int = _SDPA_KV_BLOCK):
    """Online-softmax blockwise attention (the flash-attention dataflow in
    plain PyTorch): a loop over KV blocks with an (m, l, acc) carry, so
    O(T * kv_block) scores are live instead of O(T * S). The long-context
    prefill path. The in-place steps round as the reference's out-of-place
    ones do."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    Dv = v.shape[-1]
    nb = -(-S // kv_block)
    pad = nb * kv_block - S
    k = F.pad(k, (0, 0, 0, 0, 0, pad))
    v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, T, Hkv, G, D)
    tpos = torch.arange(T, device=q.device) + q_offset
    valid_len = S if kv_len_valid is None else kv_len_valid

    m = torch.full((B, Hkv, G, T), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, T, Dv), dtype=v.dtype, device=q.device)
    for j in range(nb):
        kj = k[:, j * kv_block:(j + 1) * kv_block]
        vj = v[:, j * kv_block:(j + 1) * kv_block]
        spos = j * kv_block + torch.arange(kv_block, device=q.device)
        s = torch.einsum("bthgd,bshd->bhgts", qg, kj).float()
        s.div_(math.sqrt(D))
        if soft_cap > 0:
            s = soft_cap * torch.tanh(s / soft_cap)
        mask = spos[None, :] < valid_len
        if causal:
            mask = mask & (spos[None, :] <= tpos[:, None])
        s.masked_fill_(~mask, _MASKED)
        m2 = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m2)
        p = s.sub_(m2[..., None]).exp_()
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhgts,bshd->bhgtd", p.to(vj.dtype), vj)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m2
    out = acc / torch.clamp_min(l, 1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dv)


def _sdpa(q, k, v, *, causal: bool, q_offset: int,
          kv_len_valid: Optional[int] = None, soft_cap: float = 0.0):
    T, S = q.shape[1], k.shape[1]
    if T * S > _SDPA_BLOCK_THRESHOLD and T > 1:
        return _sdpa_blockwise(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len_valid=kv_len_valid, soft_cap=soft_cap)
    return _sdpa_dense(q, k, v, causal=causal, q_offset=q_offset,
                       kv_len_valid=kv_len_valid, soft_cap=soft_cap)


def _write_cache(buf: torch.Tensor, new: torch.Tensor, idx: int) -> None:
    """``buf[:, idx:idx + T] = new`` in place; raise where the reference's
    ``dynamic_update_slice`` would clamp the start."""
    T = new.shape[1]
    if idx + T > buf.shape[1]:
        raise ValueError(f"the KV cache holds {buf.shape[1]} positions; "
                         f"writing {T} at {idx} runs past it")
    buf[:, idx:idx + T] = new


def _project(x, w, cfg, positions):
    """``x`` [B,T,d] through ``w`` [d,H,Dh] into heads, rope applied."""
    h = (x @ w.flatten(1)).unflatten(-1, w.shape[1:])
    return rope(h, positions, theta=cfg.rope_theta, pct=cfg.rotary_pct)


def attention_kv(params: dict, x: torch.Tensor, cfg, positions):
    """The keys (rope applied) and values [B,T,Hkv,Dh] of ``x``."""
    v = (x @ params["wv"].flatten(1)).unflatten(-1, params["wv"].shape[1:])
    return _project(x, params["wk"], cfg, positions), v


def attention_apply(params: dict, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, causal: bool = True,
                    cache: Optional[dict] = None):
    """cache: None (full sequence) or dict(k, v [B,Smax,Hkv,D], idx int).
    Returns (y, new_cache).

    The cache's k/v are written in place at ``idx`` (the caller hands the
    cache over, as the reference's serve loop donates it) and ``idx`` is a
    host int. A write that would run past ``Smax`` raises ``ValueError``,
    where the reference's ``dynamic_update_slice`` clamps the start and
    overwrites earlier positions."""
    T = x.shape[1]
    q = _project(x, params["wq"], cfg, positions)
    k, v = attention_kv(params, x, cfg, positions)
    if cache is None:
        out = _sdpa(q, k, v, causal=causal, q_offset=0,
                    soft_cap=cfg.attn_logit_soft_cap)
        new_cache = {"k": k, "v": v, "idx": T}
    else:
        idx = cache["idx"]
        ck, cv = cache["k"], cache["v"]
        _write_cache(ck, k, idx)
        _write_cache(cv, v, idx)
        out = _sdpa(q, ck, cv, causal=causal, q_offset=idx,
                    kv_len_valid=idx + T, soft_cap=cfg.attn_logit_soft_cap)
        new_cache = {"k": ck, "v": cv, "idx": idx + T}
    y = out.flatten(2) @ params["wo"].flatten(0, 1)
    return y, new_cache


class Attention(nn.Module):
    """GQA self-attention: wq [d,H,Dh], wk/wv [d,Hkv,Dh], wo [H,Dh,d]."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _param(generator, (d, H, Dh), d, dtype, device)
        self.wk = _param(generator, (d, Hkv, Dh), d, dtype, device)
        self.wv = _param(generator, (d, Hkv, Dh), d, dtype, device)
        self.wo = _param(generator, (H, Dh, d), H * Dh, dtype, device)

    def logical_axes(self) -> dict:
        return attention_specs(self.cfg)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                causal: bool = True, cache: Optional[dict] = None,
                dtype: Optional[torch.dtype] = None):
        if R.get_mesh() is not None:
            from repro_torch.models import sharded
            return sharded.attention(_cast_params(self, dtype), x, self.cfg,
                                     positions=positions, causal=causal,
                                     cache=cache)
        return attention_apply(_cast_params(self, dtype), x, self.cfg,
                               positions=positions, causal=causal,
                               cache=cache)


# --------------------------------------------------------------------------- #
# MLA: multi-head latent attention (DeepSeek-V2/V3)
# --------------------------------------------------------------------------- #
def mla_specs(cfg) -> dict:
    return {"wdq": ("embed", "lora"), "q_norm": norm_specs("rmsnorm"),
            "wuq": ("lora", "heads", "qkv"), "wdkv": ("embed", "lora"),
            "kv_norm": norm_specs("rmsnorm"),
            "wuk": ("lora", "heads", "qkv"),
            "wuv": ("lora", "heads", "qkv"),
            "wo": ("heads", "qkv", "embed")}


def mla_apply(params: dict, x: torch.Tensor, cfg, *,
              positions: torch.Tensor, causal: bool = True,
              cache: Optional[dict] = None):
    """The latent cache holds ``ckv`` [B, Smax, kv_lora] (the normed KV
    latent) and ``kr`` [B, Smax, rope] (the one rope key head, shared by
    every query head), written in place at ``idx``; each call expands the
    keys and values of the whole cache from it. q and k have head dim
    nope + rope, v has v_head_dim. Returns (y, new_cache)."""
    m = cfg.mla
    H = cfg.n_heads
    T = x.shape[1]
    cq = norm_apply(params["q_norm"], x @ params["wdq"], "rmsnorm")
    q = (cq @ params["wuq"].flatten(1)).unflatten(-1, (H, -1))
    qn, qr = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    qr = rope(qr, positions, theta=cfg.rope_theta)

    dkv = x @ params["wdkv"]
    ckv = norm_apply(params["kv_norm"], dkv[..., :m.kv_lora_rank],
                     "rmsnorm")
    kr = rope(dkv[..., m.kv_lora_rank:][:, :, None, :], positions,
              theta=cfg.rope_theta)[:, :, 0, :]     # the shared rope key

    if cache is not None:
        idx = cache["idx"]
        _write_cache(cache["ckv"], ckv, idx)
        _write_cache(cache["kr"], kr, idx)
        ckv, kr = cache["ckv"], cache["kr"]
        new_cache = {"ckv": ckv, "kr": kr, "idx": idx + T}
        q_offset, kv_valid = idx, idx + T
    else:
        new_cache = {"ckv": ckv, "kr": kr, "idx": T}
        q_offset, kv_valid = 0, None

    kn = (ckv @ params["wuk"].flatten(1)).unflatten(-1, (H, -1))
    v = (ckv @ params["wuv"].flatten(1)).unflatten(-1, (H, -1))
    # the rope key head joins every head's keys, so one SDPA computes
    # qn.kn + qr.kr (dense or blockwise)
    q_eff = torch.cat([qn, qr], -1)
    k_eff = torch.cat([kn, kr[:, :, None, :].expand(-1, -1, H, -1)], -1)
    out = _sdpa(q_eff, k_eff, v, causal=causal or cache is not None,
                q_offset=q_offset, kv_len_valid=kv_valid)
    y = out.flatten(2) @ params["wo"].flatten(0, 1)
    return y, new_cache


def mla_cache_shape(cfg, batch: int, max_len: int, dtype: torch.dtype, *,
                    device=None) -> dict:
    """A zeroed MLA decode cache (the reference returns its shapes; the
    port allocates it)."""
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, m.rope_head_dim),
                              dtype=dtype, device=device),
            "idx": 0}


class MLA(nn.Module):
    """wdq [d, q_lora], q_norm, wuq [q_lora, H, nope + rope], wdkv [d,
    kv_lora + rope], kv_norm, wuk [kv_lora, H, nope], wuv [kv_lora, H, v],
    wo [H, v, d]."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = cfg.mla
        d, H = cfg.d_model, cfg.n_heads
        self.cfg = cfg
        self.wdq = _param(generator, (d, m.q_lora_rank), d, dtype, device)
        self.q_norm = Norm(m.q_lora_rank, "rmsnorm", dtype=dtype,
                           device=device)
        self.wuq = _param(generator, (m.q_lora_rank, H,
                                      m.nope_head_dim + m.rope_head_dim),
                          m.q_lora_rank, dtype, device)
        self.wdkv = _param(generator, (d, m.kv_lora_rank + m.rope_head_dim),
                           d, dtype, device)
        self.kv_norm = Norm(m.kv_lora_rank, "rmsnorm", dtype=dtype,
                            device=device)
        self.wuk = _param(generator, (m.kv_lora_rank, H, m.nope_head_dim),
                          m.kv_lora_rank, dtype, device)
        self.wuv = _param(generator, (m.kv_lora_rank, H, m.v_head_dim),
                          m.kv_lora_rank, dtype, device)
        self.wo = _param(generator, (H, m.v_head_dim, d), H * m.v_head_dim,
                         dtype, device)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                causal: bool = True, cache: Optional[dict] = None,
                dtype: Optional[torch.dtype] = None):
        params = _cast_params(self, dtype)
        params["q_norm"] = _cast_params(self.q_norm, dtype)
        params["kv_norm"] = _cast_params(self.kv_norm, dtype)
        if R.get_mesh() is not None:
            from repro_torch.models import sharded
            return sharded.mla(params, x, self.cfg, positions=positions,
                               causal=causal, cache=cache)
        return mla_apply(params, x, self.cfg, positions=positions,
                         causal=causal, cache=cache)

    def logical_axes(self) -> dict:
        return _own(mla_specs(self.cfg))


# --------------------------------------------------------------------------- #
# cross-attention (the encoder-decoder's decoder blocks)
# --------------------------------------------------------------------------- #
def cross_attention_apply(params: dict, x: torch.Tensor,
                          memory: torch.Tensor, cfg, *,
                          positions: torch.Tensor) -> torch.Tensor:
    """x [B,T,d] attends to the encoder's ``memory`` [B,L,d] with
    ``Attention``'s leaves (wq, wk, wv, wo): no rope, no mask. K and V are
    computed from ``memory`` at every call, decode steps too, as in the
    reference (which keeps no cross-attention cache); ``positions`` is
    taken for the signature's sake and unused."""
    q = (x @ params["wq"].flatten(1)).unflatten(-1, params["wq"].shape[1:])
    k = (memory @ params["wk"].flatten(1)).unflatten(
        -1, params["wk"].shape[1:])
    v = (memory @ params["wv"].flatten(1)).unflatten(
        -1, params["wv"].shape[1:])
    out = _sdpa(q, k, v, causal=False, q_offset=0)
    return out.flatten(2) @ params["wo"].flatten(0, 1)
