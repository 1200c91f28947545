"""The LM's layers on a mesh: what each module runs when an ambient mesh is
set (``sharding.rules.set_mesh``) and its parameters, batch and caches are
DTensors placed by the rules. Without a mesh none of this runs.

The layout follows the rules: batch over the data-parallel axes (``pod``,
``data``), weights ZeRO-3 sharded on ``embed`` over them and
tensor-parallel on heads, FFN hidden, vocab and experts over ``model``,
decode caches on batch and sequence. Each layer computes in a *region*
(``region``): its inputs are redistributed to the layout the layer
computes in, the layer runs on the local tensors, and its outputs become
DTensors again. Inside a region every weight is gathered over the
data-parallel axes (the FSDP dataflow; the backward reduce-scatters its
gradient), and:

  - attention, cross-attention, MLA and the dense MLP run Megatron-style:
    each ``model`` rank runs the plain layer (``attention_apply``,
    ``mla_apply``, ...) on its heads or FFN columns and returns its
    partial output on a leading dim of one, whose ``sum`` DTensor turns
    into a ``Partial`` over ``model``. Attention keeps its kv heads whole
    where they do not divide ``model`` (kv_heads=8 on 16), and each rank
    takes the ones its query heads read (``_kv_heads``). Where the heads
    do not divide ``model`` at all the layer runs replicated over it;
  - a prompt fills a cache from position 0 (a prefill) and the decode
    steps write one position each; a write past the cache's end raises
    as the plain path's does, and a prompt after earlier positions
    raises (the plain path supports it, the mesh path does not);
  - decode attention is flash-decoding over the sequence-sharded cache:
    each ``model`` rank writes the new key into its block of positions if
    the position falls there, scores all heads on its block
    (``layers._scores``), and the softmax's max and sums are reduced over
    ``model`` (``Partial("max")`` / ``Partial("sum")``);
  - the vocab-parallel embedding, logits and cross entropy keep the vocab
    sharded over ``model``: masked lookups, a max, a sum of exponentials
    and the gold logit, each reduced over ``model``;
  - the Mamba, mLSTM and sLSTM mixers run replicated over ``model`` (their
    weights and states gathered): their fused projections are not split
    for tensor parallelism;
  - the MoE routes in one region and runs its experts in another, expert
    parallel over ``model``: with the global dispatch every rank sorts all
    tokens (they are gathered), with the hierarchical one each
    data-parallel group sorts its own, and the combine gathers the expert
    outputs over ``model``.

A region's replicated input whose use differs across the ranks of a mesh
dim (because another input is sharded on it) gets a ``Partial`` gradient
there, so its backward sums the ranks' contributions. Regions take and
return only ``Shard`` and ``Replicate`` placements, which the DTensor
releases this port runs on handle alike.

DTensor has no sharding strategy, or none that keeps the layout, for
these ops, so each runs inside a region, on local tensors, where its
placement is explicit: ``searchsorted``, the stable ``sort`` / ``argsort``
and the index_put of the MoE dispatch (its load is a ``scatter_add_``:
``bincount``'s shape depends on the data); ``log_sigmoid`` and the
``_cumsum`` of the xLSTM cells; the Mamba and sLSTM scans; the attention
einsums over grouped heads (a reshape of a head dim sharded on ``model``
made a strided shard that ``bmm`` refused); the in-place cache writes;
the vocab-masked lookups and gathers; ``argmax`` over the vocab. The
reference's ``maybe_constrain`` sites in its MoE (``moe.py`` :102, 107,
143, 175, 180, 183, 192) are the MoE regions' placements here: the slot
buffer and the expert outputs with experts over ``model`` and slots (or
groups) over the data axes. The rest (norms, residual adds, casts, the
clip and AdamW) are DTensor ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.sharding import rules as R

__all__ = ["region", "attention", "mla", "cross_attention", "mlp", "moe",
           "recurrent", "embed", "linear", "logits", "greedy", "shift_left",
           "cross_entropy", "init_cache", "dp_groups", "local_block",
           "shard_tensor", "shard_params"]


# --------------------------------------------------------------------------- #
# placements and regions
# --------------------------------------------------------------------------- #
def _mesh():
    mesh = R.get_mesh()
    if mesh is None:
        raise RuntimeError("the mesh path needs an ambient mesh (set_mesh)")
    return mesh


def _dp_dims(mesh) -> list:
    return [a for a in R.DP_AXES if a in mesh.mesh_dim_names]


def _size(mesh, axes) -> int:
    return math.prod(R._sizes(mesh)[a] for a in axes)


def place(mesh, ndim: int, **dims) -> list:
    """Placements of an ``ndim`` tensor: ``dims`` maps tensor dims (as
    ``d0``, ``d1``, ...) to mesh-axis names or tuples of names; every other
    mesh dim is replicated."""
    spec = [None] * ndim
    for k, axes in dims.items():
        spec[int(k[1:])] = axes
    return R.to_placements(tuple(spec), mesh)


def batch_axes(mesh, batch: int):
    """The data-parallel axes that shard a batch of ``batch`` rows, or
    None where their product does not divide it."""
    dp = _dp_dims(mesh)
    return tuple(dp) if dp and batch % _size(mesh, dp) == 0 else None


def tp(mesh, n: int) -> Optional[str]:
    """``"model"`` where ``n`` (heads, FFN columns, vocab) splits over
    it, else None."""
    if "model" not in mesh.mesh_dim_names:
        return None
    m = _size(mesh, ("model",))
    return "model" if m > 1 and n % m == 0 else None


def model_coord(mesh) -> int:
    return mesh.get_local_rank("model") if "model" in mesh.mesh_dim_names \
        else 0


def region(fn, ins: Sequence, outs: Sequence):
    """Run ``fn`` on local tensors. ``ins`` is a list of ``(tensor,
    placements)``: each tensor is redistributed to its placements (a plain
    tensor counts as replicated) and handed to ``fn`` as its local
    shard; ``placements=None`` hands the object over as it is. A
    replicated input gets a ``Partial`` gradient on the mesh dims that
    shard another input. ``outs`` gives each result's placements (None:
    returned as is)."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = _mesh()
    varying = {i for t, pl in ins if pl is not None and t is not None
               for i, p in enumerate(pl) if p.is_shard()}
    local = []
    for t, pl in ins:
        if pl is None or t is None:
            local.append(t)
            continue
        d = R._redistribute(t, mesh, pl)
        grad = [Partial() if i in varying and not p.is_shard() else p
                for i, p in enumerate(pl)]
        local.append(d.to_local(grad_placements=grad))
    res = fn(*local)
    single = not isinstance(res, tuple)
    res = (res,) if single else res
    out = tuple(DTensor.from_local(r, mesh, pl, run_check=False)
                if pl is not None and isinstance(r, torch.Tensor) else r
                for r, pl in zip(res, outs))
    return out[0] if single else out


def _partial_sum(stacked):
    """A DTensor whose dim 0 (one per ``model`` rank) holds each rank's
    partial result: their sum, a ``Partial`` over ``model``."""
    return stacked.sum(0)


def _x_place(mesh, x) -> list:
    """``x`` [B, ...] batch-sharded where it divides, replicated over
    ``model``."""
    return place(mesh, x.ndim, d0=batch_axes(mesh, x.shape[0]))


def _stacked_place(mesh, x_shape, model: bool) -> list:
    """Placements of a region's partial output [1 per model rank, B,
    ...] (``model``) or of its full output [B, ...] replicated over it."""
    if model:
        return place(mesh, len(x_shape) + 1, d0="model",
                     d1=batch_axes(mesh, x_shape[0]))
    return place(mesh, len(x_shape), d0=batch_axes(mesh, x_shape[0]))


def _w(mesh, w, dim: Optional[int] = None, axis: Optional[str] = None):
    """A weight's compute layout: gathered over the data-parallel axes,
    its ``dim`` over ``axis`` (None: replicated everywhere)."""
    if dim is None or axis is None:
        return (w, place(mesh, w.ndim))
    return (w, place(mesh, w.ndim, **{f"d{dim}": axis}))


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
def _kv_heads(H_loc: int, G: int, coord: int) -> list:
    """The kv heads that query heads ``coord * H_loc ..`` of a rank read,
    G query heads per kv head: each once where every one serves as many
    consecutive local query heads (the grouped product then runs on them
    as on all heads), else one per query head."""
    heads = [(coord * H_loc + i) // G for i in range(H_loc)]
    uniq = sorted(set(heads))
    if H_loc % len(uniq) == 0 and all(
            heads.count(u) == H_loc // len(uniq) for u in uniq):
        return uniq
    return heads


def _take_heads(w, sel: list):
    """``w`` [d, Hkv, Dh] at kv heads ``sel`` (a slice where they run
    consecutively)."""
    if sel == list(range(sel[0], sel[-1] + 1)):
        return w[:, sel[0]:sel[-1] + 1]
    return w[:, sel]


def _seq_block(buf) -> tuple:
    """(first position, positions) of this rank's block of a cache
    DTensor [B, S, ...] (its sequence dim sharded or not)."""
    mesh = buf.device_mesh
    n, off = buf.shape[1], 0
    for i, p in enumerate(buf.placements):
        if p.is_shard() and p.dim == 1:
            n //= R.mesh_shape(mesh)[i]
            off += mesh.get_local_rank(i) * n
    return off, n


def _check_write(cache: dict, field: str, T: int) -> None:
    """Raise where ``layers._write_cache`` raises, and for a prompt
    written after earlier positions: a mesh path fills a cache with a
    prompt from position 0 only (a prefill) and then one token a step."""
    idx, S = cache["idx"], cache[field].shape[1]
    if idx + T > S:
        raise ValueError(f"the KV cache holds {S} positions; writing {T} "
                         f"at {idx} runs past it")
    if T > 1 and idx:
        raise ValueError(f"on a mesh a prompt is written at position 0; "
                         f"this cache already holds {idx}")


def _cache_write_full(buf, new):
    """Fill a sequence-sharded cache ``buf`` (DTensor [B, S, ...]) from
    position 0 with a prompt's ``new`` [B, T, ...] (``_check_write``
    first), in place on each rank's block."""
    T, S = new.shape[1], buf.shape[1]
    if T < S:           # padded per rank: DTensor's pad strategy fails on
        pl = list(new.placements)   # a sharded input in some releases
        assert not any(p.is_shard(1) for p in pl)
        new = region(lambda nl: F.pad(nl, (0, 0) * (nl.ndim - 2)
                                      + (0, S - T)), [(new, pl)], [pl])
    new = R._redistribute(new, buf.device_mesh, buf.placements)
    buf.to_local().copy_(new.to_local())


def attention(params: dict, x, cfg, *, positions, causal=True, cache=None):
    """``layers.attention_apply`` on a mesh, Megatron-style: each rank runs
    it on its query heads and the kv heads they read (all of them where
    the kv heads do not split); decode (one token on a cache) through
    ``_flash_decode``. Without a cache it returns no keys (``None``):
    nothing on a mesh reads them."""
    from repro_torch.models.layers import (_project, attention_apply,
                                           attention_kv)
    mesh = _mesh()
    H, Hkv = params["wq"].shape[1], params["wk"].shape[1]
    ax = tp(mesh, H)
    kv_ax = ax if ax and tp(mesh, Hkv) else None
    T = x.shape[1]
    bax = batch_axes(mesh, x.shape[0])
    w_in = [_w(mesh, params["wq"], 1, ax), _w(mesh, params["wk"], 1, kv_ax),
            _w(mesh, params["wv"], 1, kv_ax)]
    if cache is not None:
        _check_write(cache, "k", T)
    if cache is not None and T == 1:
        def qkv(xl, wq, wk, wv):
            k, v = attention_kv(dict(wk=wk, wv=wv), xl, cfg, positions)
            return _project(xl, wq, cfg, positions), k, v

        q, k, v = region(qkv, [(x, _x_place(mesh, x))] + w_in,
                         [place(mesh, 4, d0=bax, d2=ax)]
                         + [place(mesh, 4, d0=bax, d2=kv_ax)] * 2)
        out = _flash_decode(mesh, q, k, v, cache, cfg.attn_logit_soft_cap)
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "idx": cache["idx"] + T}
        return _out_proj(mesh, out, params["wo"], ax), new_cache

    sel = None
    if ax and not kv_ax:
        sel = _kv_heads(H // _size(mesh, ("model",)), H // Hkv,
                        model_coord(mesh))
    # with the kv heads split by query heads, each rank computes the keys
    # of its own block of cache positions for every kv head
    fill = _seq_block(cache["k"]) if cache is not None and sel else None

    def fn(xl, wq, wk, wv, wo, *bufs):
        p = dict(wq=wq, wk=wk, wv=wv, wo=wo)
        if sel:
            p.update(wk=_take_heads(wk, sel), wv=_take_heads(wv, sel))
        y, c = attention_apply(p, xl, cfg, positions=positions,
                               causal=causal)
        if fill and fill[0] < T:
            lo, hi = fill[0], min(fill[0] + fill[1], T)
            kb, vb = attention_kv(dict(wk=wk, wv=wv), xl[:, lo:hi], cfg,
                                  positions[lo:hi])
            bufs[0][:, :hi - lo] = kb
            bufs[1][:, :hi - lo] = vb
        return (y[None] if ax else y), c["k"], c["v"]

    kv_pl = place(mesh, 4, d0=bax, d2=kv_ax)
    bufs = [(cache[f], list(cache[f].placements)) for f in ("k", "v")] \
        if fill else []
    y, k, v = region(fn, [(x, _x_place(mesh, x))] + w_in
                     + [_w(mesh, params["wo"], 0, ax)] + bufs,
                     [_stacked_place(mesh, x.shape, bool(ax))]
                     + [None if sel else kv_pl] * 2)
    if ax:
        y = _partial_sum(y)
    if cache is None:
        return y, None
    if not fill:
        _cache_write_full(cache["k"], k)
        _cache_write_full(cache["v"], v)
    return y, {"k": cache["k"], "v": cache["v"], "idx": cache["idx"] + T}


def _out_proj(mesh, out, wo, ax):
    """``out`` [B, T, H, Dh] replicated over ``model`` through ``wo``
    [H, Dh, d]: each rank its heads' rows, a partial sum over ``model``
    (or the whole product where the heads do not split)."""
    def fn(o, w):
        if ax:
            n = w.shape[0]
            c = model_coord(mesh)
            return (o[:, :, c * n:(c + 1) * n].flatten(2)
                    @ w.flatten(0, 1))[None]
        return o.flatten(2) @ w.flatten(0, 1)

    y = region(fn, [(out, _x_place(mesh, out)), _w(mesh, wo, 0, ax)],
               [_stacked_place(mesh, out.shape[:2] + (wo.shape[-1],),
                               bool(ax))])
    return _partial_sum(y) if ax else y


def _flash_decode(mesh, q, k_new, v_new, cache, soft_cap=0.0, kv=None):
    """One-token attention over a cache sharded on its sequence over
    ``model``: q [B, 1, H, D] (gathered over ``model``), the new key and
    value [B, 1, Hkv, D] written at ``cache["idx"]`` into the block that
    holds it, scores over each rank's block, the max and the two sums
    reduced over ``model``. ``kv`` (MLA) maps the local cache blocks to
    (keys, values) [B, S_loc, H, .]; without it they are ``k`` / ``v``.
    Returns [B, 1, H, Dv] replicated over ``model``."""
    from repro_torch.models.layers import _MASKED, _scores
    B = q.shape[0]
    bax = batch_axes(mesh, B)
    idx = cache["idx"]
    names = ("ckv", "kr") if kv is not None else ("k", "v")
    bufs = [cache[n] for n in names]
    off, S_loc = _seq_block(bufs[0])
    q = R._redistribute(q, mesh, place(mesh, 4, d0=bax))
    st = {}

    def scores(ql, kn, vn, b0, b1):
        if off <= idx < off + S_loc:
            b0[:, idx - off] = kn[:, 0]
            b1[:, idx - off] = vn[:, 0]
        keys, vals = kv(b0, b1) if kv is not None else (b0, b1)
        Bq, _, H, D = ql.shape
        Hk = keys.shape[2]
        s = _scores(ql.reshape(Bq, 1, Hk, H // Hk, D), keys, soft_cap)
        spos = off + torch.arange(S_loc, device=s.device)
        s = torch.where(spos <= idx, s, _MASKED)
        st["s"], st["v"] = s, vals
        return s.amax(-1)[None]

    new_pl = [place(mesh, t.ndim, d0=bax) for t in (k_new, v_new)]
    buf_pl = [list(b.placements) for b in bufs]
    m_loc = region(scores, [(q, place(mesh, 4, d0=bax)),
                            (k_new, new_pl[0]), (v_new, new_pl[1]),
                            (bufs[0], buf_pl[0]), (bufs[1], buf_pl[1])],
                   [place(mesh, 5, d0="model", d1=bax)])
    m = R._redistribute(m_loc.amax(0), mesh, place(mesh, 4, d0=bax))

    def sums(ml):
        p = torch.exp(st["s"] - ml[..., None])
        vals = st["v"]
        acc = torch.einsum("bhgts,bshd->bthgd", p.to(vals.dtype), vals)
        return p.sum(-1)[None], acc[None]

    l_loc, acc_loc = region(sums, [(m, place(mesh, 4, d0=bax))],
                            [place(mesh, 5, d0="model", d1=bax),
                             place(mesh, 6, d0="model", d1=bax)])
    rep4, rep5 = place(mesh, 4, d0=bax), place(mesh, 5, d0=bax)
    l = R._redistribute(l_loc.sum(0), mesh, rep4)
    acc = R._redistribute(acc_loc.sum(0), mesh, rep5)

    def finish(al, ll):
        out = al / torch.clamp_min(ll, 1e-30).permute(0, 3, 1, 2)[..., None] \
            .to(al.dtype)
        return out.reshape(al.shape[0], 1, -1, al.shape[-1])

    return region(finish, [(acc, rep5), (l, rep4)],
                  [place(mesh, 4, d0=bax)])


def cross_attention(params: dict, x, memory, cfg):
    """``layers.cross_attention_apply`` on a mesh: Megatron heads over
    the query and the encoder's memory (replicated over ``model``)."""
    from repro_torch.models.layers import cross_attention_apply
    mesh = _mesh()
    H, Hkv = params["wq"].shape[1], params["wk"].shape[1]
    ax = tp(mesh, H) if tp(mesh, Hkv) else None

    def fn(xl, ml, wq, wk, wv, wo):
        y = cross_attention_apply(dict(wq=wq, wk=wk, wv=wv, wo=wo), xl, ml,
                                  cfg, positions=None)
        return y[None] if ax else y

    y = region(fn, [(x, _x_place(mesh, x)), (memory, _x_place(mesh, memory)),
                    _w(mesh, params["wq"], 1, ax),
                    _w(mesh, params["wk"], 1, ax),
                    _w(mesh, params["wv"], 1, ax),
                    _w(mesh, params["wo"], 0, ax)],
               [_stacked_place(mesh, x.shape, bool(ax))])
    return _partial_sum(y) if ax else y


def mla(params: dict, x, cfg, *, positions, causal=True, cache=None):
    """``layers.mla_apply`` on a mesh: Megatron heads for a full sequence
    (the latent and its rope key replicated over ``model``); a decode
    step expands the keys and values of its block of the latent cache for
    every head (``wuk`` / ``wuv`` gathered) under ``_flash_decode``."""
    from repro_torch.models.layers import mla_apply, norm_apply, rope
    mesh = _mesh()
    m = cfg.mla
    H = params["wuq"].shape[1]
    ax = tp(mesh, H)
    T = x.shape[1]
    bax = batch_axes(mesh, x.shape[0])
    lat = [_w(mesh, params["wdq"]), _w(mesh, params["q_norm"]["scale"]),
           _w(mesh, params["wdkv"]), _w(mesh, params["kv_norm"]["scale"])]

    def latent(xl, wdq, qs, wdkv, ks, wuq):
        cq = norm_apply({"scale": qs}, xl @ wdq, "rmsnorm")
        q = (cq @ wuq.flatten(1)).unflatten(-1, (wuq.shape[1], -1))
        qn, qr = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
        q = torch.cat([qn, rope(qr, positions, theta=cfg.rope_theta)], -1)
        dkv = xl @ wdkv
        ckv = norm_apply({"scale": ks}, dkv[..., :m.kv_lora_rank],
                         "rmsnorm")
        kr = rope(dkv[..., m.kv_lora_rank:][:, :, None, :], positions,
                  theta=cfg.rope_theta)[:, :, 0, :]
        return q, ckv, kr

    if cache is not None:
        _check_write(cache, "ckv", T)
    if cache is not None and T == 1:
        q, ckv, kr = region(latent, [(x, _x_place(mesh, x))] + lat
                            + [_w(mesh, params["wuq"], 1, ax)],
                            [place(mesh, 4, d0=bax, d2=ax),
                             place(mesh, 3, d0=bax), place(mesh, 3, d0=bax)])
        wuk = R._redistribute(params["wuk"], mesh, place(mesh, 3))
        wuv = R._redistribute(params["wuv"], mesh, place(mesh, 3))
        wuk_l, wuv_l = wuk.to_local(), wuv.to_local()

        def expand(ckv_blk, kr_blk):
            kn = (ckv_blk @ wuk_l.flatten(1)).unflatten(-1, (H, -1))
            v = (ckv_blk @ wuv_l.flatten(1)).unflatten(-1, (H, -1))
            k = torch.cat([kn, kr_blk[:, :, None, :].expand(-1, -1, H, -1)],
                          -1)
            return k, v

        out = _flash_decode(mesh, q, ckv, kr, cache, kv=expand)
        new_cache = {"ckv": cache["ckv"], "kr": cache["kr"],
                     "idx": cache["idx"] + T}
        return _out_proj(mesh, out, params["wo"], ax), new_cache

    cfg_loc = dataclasses.replace(cfg, n_heads=H // (_size(mesh, ("model",))
                                                     if ax else 1))

    def fn(xl, wdq, qs, wdkv, ks, wuq, wuk, wuv, wo):
        p = dict(wdq=wdq, q_norm={"scale": qs}, wuq=wuq, wdkv=wdkv,
                 kv_norm={"scale": ks}, wuk=wuk, wuv=wuv, wo=wo)
        y, c = mla_apply(p, xl, cfg_loc, positions=positions, causal=causal)
        return (y[None] if ax else y), c["ckv"], c["kr"]

    y, ckv, kr = region(fn, [(x, _x_place(mesh, x))] + lat
                        + [_w(mesh, params[n], 1, ax)
                           for n in ("wuq", "wuk", "wuv")]
                        + [_w(mesh, params["wo"], 0, ax)],
                        [_stacked_place(mesh, x.shape, bool(ax)),
                         place(mesh, 3, d0=bax), place(mesh, 3, d0=bax)])
    if ax:
        y = _partial_sum(y)
    if cache is None:
        return y, {"ckv": ckv, "kr": kr, "idx": T}
    _cache_write_full(cache["ckv"], ckv)
    _cache_write_full(cache["kr"], kr)
    return y, {"ckv": cache["ckv"], "kr": cache["kr"],
               "idx": cache["idx"] + T}


# --------------------------------------------------------------------------- #
# MLP and MoE
# --------------------------------------------------------------------------- #
def mlp(params: dict, x, act: str):
    """``layers.mlp_apply`` on a mesh: the FFN columns over ``model``,
    a partial sum out."""
    from repro_torch.models.layers import mlp_apply
    mesh = _mesh()
    names = ("w_gate", "w_up", "w_down") if act == "swiglu" \
        else ("w_in", "w_out")
    ax = tp(mesh, params[names[0]].shape[1])

    def fn(xl, *ws):
        y = mlp_apply(dict(zip(names, ws)), xl, act)
        return y[None] if ax else y

    ws = [_w(mesh, params[n], 0 if n in ("w_down", "w_out") else 1, ax)
          for n in names]
    y = region(fn, [(x, _x_place(mesh, x))] + ws,
               [_stacked_place(mesh, x.shape, bool(ax))])
    return _partial_sum(y) if ax else y


def dp_groups(total_tokens: int) -> int:
    """The hierarchical dispatch's group count: the active mesh's
    ``pod x data`` where it divides the tokens, else 1 (1 without a
    mesh)."""
    mesh = R.get_mesh()
    if mesh is None:
        return 1
    g = _size(mesh, _dp_dims(mesh)) if _dp_dims(mesh) else 1
    return g if g > 1 and total_tokens % g == 0 else 1


def moe(params: dict, x, cfg):
    """``moe.moe_apply`` on a mesh (see the module docstring); returns
    (out, {"load", "dropped"}) as it does."""
    from repro_torch.models import moe as M
    from repro_torch.models.layers import mlp_apply
    mesh = _mesh()
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    ax = tp(mesh, E)
    hier = m.dispatch == "hierarchical"
    G = dp_groups(T) if hier else 1
    dp = tuple(_dp_dims(mesh)) or None
    gax = dp if G > 1 else None
    xb = batch_axes(mesh, B)
    if hier and G > 1 and xb is None:
        G, gax = 1, None
    x_pl = place(mesh, 3, d0=gax) if hier else place(mesh, 3)

    def dispatch(xl, router, bias):
        xt = xl.reshape(-1, d)
        g = xt.shape[0] * G // T                  # this rank's groups
        xt = xt.reshape(g, -1, d)
        p = {"router": router, "router_bias": bias}
        _, eidx, gate = M._route(p, xt, m)
        cap = M._capacity(m.capacity_factor, xt.shape[1], k, E)
        parts = [M._dispatch(xt[i], eidx[i], E, cap) for i in range(g)]
        buf = torch.stack([pt[0] for pt in parts])           # [g, E, cap, d]
        order = torch.stack([pt[1] for pt in parts])
        slot = torch.stack([pt[2] for pt in parts])
        keep = torch.stack([pt[3] for pt in parts])
        flat = eidx.reshape(-1)            # bincount's shape is data-bound
        load = torch.zeros(E, dtype=torch.float32, device=flat.device) \
            .scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
        return buf, order, slot, keep, gate, eidx, load[None]

    g_pl = {n: place(mesh, n, d0=gax) for n in (2, 3, 4)}
    buf, order, slot, keep, gate, eidx, load = region(
        dispatch, [(x, x_pl), _w(mesh, params["router"]),
                   _w(mesh, params["router_bias"])],
        [g_pl[4], g_pl[2], g_pl[2], g_pl[2], g_pl[3], g_pl[3],
         place(mesh, 2, d0=gax)])
    cap = buf.shape[2]
    # expert parallelism: experts over 'model', token slots over DP axes
    slot_ax = None if hier else (dp if dp and cap % _size(mesh, dp) == 0
                                 else None)
    buf = R._redistribute(buf, mesh, place(mesh, 4, d0=gax, d1=ax,
                                           d2=slot_ax))

    def experts(bl, wg, wu, wd):
        g, e, c, _ = bl.shape
        h = bl.transpose(0, 1).reshape(e, g * c, d)
        y = M._experts(dict(w_gate=wg, w_up=wu, w_down=wd), h)
        return y.reshape(e, g, c, d).transpose(0, 1)

    y = region(experts, [(buf, list(buf.placements))]
               + [_w(mesh, params[n], 0, ax)
                  for n in ("w_gate", "w_up", "w_down")],
               [list(buf.placements)])

    def combine(yl, ol, sl, kl, gl, el):
        outs = [M._combine(yl[i], ol[i], sl[i], kl[i], gl[i], el[i],
                           x.dtype) for i in range(yl.shape[0])]
        return torch.cat(outs).reshape(-1, S, d)

    out = region(combine, [(y, g_pl[4]), (order, g_pl[2]),
                           (slot, g_pl[2]), (keep, g_pl[2]),
                           (gate, g_pl[3]), (eidx, g_pl[3])],
                 [place(mesh, 3, d0=gax)])
    out = R._redistribute(out, mesh, place(mesh, 3, d0=xb))
    if m.n_shared:
        out = out + mlp(params["shared"], x, cfg.act)
    load = load.sum(0) * float(_np_recip(T * k))
    if hier:
        return out, {"load": load, "dropped": 0.0}
    return out, {"load": load, "dropped": M._dropped(keep)}


def _np_recip(n: int):
    import numpy as np
    return np.float32(1.0) / np.float32(n)


# --------------------------------------------------------------------------- #
# recurrent mixers (replicated over model)
# --------------------------------------------------------------------------- #
def recurrent(apply, params: dict, x, cfg, cache=None):
    """A Mamba / mLSTM / sLSTM ``apply`` on a mesh: the batch over the
    data-parallel axes, everything else gathered over ``model``; a
    cache's tensor fields come in gathered and go back to their own
    placements."""
    mesh = _mesh()
    names = list(params)
    fields = [f for f in (cache or {}) if isinstance(cache[f], torch.Tensor)]

    def fn(xl, *rest):
        p = dict(zip(names, rest[:len(names)]))
        c = None
        if cache is not None:
            c = dict(cache, **dict(zip(fields, rest[len(names):])))
        y, nc = apply(p, xl, cfg, cache=c)
        if nc is None:
            return (y,)
        return (y,) + tuple(nc[f] for f in fields)

    ins = [(x, _x_place(mesh, x))] + [_w(mesh, params[n]) for n in names]
    ins += [(cache[f], place(mesh, cache[f].ndim,
                             d0=batch_axes(mesh, cache[f].shape[0])))
            for f in fields]
    outs = [_x_place(mesh, x)] + [ins[1 + len(names) + i][1]
                                  for i in range(len(fields))]
    res = region(fn, ins, outs)
    y = res[0]
    if cache is None:
        return y, None
    new = dict(cache, idx=cache["idx"] + x.shape[1])
    for f, t in zip(fields, res[1:]):
        new[f] = R._redistribute(t, mesh, list(cache[f].placements))
    return y, new


# --------------------------------------------------------------------------- #
# embedding, logits, loss, caches
# --------------------------------------------------------------------------- #
def embed(table, tokens):
    """``table[tokens]``, the vocab over ``model`` (masked lookups, a
    partial sum) or whole where it does not split."""
    mesh = _mesh()
    V = table.shape[0]
    ax = tp(mesh, V)

    def fn(tl, ids):
        if not ax:
            return tl[ids.long()]
        n = tl.shape[0]
        loc = ids.long() - model_coord(mesh) * n
        hit = (loc >= 0) & (loc < n)
        return (tl[loc.clamp(0, n - 1)] * hit[..., None])[None]

    out = region(fn, [_w(mesh, table, 0, ax),
                      (tokens, _x_place(mesh, tokens))],
                 [_stacked_place(mesh, tuple(tokens.shape) + (
                     table.shape[1],), bool(ax))])
    return _partial_sum(out) if ax else out


def linear(x, w):
    """``x @ w`` with ``x`` [B, ...] batch-sharded and ``w`` gathered: the
    frontend adapter and the MTP projection."""
    mesh = _mesh()
    return region(lambda xl, wl: xl @ wl, [(x, _x_place(mesh, x)),
                                          _w(mesh, w)],
                  [_x_place(mesh, x)])


def shift_left(t, n: int):
    """``t[:, n:]`` padded with ``n`` zeros at the end, per batch shard
    (the MTP's label shift; DTensor's ``pad`` strategy fails on a
    batch-sharded input in some releases)."""
    mesh = _mesh()
    pl = _x_place(mesh, t)
    return region(lambda tl: F.pad(tl[:, n:], (0, n)), [(t, pl)], [pl])


def greedy(lg):
    """``argmax`` over the last position's logits [B, S, V], ties to the
    first index: the logits gathered over ``model``, int32, batch-
    sharded."""
    mesh = _mesh()
    last = lg[:, -1]
    pl = _x_place(mesh, last)
    return region(lambda ll: torch.argmax(ll, dim=-1).to(torch.int32),
                  [(last, pl)],
                  [place(mesh, 1, d0=batch_axes(mesh, last.shape[0]))])


def logits(h, head):
    """``h @ head`` [B, S, V], the vocab over ``model`` where it
    splits."""
    mesh = _mesh()
    ax = tp(mesh, head.shape[1])

    def fn(hl, w):
        return hl @ w

    return region(fn, [(h, _x_place(mesh, h)), _w(mesh, head, 1, ax)],
                  [place(mesh, 3, d0=batch_axes(mesh, h.shape[0]), d2=ax)])


def cross_entropy(lg, labels, mask):
    """``training.steps.cross_entropy`` on a mesh: vocab-parallel
    (the max, the sum of exponentials and the gold logit reduced over
    ``model``) where the logits' vocab is sharded."""
    mesh = _mesh()
    B = lg.shape[0]
    bax = batch_axes(mesh, B)
    names = mesh.mesh_dim_names
    vax = "model" if "model" in names and \
        lg.placements[names.index("model")].is_shard() else None
    lg_pl = place(mesh, 3, d0=bax, d2=vax)
    lab_pl = place(mesh, 2, d0=bax)
    st = place(mesh, 3, d0=vax, d1=bax) if vax else place(mesh, 2, d0=bax)

    def top(ll):
        mx = ll.detach().float().amax(-1)
        return mx[None] if vax else mx

    mx = region(top, [(lg, lg_pl)], [st])
    mx = R._redistribute(mx.amax(0), mesh, lab_pl) if vax else mx

    def parts(ll, ml, lab):
        lf = ll.float()
        se = torch.exp(lf - ml[..., None]).sum(-1)
        n = lf.shape[-1]
        loc = lab.long() - (model_coord(mesh) * n if vax else 0)
        hit = (loc >= 0) & (loc < n)
        gold = torch.take_along_dim(lf, loc.clamp(0, n - 1)[..., None],
                                    dim=-1)[..., 0] * hit
        return (se[None], gold[None]) if vax else (se, gold)

    se, gold = region(parts, [(lg, lg_pl), (mx, lab_pl), (labels, lab_pl)],
                      [st, st])
    if vax:
        se, gold = se.sum(0), gold.sum(0)
    logz = mx + torch.log(se)
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def init_cache(cfg, batch: int, max_len: int, device) -> list:
    """``model.init_cache`` on a mesh: each layer's tensor fields zeroed
    in their rules' placements (``model.cache_specs``), as DTensors."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import model as M
    mesh = _mesh()
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():      # shapes only: nothing to count
        shapes = M.cache_layers(cfg, batch, max_len, torch.device("meta"))
    shard = R.cache_shardings(mesh, M.cache_specs(cfg), shapes)
    out = []
    for c, sh in zip(shapes, shard):
        layer = {}
        for f, t in c.items():
            if not isinstance(t, torch.Tensor):
                layer[f] = t
                continue
            pl = sh[f].placements
            local = list(t.shape)
            for i, p in enumerate(pl):
                if p.is_shard():
                    local[p.dim] //= R.mesh_shape(mesh)[i]
            z = torch.zeros(local, dtype=t.dtype, device=device)
            layer[f] = DTensor.from_local(z, mesh, pl, run_check=False)
        out.append(layer)
    return out


# --------------------------------------------------------------------------- #
# placing tensors
# --------------------------------------------------------------------------- #
def local_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of a full tensor ``t`` under ``placements``: per
    mesh dim in order, its coordinate's even chunk of the dim it shards."""
    for i, p in enumerate(placements):
        if p.is_shard():
            n = R.mesh_shape(mesh)[i]
            t = t.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return t


def local_shape(shape, mesh, placements) -> tuple:
    shape = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] //= R.mesh_shape(mesh)[i]
    return tuple(shape)


def shard_tensor(t: torch.Tensor, mesh, placements, *, fresh=False):
    """A DTensor of ``t`` placed by ``placements``: each rank keeps its own
    block (a copy), with no collective; ``fresh`` makes an empty local
    block of the same dtype and device instead (fake tensors)."""
    from torch.distributed.tensor import DTensor
    if fresh:
        loc = torch.empty(local_shape(t.shape, mesh, placements),
                          dtype=t.dtype, device=t.device)
    else:
        loc = local_block(t.detach(), mesh, placements).contiguous().clone()
    return DTensor.from_local(loc, mesh, placements, run_check=False)


def shard_params(model, mesh, *, fresh=False) -> dict:
    """Replace every parameter of ``model`` by a DTensor placed by the
    rules (``model.model_specs``, non-dividing axes dropped); returns
    ``{name: Sharding}``."""
    from torch import nn
    from repro_torch.models.model import model_specs
    named = dict(model.named_parameters())
    sh = R.param_shardings(mesh, model_specs(model.cfg), named)
    for name, p in named.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = shard_tensor(p, mesh, sh[name].placements, fresh=fresh)
        setattr(mod, attr, nn.Parameter(d, requires_grad=p.requires_grad))
    return sh
