"""AdamW, the global-norm clip and the warmup-cosine schedule: the port of
the JAX package's ``training/optimizer.py``. Moments are float32 whatever
the parameter dtype; the update is computed in float32 and cast to the
parameter's dtype.

A parameter tree here is an ``nn.Module`` (its ``named_parameters``) or a
mapping of names to tensors; gradients are a mapping of the same names to
tensors, where ``None`` stands for a zero gradient. A parameter with no
gradient (the MoE ``router_bias``, used only for the choice: ``jax.grad``
gives it zeros) still takes the moment updates and the weight decay.
Parameters and moments are updated in place under ``torch.no_grad()``,
the counterpart of the reference's ``donate_argnums=(0,)``: a functional
copy would double the parameters.

Scalars follow the reference's float32 arithmetic: the schedule, ``b1 **
t`` and ``b2 ** t`` are float32 tensors, and every Python float constant
meets a float32 tensor, so it is rounded to float32 as a JAX weak type is.

Also: int8 gradient compression with stochastic rounding and error
feedback over ``torch.distributed`` (``compressed_psum``). The rounding
noise comes from an explicit ``torch.Generator``; ``_quantize`` does the
arithmetic on a given noise draw, so a test can feed it the reference's.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Union

import torch
from torch import nn

ParamTree = Union[nn.Module, Mapping[str, torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar, on the parameters' device
    m: dict                     # name -> float32 first moment
    v: dict                     # name -> float32 second moment


def named_params(params: ParamTree) -> dict:
    """``{name: tensor}`` of a module's parameters or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: ParamTree) -> AdamWState:
    named = named_params(params)
    dev = next(iter(named.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: torch.zeros_like(p, dtype=torch.float32)
           for n, p in named.items()},
        v={n: torch.zeros_like(p, dtype=torch.float32)
           for n, p in named.items()})


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def clip_by_global_norm(grads: Mapping, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))``, in
    place, where ``norm`` is the float32 square root of the sum of every
    leaf's float32 sum of squares, added leaf by leaf in the mapping's
    order (``None`` leaves add nothing). Returns (grads, norm). The
    reference adds its stacked leaves in its tree's order, so the norms
    agree to float32 reassociation (~1e-7 relative), not bit for bit."""
    leaves = [g for g in grads.values() if g is not None]
    g2 = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        g2 = g2 + torch.sum(torch.square(g.float()))
    norm = torch.sqrt(g2)
    scale = torch.minimum(_f32(1.0, norm),
                          max_norm / torch.maximum(norm, _f32(1e-9, norm)))
    for g in leaves:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


def lr_schedule(step: torch.Tensor, *, peak_lr=3e-4, warmup=200,
                total=10_000, min_ratio=0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``min_ratio * peak_lr`` at ``total``; a float32 scalar on the
    step's device, computed in the reference's float32 order. The cosine
    is taken in float64 and rounded once to float32 (the correctly rounded
    value); the reference's float32 cosine is within an ulp of it, so the
    two schedules agree to 1 float32 ulp."""
    step = step.to(torch.float32)
    warm = step / _f32(max(warmup, 1), step)
    prog = torch.clamp((step - _f32(warmup, step))
                       / _f32(max(total - warmup, 1), step), 0, 1)
    cos = _f32(min_ratio, step) + _f32((1 - min_ratio) * 0.5, step) * (
        _f32(1.0, step)
        + torch.cos((_f32(math.pi, step) * prog).double()).float())
    return _f32(peak_lr, step) * torch.where(step < _f32(warmup, step),
                                             warm, cos)


@torch.no_grad()
def adamw_update(params: ParamTree, grads: Mapping, state: AdamWState, *,
                 lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step on every parameter, in place: the moments, then
    ``p - lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p)`` in float32,
    cast to ``p.dtype``. A name missing from ``grads`` or mapped to
    ``None`` takes a zero gradient. ``lr`` is a float32 scalar tensor (the
    schedule's) or a float. Returns (params, new state)."""
    named = named_params(params)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, t), t)
    bc2 = 1 - torch.pow(_f32(b2, t), t)
    lr = lr.to(torch.float32) if isinstance(lr, torch.Tensor) else \
        _f32(lr, t)
    for name, p in named.items():
        g = grads.get(name)
        m, v = state.m[name], state.v[name]
        gf = torch.zeros_like(p, dtype=torch.float32) if g is None \
            else g.float()
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf * (1 - b2) * gf)
        del gf
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        delta.add_(pf * weight_decay)
        p.copy_(pf - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v)


# --------------------------------------------------------------------------- #
# gradient compression (int8 stochastic rounding + error feedback)
# --------------------------------------------------------------------------- #
def _quantize(g: torch.Tensor, err: torch.Tensor, noise: torch.Tensor,
              scale: torch.Tensor):
    """``quantize_grad``'s arithmetic on a given noise draw in [-0.5,
    0.5): (int8 q, float32 new error)."""
    gf = g.float() + err
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127)
    return q.to(torch.int8), gf - q * scale


def quantize_grad(g: torch.Tensor, err: torch.Tensor,
                  generator: torch.Generator, scale: torch.Tensor):
    """g -> int8-valued q on a shared ``scale``, the error fed back: the
    reference's ``quantize_grad`` with the noise drawn from
    ``generator`` (uniform in [-0.5, 0.5), on ``g``'s device)."""
    noise = torch.rand(g.shape, generator=generator, device=g.device,
                       dtype=torch.float32) - 0.5
    return _quantize(g, err, noise, scale)


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads: Mapping, err_state: Optional[Mapping],
                    generator: torch.Generator, group=None):
    """Quantized gradient all-reduce with error feedback over the
    ``torch.distributed`` ``group`` (the default one if ``None``): the mean
    of every rank's gradients, sent as int8 values on a scale shared by an
    ``all_reduce(MAX)`` of each rank's ``|g + err|`` maximum (divided by
    127, plus 1e-12), summed as int32 and divided by the group's size.
    ``grads`` maps names to tensors; ``err_state`` maps them to float32
    errors, or is ``None`` for zeros. Returns (the mean, the new errors),
    each a mapping of the same names."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out, new_errs = {}, {}
    for name, g in grads.items():
        e = torch.zeros(g.shape, dtype=torch.float32, device=g.device) \
            if err_state is None else err_state[name]
        local_max = torch.max(torch.abs(g.float() + e))
        dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
        scale = local_max / 127.0 + 1e-12
        q, new_errs[name] = quantize_grad(g, e, generator, scale)
        qs = q.to(torch.int32)
        dist.all_reduce(qs, op=dist.ReduceOp.SUM, group=group)
        out[name] = (qs.float() * scale / _f32(n, qs)).to(g.dtype)
    return out, new_errs
