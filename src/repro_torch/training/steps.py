"""Step builders of the port's LM stack: the port of the JAX package's
``training/steps.py``.

``train_step``: the cross-entropy loss (plus DeepSeek's MTP term), its
backward, the global-norm clip and AdamW, the parameters and moments
updated in place. Remat lives inside the model (``models/model.py``:
every block is recomputed in the backward). ``prefill_step`` builds the
decode cache from a prompt, ``serve_step`` decodes one token against it;
each returns the greedy next token (``argmax`` over the last logits, ties
to the first index, as ``jnp.argmax``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules as R
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update,
                                            clip_by_global_norm, lr_schedule)


class TrainState(NamedTuple):
    params: M.Model
    opt: AdamWState


def make_train_state(cfg: ModelConfig, *, seed: int = 0,
                     device: DeviceLike = None) -> TrainState:
    """A model drawn from ``seed`` (``init_model``) on ``device`` (the CUDA
    card unless ``device="cpu"``) and zero float32 moments."""
    model = M.init_model(cfg, seed=seed, device=device)
    return TrainState(params=model, opt=adamw_init(model))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the positions where ``mask`` is
    1: ``logsumexp`` in float32 less the gold logit. The gold logit is a
    gather (the reference's iota-compare reduction adds only exact zeros
    to it, so the value is the same) and no one-hot [B, S, V] is built.
    On a mesh: the vocab-parallel form (``models.sharded``)."""
    if R.get_mesh() is not None:
        from repro_torch.models import sharded
        return sharded.cross_entropy(logits, labels, mask)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None],
                                dim=-1)[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def _shift(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t[:, n:]`` padded with ``n`` zeros (on a mesh, per batch
    shard)."""
    if R.get_mesh() is not None:
        from repro_torch.models import sharded
        return sharded.shift_left(t, n)
    return F.pad(t[:, n:], (0, n))


def loss_fn(model: M.Model, batch: dict, cfg: ModelConfig):
    """(loss, metrics) of ``forward`` on ``batch``: positions whose label
    is negative carry no loss (the labels are clamped at 0); a decoder-only
    config with a frontend drops its ``frontend_len`` prefix positions
    first. With MTP the loss adds ``0.3 x`` the cross-entropy of
    ``mtp_logits`` (the hidden state joined with the next label's
    embedding) against the labels shifted by two. ``metrics``: ``loss``,
    ``moe_dropped``, and with MTP ``mtp_loss``, detached."""
    logits, aux = M.forward(model, batch, cfg)
    labels = batch["labels"]
    prefix = cfg.frontend and not cfg.n_enc_layers
    if prefix:
        logits = logits[:, cfg.frontend_len:]
    mask = (labels >= 0).to(torch.float32)
    labels = torch.clamp_min(labels, 0)
    loss = cross_entropy(logits, labels, mask)
    metrics = {"loss": loss.detach(),
               "moe_dropped": aux["moe_dropped"].detach()}
    if cfg.mtp_depth:
        # depth-2 multi-token prediction: the labels shifted one more
        h = aux["mtp_hidden"]
        if prefix:
            h = h[:, cfg.frontend_len:]
        nxt = _shift(labels, 1)
        mtp_lg = M.mtp_logits(model, h, M.embed_lookup(model, nxt), cfg)
        lbl2 = _shift(labels, 2)
        msk2 = _shift(mask, 2)
        mtp_loss = cross_entropy(mtp_lg, lbl2, msk2)
        metrics["mtp_loss"] = mtp_loss.detach()
        loss = loss + 0.3 * mtp_loss
    return loss, metrics


def make_train_step(cfg: ModelConfig, *, peak_lr=3e-4, warmup=200,
                    total=10_000, clip=1.0, weight_decay=0.1):
    """``train_step(state, batch) -> (state, metrics)``: forward and
    backward, the clip, ``lr_schedule`` at the step before the increment,
    then ``adamw_update``; ``metrics`` adds ``grad_norm`` (before the clip)
    and ``lr``. The state's parameters and moments are updated in place
    and its gradients freed."""
    def train_step(state: TrainState, batch: dict):
        model = state.params
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, metrics = loss_fn(model, batch, cfg)
            loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        grads, gnorm = clip_by_global_norm(grads, clip)
        lr = lr_schedule(state.opt.step, peak_lr=peak_lr, warmup=warmup,
                         total=total)
        model, opt = adamw_update(model, grads, state.opt, lr=lr,
                                  weight_decay=weight_decay)
        del grads
        model.zero_grad(set_to_none=True)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(params=model, opt=opt), metrics

    return train_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    if R.get_mesh() is not None:
        from repro_torch.models import sharded
        return sharded.greedy(logits)
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_serve_step(cfg: ModelConfig):
    def serve_step(model: M.Model, caches: list, batch: dict):
        logits, caches = M.decode_step(model, caches, batch, cfg)
        return _greedy(logits), caches

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(model: M.Model, batch: dict):
        logits, caches = M.prefill(model, batch, cfg, max_len)
        return _greedy(logits), caches

    return prefill_step
