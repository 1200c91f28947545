"""Serving step builders: ``prefill_step`` builds the decode cache from a
prompt, ``serve_step`` decodes one token against it; each returns the
greedy next token (``argmax`` over the last logits, ties to the first
index, as ``jnp.argmax``). The port of the JAX package's
``training/steps.py:87-102``; its train step is a later slice."""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _greedy(logits: torch.Tensor) -> torch.Tensor:
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
