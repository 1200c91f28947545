"""Model assembly: config -> init / forward / prefill / decode. The port of
the JAX package's ``models/model.py`` for attention, MLA and Mamba blocks
with dense or MoE MLPs (so the Jamba hybrid pattern), and DeepSeek's
multi-token prediction (MTP) module.

``Model`` is an ``nn.Module``: the token embedding ``embed`` [V, d], the
final norm, an ``lm_head`` [d, V] unless the embeddings are tied, the
blocks as an ``nn.ModuleList`` in the reference's layer order (its scan
groups, repeat by repeat, position by position) and, with ``mtp_depth``,
``mtp_proj`` [2d, d], ``mtp_block`` (an attention + dense block) and
``mtp_norm``. The module-level functions keep the reference's names and
arguments, with the model in place of the parameter pytree.

A decode cache is a list with one dict per layer, by the layer's mixer:
``{"k", "v": [B, max_len, Hkv, Dh], "idx": int}`` for attention,
``{"ckv": [B, max_len, kv_lora], "kr": [B, max_len, rope], "idx": int}``
for MLA, in the activation dtype; ``prefill`` and ``decode_step`` write it
in place and return it with ``idx`` advanced. A Mamba layer's is
``{"conv": [B, d_conv - 1, di], "h": [B, di, n], "idx": int}``
(``models/ssm.py``), replaced by each call; its ``idx`` advances as an
attention layer's does, so ``decode_step`` reads the position from layer 0
whatever its mixer. There is one card, so the reference's sharding hints
have no counterpart, and ``fsdp_gather_weights`` / ``tp_bf16_payload``
change no number. The xLSTM mixers, the encoder, the frontend stubs and
cross-attention are later slices: a config that needs one is refused by
``Model``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import (MLA, MLP, Attention, Norm, _param,
                                       mla_cache_shape, not_ported)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba, mamba_cache_shape

_MIXERS = {"attn": Attention, "mla": MLA, "mamba": Mamba}
_MIXER_ITEMS = {"mlstm": "5e (mLSTM / sLSTM)", "slstm": "5e (mLSTM / sLSTM)"}
_ENC_DEC_ITEM = "5f (encoder-decoder and frontend stubs)"
_MTP_SPEC = BlockSpec(mixer="attn", mlp="dense")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer not in _MIXERS:
        raise not_ported(f"mixer {spec.mixer!r}",
                         _MIXER_ITEMS.get(spec.mixer, spec.mixer))
    if spec.cross:
        raise not_ported("cross-attention", _ENC_DEC_ITEM)
    if spec.mlp not in ("dense", "moe"):
        raise not_ported(f"mlp {spec.mlp!r}", _MIXER_ITEMS["mlstm"])


def _check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of the first
    part of ``cfg`` that the port does not run yet."""
    if cfg.n_enc_layers:
        raise not_ported("the encoder", _ENC_DEC_ITEM)
    if cfg.frontend:
        raise not_ported(f"the {cfg.frontend} frontend", _ENC_DEC_ITEM)
    for spec in cfg.layer_pattern():
        _check_spec(spec)


# --------------------------------------------------------------------------- #
# one block
# --------------------------------------------------------------------------- #
class Block(nn.Module):
    """One pre-norm layer: ``x + mixer(norm1(x))``, then ``x +
    mlp(norm2(x))`` (the reference's ``init_block`` / ``block_apply``); the
    mixer is attention, MLA or Mamba, the MLP dense or MoE, by ``spec``.
    Its float parameters are used in the activation dtype (a Mamba's
    float32 ``A_log`` and ``D`` too)."""

    def __init__(self, spec: BlockSpec, cfg: ModelConfig, *,
                 dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_spec(spec)
        self.cfg = cfg
        self.norm1 = Norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.mixer = _MIXERS[spec.mixer](cfg, dtype=dtype, device=device,
                                         generator=generator)
        self.norm2 = Norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.mlp = (MoE(cfg, dtype=dtype, device=device, generator=generator)
                    if spec.mlp == "moe" else
                    MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dtype,
                        device=device, generator=generator))

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                causal: bool = True, cache: Optional[dict] = None):
        """Returns (x, new_cache, aux): aux is the MoE's stats ({"load",
        "dropped"}), or None for a dense MLP."""
        dtype = _dtype(self.cfg.activation_dtype)
        h = self.norm1(x, dtype)
        out, new_cache = self.mixer(h, positions=positions, causal=causal,
                                    cache=cache, dtype=dtype)
        x = x + out.to(x.dtype)
        h = self.norm2(x, dtype)
        aux = None
        if isinstance(self.mlp, MoE):
            out, aux = self.mlp(h, dtype)
        else:
            out = self.mlp(h, dtype)
        x = x + out.to(x.dtype)
        return x, new_cache, aux


# --------------------------------------------------------------------------- #
# full model
# --------------------------------------------------------------------------- #
class Model(nn.Module):
    """The parameters of an LM. With a ``generator`` the weights are drawn
    from it (on its device); without one they are left uninitialized, for
    ``interop.model_params_from_numpy`` to load."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        dtype = _dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed = _param(generator, (cfg.vocab, cfg.d_model), cfg.d_model,
                            dtype, dev)
        self.final_norm = Norm(cfg.d_model, cfg.norm, dtype=dtype,
                               device=dev)
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = _param(generator, (cfg.d_model, cfg.vocab),
                                  cfg.d_model, dtype, dev)
        self.blocks = nn.ModuleList(
            Block(spec, cfg, dtype=dtype, device=dev, generator=generator)
            for spec in cfg.layer_pattern())
        if cfg.mtp_depth:
            self.mtp_proj = _param(generator, (2 * cfg.d_model, cfg.d_model),
                                   2 * cfg.d_model, dtype, dev)
            self.mtp_block = Block(_MTP_SPEC, cfg, dtype=dtype, device=dev,
                                   generator=generator)
            self.mtp_norm = Norm(cfg.d_model, cfg.norm, dtype=dtype,
                                 device=dev)

    def forward(self, batch: dict):
        return forward(self, batch, self.cfg)


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: DeviceLike = None) -> Model:
    """A model with its weights drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the CUDA card unless ``device="cpu"``).
    The draws are the port's own: ``jax.random`` streams are not
    reproduced, so parity with the reference runs on carried weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, device=dev, generator=gen)


def _embed_inputs(model: Model, batch: dict, cfg: ModelConfig):
    return model.embed[batch["tokens"].long()].to(
        _dtype(cfg.activation_dtype))


def _lm_logits(model: Model, h: torch.Tensor, cfg: ModelConfig):
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return h @ head.to(h.dtype)


def _apply_blocks(model: Model, x, *, positions, caches=None):
    """(x, new_caches, dropped): ``dropped`` sums the MoE layers' dropped
    shares in float32, layer by layer (the reference's ``_apply_stack``
    aux sum); dense layers add nothing."""
    new_caches = []
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(model.blocks):
        x, nc, aux = blk(x, positions=positions, causal=True,
                         cache=None if caches is None else caches[i])
        new_caches.append(nc)
        if aux is not None:
            dropped = dropped + aux["dropped"]
    return x, new_caches, dropped


def forward(model: Model, batch: dict, cfg: ModelConfig):
    """Full-sequence forward -> (logits [B,S,V], aux): aux["moe_dropped"],
    and with MTP aux["mtp_hidden"], the final-normed hidden state that
    ``mtp_logits`` takes."""
    x = _embed_inputs(model, batch, cfg)
    pos = torch.arange(x.shape[1], device=x.device)
    x, _, dropped = _apply_blocks(model, x, positions=pos)
    h = model.final_norm(x)
    aux = {"moe_dropped": dropped}
    if cfg.mtp_depth:
        aux["mtp_hidden"] = h
    return _lm_logits(model, h, cfg), aux


def mtp_logits(model: Model, h: torch.Tensor, next_embed: torch.Tensor,
               cfg: ModelConfig):
    """DeepSeek's MTP module: the hidden state joined with the next
    token's embedding, projected, one attention + dense block, its norm and
    the shared head -> the depth-2 prediction logits [B, S, V]."""
    dtype = h.dtype
    z = torch.cat([h, next_embed.to(dtype)], -1) @ model.mtp_proj.to(dtype)
    pos = torch.arange(z.shape[1], device=z.device)
    z, _, _ = model.mtp_block(z, positions=pos)
    z = model.mtp_norm(z)
    return _lm_logits(model, z, cfg)


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> list:
    """A zeroed decode cache of capacity ``max_len``, one dict per layer
    by its mixer (the reference's ``block_cache_shape``; the reference
    returns the shapes, the port allocates them). A Mamba layer's state
    has a fixed size whatever ``max_len``."""
    dev = resolve_device(device)
    dtype = _dtype(cfg.activation_dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)

    def one(spec):
        if spec.mixer == "mla":
            return mla_cache_shape(cfg, batch, max_len, dtype, device=dev)
        if spec.mixer == "mamba":
            return mamba_cache_shape(cfg, batch, dtype, device=dev)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev), "idx": 0}

    return [one(spec) for spec in cfg.layer_pattern()]


@torch.no_grad()
def decode_step(model: Model, caches: list, batch: dict, cfg: ModelConfig):
    """One-token decode: batch['tokens'] [B,1]. Returns (logits [B,1,V],
    new_caches); ``caches`` is consumed."""
    x = _embed_inputs(model, batch, cfg)
    # positions from the first layer's idx (uniform across the batch)
    idx = caches[0]["idx"]
    pos = torch.arange(idx, idx + 1, device=x.device)
    x, new_caches, _ = _apply_blocks(model, x, positions=pos, caches=caches)
    h = model.final_norm(x)
    return _lm_logits(model, h, cfg), new_caches


@torch.no_grad()
def prefill(model: Model, batch: dict, cfg: ModelConfig, max_len: int):
    """Run the full prompt through zeroed caches of capacity ``max_len``
    (attention over the whole cache, ``kv_len_valid`` = prompt length).
    Returns (last-position logits [B,1,V], caches)."""
    B = batch["tokens"].shape[0]
    caches = init_cache(cfg, B, max_len, device=model.embed.device)
    x = _embed_inputs(model, batch, cfg)
    pos = torch.arange(x.shape[1], device=x.device)
    x, new_caches, _ = _apply_blocks(model, x, positions=pos, caches=caches)
    h = model.final_norm(x[:, -1:])
    return _lm_logits(model, h, cfg), new_caches
