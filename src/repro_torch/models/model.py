"""Model assembly: config -> init / forward / prefill / decode. The port of
the JAX package's ``models/model.py``: attention, MLA, Mamba, mLSTM and
sLSTM blocks with dense, MoE or no MLPs (so the Jamba and xLSTM
patterns), cross-attention in an encoder-decoder's decoder blocks, the
encoder, the modality frontend stubs and DeepSeek's multi-token
prediction (MTP) module.

``Model`` is an ``nn.Module``: the token embedding ``embed`` [V, d], the
final norm, an ``lm_head`` [d, V] unless the embeddings are tied, the
blocks as an ``nn.ModuleList`` in the reference's layer order (its scan
groups, repeat by repeat, position by position); with ``n_enc_layers``
the ``encoder`` (that many attention + dense blocks, applied
non-causally) and its norm ``enc_norm``; with a ``frontend`` the
``frontend_adapter`` [frontend_dim or d, d] that maps the precomputed
patch or frame features into the model; with ``mtp_depth``, ``mtp_proj``
[2d, d], ``mtp_block`` (an attention + dense block) and ``mtp_norm``. The
module-level functions keep the reference's names and arguments, with
the model in place of the parameter pytree.

The frontend is a stub, as in the reference: a batch carries
``batch["frontend"]`` [B, frontend_len, frontend_dim]. An encoder-decoder
(``n_enc_layers``) encodes it into ``memory`` [B, frontend_len, d]
(``_encode``), which every decoder block attends to without a mask and
without rope; ``forward`` and ``prefill`` encode it themselves, and
``decode_step`` takes it as ``batch["memory"]`` (computed once per
request, as the reference's serve loop does). A decoder-only config with
a frontend (a VLM) prepends the adapted features to the token
embeddings, so its positions, its logits and the cache capacity a
prefill needs count ``frontend_len`` more.

A decode cache is a list with one dict per layer, by the layer's mixer:
``{"k", "v": [B, max_len, Hkv, Dh], "idx": int}`` for attention,
``{"ckv": [B, max_len, kv_lora], "kr": [B, max_len, rope], "idx": int}``
for MLA, in the activation dtype; ``prefill`` and ``decode_step`` write it
in place and return it with ``idx`` advanced. A Mamba, mLSTM or sLSTM
layer's is a fixed-size state (``models/ssm.py``), replaced by each call;
its ``idx`` advances as an attention layer's does, so ``decode_step``
reads the position from layer 0 whatever its mixer.

Sharding: ``model_specs`` and ``cache_specs`` give every parameter and
cache field its logical axes, keyed by the port's names (the reference's
trees unstacked: its leading ``"layers"`` axis has no counterpart).
Under an ambient mesh (``sharding.rules.set_mesh``) with DTensor
parameters placed by ``rules.param_shardings``, each layer runs its mesh
path (``models/sharded.py``), the activations are constrained at the
reference's sites (``maybe_constrain``), ``fsdp_gather_weights`` gathers
each block's weights at its entry (``constrain_gathered``) and
``tp_bf16_payload`` reduces a block output's partial sums while it is
still in the activation dtype. Without a mesh none of this runs, and
every number is the single card's.

Remat: while autograd records (``torch.is_grad_enabled()``), ``forward``
and ``_encode`` run each block under ``torch.utils.checkpoint``
(``use_reentrant=False``), so the backward keeps only the blocks' inputs
and recomputes each block's activations, as the reference's scanned
layer bodies are ``jax.checkpoint``-ed; the MTP block runs plainly, as in
the reference. With grad off (``prefill``, ``decode_step``, ``forward``
under ``torch.no_grad()``) nothing changes. A forward hook on a block or
on a module inside one fires again in the recompute.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import (MLA, MLP, Attention, Norm, _cast_params,
                                       _param, attention_specs,
                                       cross_attention_apply, mla_cache_shape,
                                       mla_specs, mlp_specs, norm_specs)
from repro_torch.models.moe import MoE, moe_specs
from repro_torch.models.ssm import (MLSTM, SLSTM, Mamba, mamba_cache_shape,
                                    mamba_specs, mlstm_cache_shape,
                                    mlstm_specs, slstm_cache_shape,
                                    slstm_specs)
from repro_torch.sharding import rules as R

_MIXERS = {"attn": Attention, "mla": MLA, "mamba": Mamba, "mlstm": MLSTM,
           "slstm": SLSTM}
_STATE_CACHES = {"mamba": mamba_cache_shape, "mlstm": mlstm_cache_shape,
                 "slstm": slstm_cache_shape}
_MIXER_SPECS = {"attn": attention_specs, "mla": mla_specs,
                "mamba": mamba_specs, "mlstm": mlstm_specs,
                "slstm": slstm_specs}
# the encoder's blocks and the MTP module's
_ATTN_DENSE = BlockSpec(mixer="attn", mlp="dense")
# activations: batch over the DP axes, d_model replicated
_ACT = (R.DP_AXES, None, None)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --------------------------------------------------------------------------- #
# logical axes, keyed by the port's parameter names
# --------------------------------------------------------------------------- #
def block_specs(spec: BlockSpec, cfg: ModelConfig) -> dict:
    s = {"norm1": norm_specs(cfg.norm),
         "mixer": _MIXER_SPECS[spec.mixer](cfg)}
    if spec.cross:
        s["norm_cross"] = norm_specs(cfg.norm)
        s["cross"] = attention_specs(cfg)
    if spec.mlp != "none":
        s["norm2"] = norm_specs(cfg.norm)
        s["mlp"] = moe_specs(cfg) if spec.mlp == "moe" \
            else mlp_specs(cfg.act)
    return s


def _flat(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


def model_specs(cfg: ModelConfig) -> dict:
    """``{parameter name: logical axes}`` for every parameter of
    ``Model(cfg)``: the reference's ``model_specs`` with its stacked
    blocks split into the port's layers (no ``"layers"`` axis)."""
    specs = {"embed": ("vocab", "embed")}
    specs.update(_flat({"final_norm": norm_specs(cfg.norm)}, ""))
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    for i, spec in enumerate(cfg.layer_pattern()):
        specs.update(_flat(block_specs(spec, cfg), f"blocks.{i}."))
    if cfg.n_enc_layers:
        for i in range(cfg.n_enc_layers):
            specs.update(_flat(block_specs(_ATTN_DENSE, cfg),
                               f"encoder.{i}."))
        specs.update(_flat({"enc_norm": norm_specs(cfg.norm)}, ""))
    if cfg.frontend:
        specs["frontend_adapter"] = ("frontend", "embed")
    if cfg.mtp_depth:
        specs["mtp_proj"] = ("embed", "embed")
        specs.update(_flat(block_specs(_ATTN_DENSE, cfg), "mtp_block."))
        specs.update(_flat({"mtp_norm": norm_specs(cfg.norm)}, ""))
    return specs


def _one_cache_spec(s: BlockSpec) -> dict:
    if s.mixer == "attn":
        return {"k": ("batch", "kv_seq", "kv_heads", None),
                "v": ("batch", "kv_seq", "kv_heads", None)}
    if s.mixer == "mla":
        return {"ckv": ("batch", "kv_seq", None),
                "kr": ("batch", "kv_seq", None)}
    if s.mixer == "mamba":
        return {"conv": ("batch", None, "inner"),
                "h": ("batch", "inner", None)}
    if s.mixer == "mlstm":
        return {"C": ("batch", "heads", None, None),
                "n": ("batch", "heads", None),
                "m": ("batch", "heads")}
    return {"h": ("batch", "embed"), "c": ("batch", "embed"),
            "n": ("batch", "embed"), "m": ("batch", "embed")}


def cache_specs(cfg: ModelConfig) -> list:
    """Logical axes of each layer's cache fields (``idx`` is a host int
    and has none)."""
    return [_one_cache_spec(s) for s in cfg.layer_pattern()]


# --------------------------------------------------------------------------- #
# one block
# --------------------------------------------------------------------------- #
class Block(nn.Module):
    """One pre-norm layer: ``x + mixer(norm1(x))``; with ``spec.cross``,
    then ``x + cross(norm_cross(x), memory)``; unless ``spec.mlp ==
    "none"``, then ``x + mlp(norm2(x))`` (the reference's ``init_block`` /
    ``block_apply``). The mixer is attention, MLA, Mamba, mLSTM or sLSTM,
    the MLP dense or MoE, by ``spec``; a block without an MLP holds no
    ``norm2`` and no ``mlp`` parameter. Its float parameters are used in
    the activation dtype (the float32 leaves of the SSM mixers too)."""

    def __init__(self, spec: BlockSpec, cfg: ModelConfig, *,
                 dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = Norm(cfg.d_model, cfg.norm, dtype=dtype, device=device)
        self.mixer = _MIXERS[spec.mixer](cfg, dtype=dtype, device=device,
                                         generator=generator)
        self.norm_cross = self.cross = None
        if spec.cross:
            self.norm_cross = Norm(cfg.d_model, cfg.norm, dtype=dtype,
                                   device=device)
            self.cross = Attention(cfg, dtype=dtype, device=device,
                                   generator=generator)
        self.norm2 = self.mlp = None
        if spec.mlp != "none":
            self.norm2 = Norm(cfg.d_model, cfg.norm, dtype=dtype,
                              device=device)
            self.mlp = (MoE(cfg, dtype=dtype, device=device,
                            generator=generator)
                        if spec.mlp == "moe" else
                        MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dtype,
                            device=device, generator=generator))

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                causal: bool = True, cache: Optional[dict] = None,
                memory: Optional[torch.Tensor] = None):
        """Returns (x, new_cache, aux): aux is the MoE's stats ({"load",
        "dropped"}), or None for a dense MLP or none. ``memory`` [B, L, d]
        is the encoder's output, which a cross-attention block needs."""
        with R.gather_weights(self.cfg.fsdp_gather_weights):
            return self._forward(x, positions, causal, cache, memory)

    def _settle(self, out, x):
        out = out.to(x.dtype)
        if self.cfg.tp_bf16_payload:
            out = R.replicate_partial(out)
        return out

    def _forward(self, x, positions, causal, cache, memory):
        dtype = _dtype(self.cfg.activation_dtype)
        h = self.norm1(x, dtype)
        out, new_cache = self.mixer(h, positions=positions, causal=causal,
                                    cache=cache, dtype=dtype)
        x = x + self._settle(out, x)
        if self.cross is not None:
            if memory is None:
                raise ValueError("a cross-attention block needs the "
                                 "encoder's memory (batch['memory'] in "
                                 "decode_step)")
            h = self.norm_cross(x, dtype)
            params = _cast_params(self.cross, dtype)
            if R.get_mesh() is not None:
                from repro_torch.models import sharded
                out = sharded.cross_attention(params, h, memory, self.cfg)
            else:
                out = cross_attention_apply(params, h, memory, self.cfg,
                                            positions=positions)
            x = x + self._settle(out, x)
        aux = None
        if self.mlp is not None:
            h = self.norm2(x, dtype)
            if isinstance(self.mlp, MoE):
                out, aux = self.mlp(h, dtype)
            else:
                out = self.mlp(h, dtype)
            x = x + self._settle(out, x)
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
        if cfg.n_enc_layers:
            self.encoder = nn.ModuleList(
                Block(_ATTN_DENSE, cfg, dtype=dtype, device=dev,
                      generator=generator)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = Norm(cfg.d_model, cfg.norm, dtype=dtype,
                                 device=dev)
        if cfg.frontend:
            fdim = cfg.frontend_dim or cfg.d_model
            self.frontend_adapter = _param(generator, (fdim, cfg.d_model),
                                           fdim, dtype, dev)
        if cfg.mtp_depth:
            self.mtp_proj = _param(generator, (2 * cfg.d_model, cfg.d_model),
                                   2 * cfg.d_model, dtype, dev)
            self.mtp_block = Block(_ATTN_DENSE, cfg, dtype=dtype, device=dev,
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


def embed_lookup(model: Model, ids: torch.Tensor) -> torch.Tensor:
    """``model.embed[ids]`` in the parameter dtype (vocab-parallel on a
    mesh)."""
    if R.get_mesh() is not None:
        from repro_torch.models import sharded
        return sharded.embed(model.embed, ids)
    return model.embed[ids.long()]


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (on a mesh: ``w`` gathered, ``x`` batch-sharded)."""
    if R.get_mesh() is not None:
        from repro_torch.models import sharded
        return sharded.linear(x, w)
    return x @ w


def _embed_tokens(model: Model, tokens: torch.Tensor, cfg: ModelConfig):
    return R.maybe_constrain(
        embed_lookup(model, tokens).to(_dtype(cfg.activation_dtype)), *_ACT)


def _adapt_frontend(model: Model, batch: dict, cfg: ModelConfig):
    """The precomputed frontend features [B, L, frontend_dim] through the
    adapter -> [B, L, d], in the activation dtype."""
    dtype = _dtype(cfg.activation_dtype)
    return _matmul(batch["frontend"].to(dtype),
                   model.frontend_adapter.to(dtype))


def _embed_inputs(model: Model, batch: dict, cfg: ModelConfig):
    """The token embeddings, after the adapted frontend features when the
    config has a frontend and the batch carries them."""
    x = _embed_tokens(model, batch["tokens"], cfg)
    if cfg.frontend and "frontend" in batch:
        x = torch.cat([_adapt_frontend(model, batch, cfg), x], dim=1)
    return R.maybe_constrain(x, *_ACT)


def _encode(model: Model, batch: dict, cfg: ModelConfig):
    """An encoder-decoder's encoder: the adapted frontend features through
    the encoder blocks (non-causal, positions 0..L-1) and ``enc_norm`` ->
    memory [B, L, d] in the activation dtype."""
    h = R.maybe_constrain(_adapt_frontend(model, batch, cfg), *_ACT)
    pos = torch.arange(h.shape[1], device=h.device)
    for blk in model.encoder:
        h, _, _ = _remat(blk)(h, positions=pos, causal=False)
    return R.maybe_constrain(model.enc_norm(h), *_ACT)


def _decoder_inputs(model: Model, batch: dict, cfg: ModelConfig):
    """(x, memory) for ``forward`` and ``prefill``: an encoder-decoder
    encodes the frontend and embeds only the tokens; any other config
    embeds its inputs and has no memory."""
    if cfg.n_enc_layers:
        return (_embed_tokens(model, batch["tokens"], cfg),
                _encode(model, batch, cfg))
    return _embed_inputs(model, batch, cfg), None


def _lm_logits(model: Model, h: torch.Tensor, cfg: ModelConfig):
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    if R.get_mesh() is not None:
        from repro_torch.models import sharded
        return sharded.logits(h, head.to(h.dtype))
    return h @ head.to(h.dtype)


def _remat(blk: Block):
    """``blk`` itself, or while autograd records, ``blk`` under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward instead of kept (the reference's ``remat=True``)."""
    if not torch.is_grad_enabled():
        return blk
    return lambda *a, **kw: checkpoint(blk, *a, use_reentrant=False, **kw)


def _apply_blocks(model: Model, x, *, positions, caches=None, memory=None):
    """(x, new_caches, dropped): ``dropped`` sums the MoE layers' dropped
    shares in float32, layer by layer (the reference's ``_apply_stack``
    aux sum); other layers add nothing."""
    new_caches = []
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(model.blocks):
        call = blk if caches is not None else _remat(blk)
        x, nc, aux = call(x, positions=positions, causal=True,
                          cache=None if caches is None else caches[i],
                          memory=memory)
        new_caches.append(nc)
        if aux is not None:
            dropped = dropped + aux["dropped"]
    return x, new_caches, dropped


def forward(model: Model, batch: dict, cfg: ModelConfig):
    """Full-sequence forward -> (logits [B,S,V], aux): aux["moe_dropped"],
    and with MTP aux["mtp_hidden"], the final-normed hidden state that
    ``mtp_logits`` takes. An encoder-decoder encodes batch["frontend"] and
    decodes batch["tokens"]; a frontend-prefixed config's S counts the
    prefix."""
    x, memory = _decoder_inputs(model, batch, cfg)
    pos = torch.arange(x.shape[1], device=x.device)
    x, _, dropped = _apply_blocks(model, x, positions=pos, memory=memory)
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
    z = _matmul(torch.cat([h, next_embed.to(dtype)], -1),
                model.mtp_proj.to(dtype))
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
    returns the shapes, the port allocates them). A Mamba, mLSTM or sLSTM
    layer's state has a fixed size whatever ``max_len``. On a mesh each
    tensor field is a DTensor placed by ``cache_specs``' rules."""
    dev = resolve_device(device)
    if R.get_mesh() is not None:
        from repro_torch.models import sharded
        return sharded.init_cache(cfg, batch, max_len, dev)
    return cache_layers(cfg, batch, max_len, dev)


def cache_layers(cfg: ModelConfig, batch: int, max_len: int,
                 dev: torch.device) -> list:
    """``init_cache``'s per-layer dicts of plain tensors on ``dev``."""
    dtype = _dtype(cfg.activation_dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)

    def one(spec):
        if spec.mixer == "mla":
            return mla_cache_shape(cfg, batch, max_len, dtype, device=dev)
        if spec.mixer in _STATE_CACHES:
            return _STATE_CACHES[spec.mixer](cfg, batch, dtype, device=dev)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev), "idx": 0}

    return [one(spec) for spec in cfg.layer_pattern()]


@torch.no_grad()
def decode_step(model: Model, caches: list, batch: dict, cfg: ModelConfig):
    """One-token decode: batch['tokens'] [B,1], and for an encoder-decoder
    batch['memory'] [B,L,d] (``_encode``'s output). Returns (logits
    [B,1,V], new_caches); ``caches`` is consumed."""
    x = _embed_tokens(model, batch["tokens"], cfg)
    # positions from the first layer's idx (uniform across the batch)
    idx = caches[0]["idx"]
    pos = torch.arange(idx, idx + 1, device=x.device)
    x, new_caches, _ = _apply_blocks(model, x, positions=pos, caches=caches,
                                     memory=batch.get("memory"))
    h = model.final_norm(x)
    return _lm_logits(model, h, cfg), new_caches


@torch.no_grad()
def prefill(model: Model, batch: dict, cfg: ModelConfig, max_len: int):
    """Run the full prompt through zeroed caches of capacity ``max_len``
    (attention over the whole cache, ``kv_len_valid`` = prompt length; a
    frontend prefix counts in both). Returns (last-position logits
    [B,1,V], caches)."""
    B = batch["tokens"].shape[0]
    caches = init_cache(cfg, B, max_len, device=model.embed.device)
    x, memory = _decoder_inputs(model, batch, cfg)
    pos = torch.arange(x.shape[1], device=x.device)
    x, new_caches, _ = _apply_blocks(model, x, positions=pos, caches=caches,
                                     memory=memory)
    h = model.final_norm(x[:, -1:])
    return _lm_logits(model, h, cfg), new_caches
