"""The encoder-decoder and the frontend stubs: the port's
``cross_attention_apply``, ``_encode``, the frontend-prefixed
``_embed_inputs`` and the ``seamless_m4t_large_v2`` (speech encoder-decoder)
and ``internvl2_26b`` (VLM, patch features before the prompt) smoke configs
against the JAX package's on the same numpy inputs and carried weights.

Tolerances (float32 on the CPU): the layers, ``_encode`` and the adapted
frontend 1e-5; ``forward``, ``prefill`` and ``decode_step`` logits 1e-4 of
the reference, greedy tokens equal; the port's own decode against its own
forward 5e-4 (the reference's bound, ``tests/test_archs.py``). Frontend
features are drawn as ``tests/test_archs.py:21`` draws them (normal, times
0.02)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.layers as RL
import repro.models.model as RM
import repro_torch.configs as TC
import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro.training import steps as RS
from repro_torch.interop import model_params_from_numpy
from repro_torch.training import steps as TS

ENC_DEC = "seamless_m4t_large_v2"
VLM = "internvl2_26b"
LAYER_ATOL = 1e-5
LOGIT_ATOL = 1e-4
SELF_DECODE_ATOL = 5e-4
BF16_REL = 2.0 ** -5


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.float() if x.dtype == torch.bfloat16 else x
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _carried(arch, seed=0, act="float32"):
    rcfg = dataclasses.replace(RC.get_smoke_config(arch),
                               activation_dtype=act)
    tcfg = dataclasses.replace(TC.get_smoke_config(arch),
                               activation_dtype=act)
    params = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return params, rcfg, model, tcfg


def _batch(cfg, B, S, seed=0):
    """numpy tokens [B, S] and frontend features [B, L, F] * 0.02."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend:
        batch["frontend"] = _normal(rng, (B, cfg.frontend_len,
                                          cfg.frontend_dim), 0.02)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# the layers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T,L", [(1, 12), (9, 12), (16, 40)])
def test_cross_attention_matches_reference(T, L):
    """Queries from ``x``, keys and values from ``memory``: no rope (the
    positions are ignored), no mask, GQA by head grouping."""
    cfg = TC.get_smoke_config(VLM)           # 4 heads over 2 KV heads
    att = TL.Attention(cfg, dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(T))
    p = {n: t.detach() for n, t in att.named_parameters()}
    rng = np.random.default_rng(T)
    x = _normal(rng, (2, T, cfg.d_model))
    mem = _normal(rng, (2, L, cfg.d_model))
    want = RL.cross_attention_apply({k: jnp.asarray(v.numpy())
                                     for k, v in p.items()},
                                    jnp.asarray(x), jnp.asarray(mem), cfg,
                                    positions=jnp.arange(T) + 5)
    got = TL.cross_attention_apply(p, torch.from_numpy(x),
                                   torch.from_numpy(mem), cfg,
                                   positions=torch.arange(T) + 5)
    assert got.shape == (2, T, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    other = TL.cross_attention_apply(p, torch.from_numpy(x),
                                     torch.from_numpy(mem), cfg,
                                     positions=torch.arange(T) + 99)
    assert torch.equal(other, got)


def test_cross_attention_in_bf16_follows_reference():
    cfg = TC.get_smoke_config(ENC_DEC)
    att = TL.Attention(cfg, dtype=torch.bfloat16, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    p = {n: t.detach() for n, t in att.named_parameters()}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_normal(rng, (2, 7, cfg.d_model))).bfloat16()
    mem = torch.from_numpy(_normal(rng, (2, 12, cfg.d_model))).bfloat16()
    want = RL.cross_attention_apply(
        {k: jnp.asarray(_np(v), jnp.bfloat16) for k, v in p.items()},
        jnp.asarray(_np(x), jnp.bfloat16), jnp.asarray(_np(mem),
                                                       jnp.bfloat16),
        cfg, positions=jnp.arange(7))
    got = TL.cross_attention_apply(p, x, mem, cfg, positions=torch.arange(7))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    scale = float(jnp.abs(want.astype(jnp.float32)).max())
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_REL * scale)


def test_encode_matches_reference():
    """``_encode``: the adapted frame features through the non-causal
    encoder blocks and ``enc_norm``, within 1e-5."""
    params, rcfg, model, tcfg = _carried(ENC_DEC, seed=1)
    batch = _batch(tcfg, 2, 6, seed=1)
    want = RM._encode(params, _jnp(batch), rcfg)
    with torch.no_grad():
        got = TM._encode(model, _torch(batch), tcfg)
    assert got.shape == (2, tcfg.frontend_len, tcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    # non-causal: the first frame's encoding sees the last frame
    moved = dict(batch, frontend=batch["frontend"].copy())
    moved["frontend"][:, -1] += 1.0
    with torch.no_grad():
        got2 = TM._encode(model, _torch(moved), tcfg)
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-4


def test_frontend_prefixed_embed_inputs_match_reference():
    """A VLM prepends the adapted patch features to the token embeddings;
    a batch without them embeds the tokens alone."""
    params, rcfg, model, tcfg = _carried(VLM, seed=2)
    batch = _batch(tcfg, 2, 5, seed=2)
    want = RM._embed_inputs(params, _jnp(batch), rcfg)
    with torch.no_grad():
        got = TM._embed_inputs(model, _torch(batch), tcfg)
    assert got.shape == (2, tcfg.frontend_len + 5, tcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    toks = {"tokens": batch["tokens"]}
    want = RM._embed_inputs(params, _jnp(toks), rcfg)
    got = TM._embed_inputs(model, _torch(toks), tcfg)
    assert got.shape == (2, 5, tcfg.d_model)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# --------------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", [ENC_DEC, VLM])
def test_forward_matches_reference(arch):
    """The logits over the tokens (seamless) or over the patch prefix and
    the tokens (internvl2), within 1e-4."""
    params, rcfg, model, tcfg = _carried(arch, seed=3)
    batch = _batch(tcfg, 2, 12, seed=3)
    want, _ = RM.forward(params, _jnp(batch), rcfg)
    with torch.no_grad():
        got, aux = TM.forward(model, _torch(batch), tcfg)
    off = 0 if tcfg.n_enc_layers else tcfg.frontend_len
    assert got.shape == (2, 12 + off, tcfg.vocab)
    assert float(aux["moe_dropped"]) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", [ENC_DEC, VLM])
def test_prefill_decode_and_greedy_tokens_match_reference(arch):
    """``tests/test_archs.py:55-75`` on both packages: a prefill (the VLM's
    cache holds the patch prefix, so its positions continue from
    ``frontend_len + P``), then greedy decode steps fed each package's own
    tokens, seamless with the ``memory`` encoded once; logits within 1e-4
    at every step, tokens equal, the self-attention caches within 1e-4; the
    step builders serve the same tokens."""
    params, rcfg, model, tcfg = _carried(arch, seed=4)
    batch = _batch(tcfg, 2, 10, seed=4)
    gen = 6
    off = 0 if tcfg.n_enc_layers else tcfg.frontend_len
    max_len = 10 + gen + off
    rmem = RM._encode(params, _jnp(batch), rcfg) if rcfg.n_enc_layers \
        else None
    with torch.no_grad():
        tmem = TM._encode(model, _torch(batch), tcfg) if tcfg.n_enc_layers \
            else None
    want, rc = RM.prefill(params, _jnp(batch), rcfg, max_len)
    got, tc = TM.prefill(model, _torch(batch), tcfg, max_len)
    want_toks, got_toks = [], []
    for step in range(gen):
        if step:
            rb = {"tokens": jnp.asarray(want_toks[-1])[:, None]}
            tb = {"tokens": torch.from_numpy(got_toks[-1])[:, None]}
            if rmem is not None:
                rb["memory"], tb["memory"] = rmem, tmem
            want, rc = RM.decode_step(params, rc, rb, rcfg)
            got, tc = TM.decode_step(model, tc, tb, tcfg)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LOGIT_ATOL, err_msg=str(step))
        want_toks.append(np.asarray(jnp.argmax(want[:, -1], axis=-1)))
        got_toks.append(TS._greedy(got).numpy())
        np.testing.assert_array_equal(got_toks[-1], want_toks[-1])
    pos = off + 10 + gen - 1
    assert [c["idx"] for c in tc] == [pos] * tcfg.n_layers
    for layer, c in enumerate(tc):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(c[key]),
                                       np.asarray(rc[0][0][key][layer]),
                                       atol=LOGIT_ATOL,
                                       err_msg=f"{layer} {key}")

    def serve(prefill, step, model_, wrap, memory):
        nxt, caches = prefill(model_, {k: wrap(v) for k, v in batch.items()})
        out = [np.asarray(nxt)]
        for _ in range(gen - 1):
            db = {"tokens": nxt[:, None]}
            if memory is not None:
                db["memory"] = memory
            nxt, caches = step(model_, caches, db)
            out.append(np.asarray(nxt))
        return np.stack(out, axis=1)

    ref_serve = serve(jax.jit(RS.make_prefill_step(rcfg, max_len)),
                      jax.jit(RS.make_serve_step(rcfg)), params, jnp.asarray,
                      rmem)
    port_serve = serve(TS.make_prefill_step(tcfg, max_len),
                       TS.make_serve_step(tcfg), model, torch.from_numpy,
                       tmem)
    np.testing.assert_array_equal(ref_serve, np.stack(want_toks, axis=1))
    np.testing.assert_array_equal(port_serve, ref_serve)


@pytest.mark.parametrize("arch", [ENC_DEC, VLM])
def test_own_decode_matches_own_forward(arch):
    """The port's seeded init, decode against forward over the same prefix
    (the reference's ``test_decode_matches_forward``, its offsets and its
    ``memory``)."""
    cfg = TC.get_smoke_config(arch)
    model = TM.init_model(cfg, seed=5, device="cpu")
    batch = _torch(_batch(cfg, 2, 12, seed=5))
    toks = batch["tokens"]
    with torch.no_grad():
        full, _ = TM.forward(model, batch, cfg)
        memory = TM._encode(model, batch, cfg) if cfg.n_enc_layers else None
    off = 0 if cfg.n_enc_layers else cfg.frontend_len
    P = 9
    lg, caches = TM.prefill(model, dict(batch, tokens=toks[:, :P]), cfg,
                            12 + 4 + off)
    errs = [float((lg[:, -1] - full[:, P - 1 + off]).abs().max())]
    for t in range(P, 12):
        assert caches[0]["idx"] == t + off
        db = {"tokens": toks[:, t:t + 1]}
        if memory is not None:
            db["memory"] = memory
        lg, caches = TM.decode_step(model, caches, db, cfg)
        errs.append(float((lg[:, 0] - full[:, t + off]).abs().max()))
    assert max(errs) < SELF_DECODE_ATOL, errs


def test_encoder_decoder_decode_needs_the_memory():
    cfg = TC.get_smoke_config(ENC_DEC)
    model = TM.init_model(cfg, seed=6, device="cpu")
    batch = _torch(_batch(cfg, 1, 4, seed=6))
    _, caches = TM.prefill(model, batch, cfg, 8)
    with pytest.raises(ValueError, match="memory"):
        TM.decode_step(model, caches, {"tokens": batch["tokens"][:, :1]},
                       cfg)


def test_encoder_decoder_blocks_and_leaves():
    """seamless: every decoder block has ``norm_cross`` and ``cross`` (an
    attention's leaves), the encoder ``n_enc_layers`` attention + dense
    blocks without them, ``enc_norm`` and the adapter [frontend_dim, d];
    the VLM only the adapter. Parameter names and shapes equal the
    reference tree's, flattened."""
    for arch in (ENC_DEC, VLM):
        params, rcfg, model, tcfg = _carried(arch, seed=7)
        assert (model.frontend_adapter.shape
                == (tcfg.frontend_dim, tcfg.d_model))
        assert hasattr(model, "encoder") == bool(tcfg.n_enc_layers)
        want = {}

        def flat(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    flat(v, f"{prefix}{k}.")
                else:
                    want[f"{prefix}{k}"] = tuple(np.shape(v))

        flat({k: v for k, v in params.items()
              if k not in ("blocks", "encoder")}, "")
        for layer in range(tcfg.n_layers):
            flat(jax.tree.map(lambda a: a[layer], params["blocks"][0][0]),
                 f"blocks.{layer}.")
        for layer in range(tcfg.n_enc_layers):
            flat(jax.tree.map(lambda a: a[layer], params["encoder"][0]),
                 f"encoder.{layer}.")
        assert {n: tuple(p.shape) for n, p in model.named_parameters()} \
            == want
        for blk in model.blocks:
            assert (blk.cross is not None) == bool(tcfg.n_enc_layers)
        for blk in getattr(model, "encoder", ()):
            assert blk.cross is None and blk.mlp is not None


def _ref_tree(arch, seed=0):
    cfg = RC.get_smoke_config(arch)
    return jax.tree.map(np.asarray, RM.init_model(jax.random.PRNGKey(seed),
                                                  cfg))


@pytest.mark.parametrize("family,fault", [
    ("encoder", "missing"), ("encoder", "extra"), ("enc_norm", "missing"),
    ("enc_norm", "extra"), ("frontend_adapter", "missing"),
    ("frontend_adapter", "extra"), ("cross", "missing"), ("cross", "extra")])
def test_carried_tree_must_match_every_parameter(family, fault):
    """The strict load on each new leaf family: a leaf the model lacks, or
    a parameter the tree lacks, fails it. An "extra" leaf is the family
    given to a config without it (the VLM has no encoder and no cross-
    attention; olmo has no frontend), or one leaf too many."""
    if fault == "missing":
        tree, tcfg = _ref_tree(ENC_DEC), TC.get_smoke_config(ENC_DEC)
        if family == "encoder":
            del tree["encoder"][0]["mixer"]["wk"]
        elif family == "enc_norm":
            del tree["enc_norm"]["bias"]
        elif family == "frontend_adapter":
            del tree["frontend_adapter"]
        else:
            del tree["blocks"][0][0]["cross"]["wo"]
    else:
        enc = _ref_tree(ENC_DEC)
        if family == "frontend_adapter":
            tree, tcfg = _ref_tree("olmo_1b"), TC.get_smoke_config("olmo_1b")
            tree["frontend_adapter"] = np.zeros((8, tcfg.d_model), np.float32)
        elif family == "enc_norm":
            tree, tcfg = enc, TC.get_smoke_config(ENC_DEC)
            tree["enc_norm"]["extra"] = np.zeros(tcfg.d_model, np.float32)
        else:
            tree, tcfg = _ref_tree(VLM), TC.get_smoke_config(VLM)
            if family == "encoder":
                tree["encoder"] = enc["encoder"]
            else:
                g = tree["blocks"][0][0]
                g["cross"] = jax.tree.map(lambda a: a, g["mixer"])
    with pytest.raises(RuntimeError, match=family):
        model_params_from_numpy(tree, tcfg, device="cpu")
