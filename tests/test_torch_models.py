"""LM stack parity: the port's layers, model, prefill and decode against the
JAX package's on the same numpy inputs and carried weights.

Tolerances (float32 on the CPU): layers 1e-5; ``forward``, ``prefill`` and
``decode_step`` logits 1e-4 against the reference; the port's own decode
against its own forward 5e-4, the reference's bound
(``tests/test_archs.py``). The configs must equal the reference's field
for field."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypcompat import given, settings, st

import repro.configs as RC
import repro.models.config as RMC
import repro.models.layers as RL
import repro.models.model as RM
import repro_torch.configs as TC
import repro_torch.models.config as TMC
import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro.training import steps as RS
from repro_torch.interop import model_params_from_numpy
from repro_torch.training import steps as TS

DENSE = ["olmo_1b", "phi4_mini_3p8b", "stablelm_3b", "llama3_405b"]
LAYER_ATOL = 1e-5
LOGIT_ATOL = 1e-4
SELF_DECODE_ATOL = 5e-4


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _carried(arch, seed=0, cfg_jax=None, cfg_torch=None):
    """(reference params, reference cfg, port model, port cfg): the port's
    model holds the reference's ``init_model`` weights."""
    rcfg = cfg_jax or RC.get_smoke_config(arch)
    tcfg = cfg_torch or TC.get_smoke_config(arch)
    params = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return params, rcfg, model, tcfg


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_configs_equal_reference(arch):
    assert TC.ARCHS == RC.ARCHS
    for get in ("get_config", "get_smoke_config"):
        r = getattr(RC, get)(arch)
        t = getattr(TC, get)(arch)
        assert type(t).__module__.startswith("repro_torch.")
        assert dataclasses.asdict(t) == dataclasses.asdict(r), (arch, get)
        if hasattr(r, "scan_groups"):
            def groups(c):
                return [(tuple(dataclasses.asdict(s) for s in pat), n)
                        for pat, n in c.scan_groups()]
            assert groups(t) == groups(r)
            assert t.head_dim == r.head_dim
            for shape in RMC.SHAPES:
                assert (TMC.shape_applicable(t, shape)
                        == RMC.shape_applicable(r, shape))


def test_config_registry_aliases_and_shapes():
    assert TMC.SHAPES == RMC.SHAPES
    for alias, arch in RC.registry._ALIASES.items():
        assert dataclasses.asdict(TC.get_config(alias)) == \
            dataclasses.asdict(RC.get_config(arch))
    from repro.configs import drone_graph as RD
    from repro_torch.configs import drone_graph as TD
    assert {k: dataclasses.asdict(v) for k, v in TD.WORKLOADS.items()} == \
        {k: dataclasses.asdict(v) for k, v in RD.WORKLOADS.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        TC.get_config("gpt5")


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 5, 48), 3.0) + 0.5
    p = {"rmsnorm": {"scale": _normal(rng, (48,))},
         "layernorm": {"scale": _normal(rng, (48,)),
                       "bias": _normal(rng, (48,))},
         "nonparam_ln": {}}[kind]
    want = RL.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    mod = TL.Norm(48, kind, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("pct", [1.0, 0.25])
@pytest.mark.parametrize("offset", [0, 37])
def test_rope_matches_reference(pct, offset):
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 9, 4, 16))
    pos = np.arange(9, dtype=np.int32) + offset
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0, pct=pct)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=10000.0,
                  pct=pct)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    if pct < 1.0:     # the unrotated tail passes through untouched
        np.testing.assert_array_equal(_np(got)[..., 4:], x[..., 4:])


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(3)
    mod = TL.MLP(32, 80, act, dtype=torch.float32, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    p = {n: _np(w) for n, w in mod.named_parameters()}
    x = _normal(rng, (2, 7, 32))
    want = RL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


def _qkv(seed, B, T, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, T, H, D)), _normal(rng, (B, S, Hkv, D)),
            _normal(rng, (B, S, Hkv, D)))


def _both(fn, q, k, v, **kw):
    want = getattr(RL, fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw)
    got = getattr(TL, fn)(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    return _np(got), np.asarray(want)


@settings(max_examples=8, deadline=None)
@given(st.integers(30, 300), st.integers(1, 3), st.booleans(),
       st.integers(0, 6))
def test_sdpa_dense_and_blockwise_match_reference(T, g, causal, seed):
    """Mirrors the reference's blockwise-vs-dense property test: each port
    function against its reference counterpart, and the port's blockwise
    against the port's dense."""
    q, k, v = _qkv(seed, 2, T, T, 2 * g, 2, 16)
    got_d, want_d = _both("_sdpa_dense", q, k, v, causal=causal, q_offset=0)
    got_b, want_b = _both("_sdpa_blockwise", q, k, v, causal=causal,
                          q_offset=0, kv_block=64)
    np.testing.assert_allclose(got_d, want_d, atol=LAYER_ATOL)
    np.testing.assert_allclose(got_b, want_b, atol=LAYER_ATOL)
    np.testing.assert_allclose(got_b, got_d, atol=2e-5)


@pytest.mark.parametrize("fn", ["_sdpa_dense", "_sdpa_blockwise"])
def test_sdpa_offset_and_valid_length(fn):
    """A query block at an offset over a longer cache, the cache valid only
    up to ``kv_len_valid`` (the prefill and decode pattern)."""
    q, k, v = _qkv(1, 2, 40, 200, 4, 2, 8)
    kw = dict(causal=True, q_offset=7, kv_len_valid=150)
    if fn == "_sdpa_blockwise":
        kw["kv_block"] = 32
    got, want = _both(fn, q, k, v, **kw)
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL)
    dense, _ = _both("_sdpa_dense", q, k, v, causal=True, q_offset=7,
                     kv_len_valid=150)
    np.testing.assert_allclose(got, dense, atol=2e-5)


def test_sdpa_switches_to_blockwise_past_threshold():
    """``_sdpa`` at T * S just past 4096 * 4096 takes the blockwise path in
    both packages; one token (decode) stays dense at any length."""
    T = S = 4097
    assert T * S > TL._SDPA_BLOCK_THRESHOLD == RL._SDPA_BLOCK_THRESHOLD
    q, k, v = _qkv(4, 1, T, S, 2, 1, 8)
    got, want = _both("_sdpa", q, k, v, causal=True, q_offset=0)
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL)
    blk, _ = _both("_sdpa_blockwise", q, k, v, causal=True, q_offset=0)
    np.testing.assert_array_equal(got, blk)
    got1, want1 = _both("_sdpa", q[:, -1:], k, v, causal=True, q_offset=T - 1)
    dense1, _ = _both("_sdpa_dense", q[:, -1:], k, v, causal=True,
                      q_offset=T - 1)
    np.testing.assert_array_equal(got1, dense1)
    np.testing.assert_allclose(got1, want1, atol=LAYER_ATOL)


def test_not_ported_layers_name_their_roadmap_item():
    """Cross-attention, once refused naming ROADMAP item 5f, against the
    reference: queries from ``x``, keys and values from ``memory``, no rope
    and no mask, within 1e-5 (``tests/test_torch_encdec.py`` holds the
    encoder-decoder around it)."""
    cfg = TC.get_smoke_config("seamless_m4t_large_v2")
    att = TL.Attention(cfg, dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(8))
    p = {n: t.detach() for n, t in att.named_parameters()}
    rng = np.random.default_rng(8)
    x, mem = _normal(rng, (2, 5, cfg.d_model)), _normal(rng, (2, 12,
                                                              cfg.d_model))
    want = RL.cross_attention_apply({k: jnp.asarray(v.numpy())
                                     for k, v in p.items()},
                                    jnp.asarray(x), jnp.asarray(mem), cfg,
                                    positions=jnp.arange(5))
    got = TL.cross_attention_apply(p, torch.from_numpy(x),
                                   torch.from_numpy(mem), cfg,
                                   positions=torch.arange(5))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    params, rcfg, model, tcfg = _carried(arch)
    toks = _tokens(tcfg, 2, 16)
    want, _ = RM.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    got, aux = TM.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (2, 16, tcfg.vocab) and got.dtype == torch.float32
    assert float(aux["moe_dropped"]) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(_np(model({"tokens":
                                             torch.from_numpy(toks)})[0]),
                                  _np(got))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    params, rcfg, model, tcfg = _carried(arch, seed=2)
    toks = _tokens(tcfg, 2, 12, seed=2)
    P, max_len = 9, 16
    want, rc = RM.prefill(params, {"tokens": jnp.asarray(toks[:, :P])},
                          rcfg, max_len)
    got, tc = TM.prefill(model, {"tokens": torch.from_numpy(toks[:, :P])},
                         tcfg, max_len)
    assert got.shape == (2, 1, tcfg.vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)
    for t in range(P, 12):
        want, rc = RM.decode_step(params, rc,
                                  {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                  rcfg)
        got, tc = TM.decode_step(model, tc,
                                 {"tokens": torch.from_numpy(
                                     toks[:, t:t + 1])}, tcfg)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LOGIT_ATOL)
    # the caches hold the same keys and values, layer by layer
    assert [c["idx"] for c in tc] == [12] * tcfg.n_layers
    for layer, c in enumerate(tc):
        np.testing.assert_allclose(_np(c["k"]),
                                   np.asarray(rc[0][0]["k"][layer]),
                                   atol=LAYER_ATOL)
        np.testing.assert_allclose(_np(c["v"]),
                                   np.asarray(rc[0][0]["v"][layer]),
                                   atol=LAYER_ATOL)


def test_prefill_through_blockwise_matches_reference(monkeypatch):
    """With the threshold lowered in both packages, prefill attends over
    the zeroed cache through the blockwise path (one padded KV block)."""
    monkeypatch.setattr(RL, "_SDPA_BLOCK_THRESHOLD", 64)
    monkeypatch.setattr(TL, "_SDPA_BLOCK_THRESHOLD", 64)
    params, rcfg, model, tcfg = _carried("stablelm_3b", seed=3)
    toks = _tokens(tcfg, 2, 10, seed=3)
    want, _ = RM.prefill(params, {"tokens": jnp.asarray(toks)}, rcfg, 24)
    got, _ = TM.prefill(model, {"tokens": torch.from_numpy(toks)}, tcfg, 24)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_own_decode_matches_own_forward(arch):
    """The port's seeded init, decode against forward over the same prefix
    (the reference's ``test_decode_matches_forward``)."""
    cfg = TC.get_smoke_config(arch)
    model = TM.init_model(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=5))
    with torch.no_grad():
        full, _ = TM.forward(model, {"tokens": toks}, cfg)
    P = 9
    lg, caches = TM.prefill(model, {"tokens": toks[:, :P]}, cfg, 16)
    errs = [float((lg[:, -1] - full[:, P - 1]).abs().max())]
    for t in range(P, 12):
        lg, caches = TM.decode_step(model, caches,
                                    {"tokens": toks[:, t:t + 1]}, cfg)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < SELF_DECODE_ATOL, errs


def test_seeded_init_is_reproducible_and_scaled():
    cfg = TC.get_smoke_config("llama3_405b")
    a = TM.init_model(cfg, seed=1, device="cpu")
    b = TM.init_model(cfg, seed=1, device="cpu")
    c = TM.init_model(cfg, seed=2, device="cpu")
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    assert not torch.equal(a.embed, c.embed)
    assert a.lm_head.shape == (cfg.d_model, cfg.vocab)
    # _dense_init: std 1 / sqrt(fan_in)
    wo = a.blocks[0].mixer.wo.detach()
    assert abs(float(wo.std()) * np.sqrt(cfg.n_heads * cfg.head_dim) - 1) \
        < 0.1
    assert len(a.blocks) == cfg.n_layers


def test_bfloat16_activations_follow_reference():
    """Under bf16 activations (the published configs) float parameters are
    used in bf16, so the logits are bf16; against the reference within
    2.5% of the largest logit (bf16 rounding through two layers: about 1%,
    1.5 bf16 ulps at the largest logit's magnitude)."""
    rcfg = dataclasses.replace(RC.get_smoke_config("olmo_1b"),
                               activation_dtype="bfloat16")
    tcfg = dataclasses.replace(TC.get_smoke_config("olmo_1b"),
                               activation_dtype="bfloat16")
    params, _, model, _ = _carried("olmo_1b", seed=4, cfg_jax=rcfg,
                                   cfg_torch=tcfg)
    toks = _tokens(tcfg, 2, 16, seed=4)
    want, _ = RM.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    with torch.no_grad():
        got, _ = TM.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 0.025 * np.abs(want).max(), err


def test_greedy_ties_resolve_to_first_index():
    logits = np.zeros((3, 1, 10), np.float32)
    logits[0, 0, [2, 7]] = 1.0
    logits[1, 0, [0, 9]] = 2.0
    for dtype in (torch.float32, torch.bfloat16):
        got = TS._greedy(torch.from_numpy(logits).to(dtype))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    np.testing.assert_array_equal(got.numpy(), [2, 0, 0])


def test_cache_overflow_raises():
    """The reference's ``dynamic_update_slice`` clamps a write past the
    cache and overwrites earlier positions; the port raises instead."""
    cfg = TC.get_smoke_config("olmo_1b")
    model = TM.init_model(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 6))
    _, caches = TM.prefill(model, {"tokens": toks}, cfg, 7)
    _, caches = TM.decode_step(model, caches, {"tokens": toks[:, :1]}, cfg)
    with pytest.raises(ValueError, match="runs past"):
        TM.decode_step(model, caches, {"tokens": toks[:, :1]}, cfg)
    with pytest.raises(ValueError, match="runs past"):
        TM.prefill(model, {"tokens": toks}, cfg, 5)


def test_carried_weights_must_match_every_parameter():
    params, _, _, tcfg = _carried("phi4_mini_3p8b")
    tree = jax.tree.map(np.asarray, params)
    tree["lm_head"] = np.zeros((tcfg.d_model, tcfg.vocab), np.float32)
    with pytest.raises(RuntimeError, match="lm_head"):
        model_params_from_numpy(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    del tree["blocks"][0][0]["mlp"]["w_up"]
    with pytest.raises(RuntimeError, match="w_up"):
        model_params_from_numpy(tree, tcfg, device="cpu")


def test_carried_bfloat16_weights_load_exactly():
    """A config with bf16 parameters (the published ones): the reference's
    ml_dtypes bfloat16 leaves land in the port's bf16 parameters bit for
    bit."""
    rcfg = dataclasses.replace(RC.get_smoke_config("llama3_405b"),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(TC.get_smoke_config("llama3_405b"),
                               param_dtype="bfloat16")
    params, _, model, _ = _carried("llama3_405b", cfg_jax=rcfg,
                                   cfg_torch=tcfg)
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.embed.detach().float().numpy(),
        np.asarray(params["embed"].astype(jnp.float32)))
    np.testing.assert_array_equal(
        model.blocks[2].mixer.wo.detach().float().numpy(),
        np.asarray(params["blocks"][0][0]["mixer"]["wo"][2]
                   .astype(jnp.float32)))


def test_prefill_step_and_serve_step_match_reference():
    """The step builders: next tokens of a prefill and one decode step."""
    params, rcfg, model, tcfg = _carried("llama3_405b", seed=6)
    toks = _tokens(tcfg, 2, 8, seed=6)
    rn, rc = RS.make_prefill_step(rcfg, 12)(params,
                                            {"tokens": jnp.asarray(toks)})
    tn, tc = TS.make_prefill_step(tcfg, 12)(model,
                                            {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
    rn, _ = RS.make_serve_step(rcfg)(params, rc, {"tokens": rn[:, None]})
    tn, _ = TS.make_serve_step(tcfg)(model, tc, {"tokens": tn[:, None]})
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
