"""MLA and MTP parity: the port's ``mla_apply`` / ``MLA``, its latent cache
and ``mtp_logits`` against the JAX package's on the same numpy inputs and
carried weights (``deepseek_v3_671b``'s smoke config).

Tolerances (float32 on the CPU): the layer and its cache 1e-5; logits 1e-4
against the reference."""
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
from repro_torch.interop import model_params_from_numpy

ARCH = "deepseek_v3_671b"
LAYER_ATOL = 1e-5
LOGIT_ATOL = 1e-4


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _carried_mla(seed=0):
    """(reference params, reference cfg, port ``MLA``, port cfg)."""
    rcfg, tcfg = RC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    p = RL.init_mla(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    mod = TL.MLA(tcfg, dtype=torch.float32, device="cpu")
    flat = {}
    for k, v in p.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    # the norms' scales are ones at init: make them matter
    rng = np.random.default_rng(seed)
    for k in ("q_norm.scale", "kv_norm.scale"):
        flat[k] = (1 + 0.3 * rng.standard_normal(flat[k].shape)).astype(
            np.float32)
        head, leaf = k.split(".")
        p = dict(p, **{head: {leaf: jnp.asarray(flat[k])}})
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in flat.items()}, strict=True)
    return p, rcfg, mod, tcfg


def _x(cfg, B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def test_mla_leaves_have_the_reference_shapes():
    p, rcfg, mod, tcfg = _carried_mla()
    m = tcfg.mla
    assert mod.wuq.shape == (m.q_lora_rank, tcfg.n_heads,
                             m.nope_head_dim + m.rope_head_dim)
    assert mod.wo.shape == (tcfg.n_heads, m.v_head_dim, tcfg.d_model)
    got = {n: tuple(t.shape) for n, t in mod.state_dict().items()}
    want = {}
    for k, v in p.items():
        if isinstance(v, dict):
            want.update({f"{k}.{kk}": vv.shape for kk, vv in v.items()})
        else:
            want[k] = v.shape
    assert got == want


@pytest.mark.parametrize("causal", [True, False])
def test_mla_full_sequence_matches_reference(causal):
    p, rcfg, mod, tcfg = _carried_mla(seed=1)
    x = _x(tcfg, 2, 11, seed=1)
    pos = np.arange(11, dtype=np.int32)
    want, wc = RL.mla_apply(p, jnp.asarray(x), rcfg,
                            positions=jnp.asarray(pos), causal=causal)
    with torch.no_grad():
        got, gc = mod(torch.from_numpy(x), positions=torch.from_numpy(pos),
                      causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    for key in ("ckv", "kr"):
        np.testing.assert_allclose(_np(gc[key]), np.asarray(wc[key]),
                                   atol=LAYER_ATOL)
    assert gc["idx"] == int(wc["idx"]) == 11


def test_mla_cached_with_offset_matches_reference():
    """A 7-token block written at offset 5 of a 16-position cache whose
    first 5 positions hold an earlier block, then one-token steps; every
    call causal (a cache is given)."""
    p, rcfg, mod, tcfg = _carried_mla(seed=2)
    x = _x(tcfg, 2, 14, seed=2)
    shapes = RL.mla_cache_shape(rcfg, 2, 16, jnp.float32)
    rc = {k: jnp.zeros(s.shape, s.dtype) for k, s in shapes.items()}
    tc = TL.mla_cache_shape(tcfg, 2, 16, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items() if k != "idx"} == \
        {k: s.shape for k, s in shapes.items() if k != "idx"}
    assert tc["idx"] == 0
    for lo, hi in ((0, 5), (5, 12), (12, 13), (13, 14)):
        pos = np.arange(lo, hi, dtype=np.int32)
        want, rc = RL.mla_apply(p, jnp.asarray(x[:, lo:hi]), rcfg,
                                positions=jnp.asarray(pos), causal=False,
                                cache=rc)
        with torch.no_grad():
            got, tc = mod(torch.from_numpy(x[:, lo:hi]),
                          positions=torch.from_numpy(pos), causal=False,
                          cache=tc)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LAYER_ATOL)
        assert tc["idx"] == int(rc["idx"]) == hi
    for key in ("ckv", "kr"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(rc[key]),
                                   atol=LAYER_ATOL)
    # the cache's tail was never written
    assert not tc["ckv"][:, 14:].any()
    with pytest.raises(ValueError, match="runs past"):
        mod(torch.from_numpy(x[:, :3]),
            positions=torch.arange(14, 17), cache=tc)


def test_mla_through_blockwise_matches_reference(monkeypatch):
    """Past the threshold (lowered in both packages) MLA's SDPA takes the
    blockwise path, with q/k head dim nope + rope = 24 and v 16."""
    monkeypatch.setattr(RL, "_SDPA_BLOCK_THRESHOLD", 64)
    monkeypatch.setattr(TL, "_SDPA_BLOCK_THRESHOLD", 64)
    p, rcfg, mod, tcfg = _carried_mla(seed=3)
    x = _x(tcfg, 1, 40, seed=3)
    pos = np.arange(40, dtype=np.int32)
    want, _ = RL.mla_apply(p, jnp.asarray(x), rcfg,
                           positions=jnp.asarray(pos))
    with torch.no_grad():
        got, _ = mod(torch.from_numpy(x), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


def test_sdpa_takes_a_value_dim_other_than_the_key_dim():
    """Dv != Dk, scaled by q's last dimension, dense and blockwise."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 30, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 30, 4, 24)).astype(np.float32)
    v = rng.standard_normal((2, 30, 4, 16)).astype(np.float32)
    for fn, kw in (("_sdpa_dense", {}), ("_sdpa_blockwise",
                                          {"kv_block": 8})):
        want = getattr(RL, fn)(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, q_offset=0, **kw)
        got = getattr(TL, fn)(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, q_offset=0,
                              **kw)
        assert got.shape == (2, 30, 4, 16)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LAYER_ATOL)


def test_bfloat16_mla_follows_reference():
    """bf16 activations and cast weights: within 2.5% of the largest
    output, as the dense bf16 model test holds."""
    p, rcfg, mod, tcfg = _carried_mla(seed=5)
    x = _x(tcfg, 2, 9, seed=5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pos = np.arange(9, dtype=np.int32)
    want, _ = RL.mla_apply(RM._cast_floats(p, jnp.bfloat16), xb, rcfg,
                           positions=jnp.asarray(pos))
    with torch.no_grad():
        got, _ = mod(torch.from_numpy(x).to(torch.bfloat16),
                     positions=torch.from_numpy(pos), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 0.025 * np.abs(want).max(), err


def _carried_model(seed=0):
    rcfg, tcfg = RC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    params = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return params, rcfg, model, tcfg


def test_mtp_logits_match_reference():
    """The training loss's MTP call (``steps.loss_fn``): the forward's
    ``mtp_hidden`` and the next tokens' embeddings -> [B, S, V]."""
    params, rcfg, model, tcfg = _carried_model(seed=6)
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 10)).astype(
        np.int32)
    _, waux = RM.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    nxt = np.pad(toks[:, 1:], ((0, 0), (0, 1)))
    want = RM.mtp_logits(params, waux["mtp_hidden"],
                         params["embed"][jnp.asarray(nxt)], rcfg)
    with torch.no_grad():
        _, aux = TM.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
        np.testing.assert_allclose(_np(aux["mtp_hidden"]),
                                   np.asarray(waux["mtp_hidden"]),
                                   atol=LAYER_ATOL)
        got = TM.mtp_logits(model, aux["mtp_hidden"],
                            model.embed[torch.from_numpy(nxt).long()], tcfg)
    assert got.shape == (2, 10, tcfg.vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)


def test_mtp_leaves_are_carried():
    """``mtp_proj``, ``mtp_block`` (an attention + dense block, not MLA)
    and ``mtp_norm`` land on the port's parameters."""
    params, _, model, tcfg = _carried_model(seed=7)
    assert isinstance(model.mtp_block.mixer, TL.Attention)
    assert isinstance(model.mtp_block.mlp, TL.MLP)
    np.testing.assert_array_equal(_np(model.mtp_proj),
                                  np.asarray(params["mtp_proj"]))
    np.testing.assert_array_equal(
        _np(model.mtp_block.mixer.wq),
        np.asarray(params["mtp_block"]["mixer"]["wq"]))
    cfg = dataclasses.replace(tcfg, mtp_depth=0)
    assert not hasattr(TM.init_model(cfg, device="cpu"), "mtp_proj")


def test_mla_model_cache_layout():
    """``init_cache`` allocates by mixer: MLA layers hold the latent cache
    (kv_lora + rope per position), not per-head keys and values."""
    tcfg = TC.get_smoke_config(ARCH)
    caches = TM.init_cache(tcfg, 3, 20, device="cpu")
    assert len(caches) == tcfg.n_layers
    for c in caches:
        assert set(c) == {"ckv", "kr", "idx"} and c["idx"] == 0
        assert c["ckv"].shape == (3, 20, tcfg.mla.kv_lora_rank)
        assert c["kr"].shape == (3, 20, tcfg.mla.rope_head_dim)
    dense = TM.init_cache(TC.get_smoke_config("phi35_moe_42b"), 3, 20,
                          device="cpu")
    assert set(dense[0]) == {"k", "v", "idx"}
