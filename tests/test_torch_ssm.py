"""Mamba and the Jamba hybrid: the port's ``repro_torch.models.ssm`` and the
``jamba_v01_52b`` smoke config against the JAX package's on the same numpy
inputs and carried weights.

Tolerances (float32 on the CPU): ``_mamba_scan`` 1e-5; ``mamba_apply``
and its cache leaves 1e-5 plus 1e-6 of the value (``rtol``, about 8
float32 ulps: the mixer's outputs reach 10-15 at the smoke width, where
an ulp is 1e-6 and the sums of the scan and the projections cancel); the
chunked scan against the single-shot one 1e-5, as
``tests/test_longcontext_paths.py`` holds the reference's; ``forward``,
``prefill`` and ``decode_step`` logits and the model's caches 1e-4
against the reference, on a 600-token prompt, so through the chunked scan
(chunk 512); the port's own decode against its own forward 5e-4 (the
reference's bound, ``tests/test_archs.py``); ``moe_dropped`` and the
greedy tokens equal.
The in-chunk scan is a doubling scan where the reference's is
``lax.associative_scan``: the same sums in another order.

bfloat16 holds 8 bits of mantissa, and the two packages round at other
points (the reference's XLA fuses elementwise chains, ``jax.nn.silu`` and
``softplus`` round twice where torch rounds once, and the scans add in
another order), so bf16 is held to bounds, not to bits: one Mamba step
within 8 bf16 ulps of the largest output (2 ** -5 of it); after a
600-token prefill of the model, every Mamba layer's ``h`` and ``conv`` in
the reference's dtypes (bfloat16: ``_mamba_scan`` returns its state in
``u``'s dtype), layer 0's within 8 ulps of the reference's largest, and
every layer's no further from the float32 prefill on the same weights
(root mean square) than twice the reference's bf16 cache is."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypcompat import given, settings, st

import repro.configs as RC
import repro.models.model as RM
import repro.models.ssm as Rssm
import repro_torch.configs as TC
import repro_torch.models.model as TM
import repro_torch.models.ssm as Tssm
from repro.training import steps as RS
from repro_torch.interop import model_params_from_numpy
from repro_torch.training import steps as TS

ARCH = "jamba_v01_52b"
LAYER_ATOL = 1e-5
LAYER_RTOL = 1e-6
LOGIT_ATOL = 1e-4
SELF_DECODE_ATOL = 5e-4
BF16_REL = 2.0 ** -5
LONG = 600                 # > _MAMBA_CHUNK: the chunked scan


def _np(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        x = x.float()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _scan_inputs(seed, b, s, di, n):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    u = _normal(rng, (b, s, di), 0.1)
    dt = (np.log1p(np.exp(_normal(rng, (b, s, di)))) * 0.1).astype(
        np.float32)
    B = _normal(rng, (b, s, n), 0.3)
    C = _normal(rng, (b, s, n), 0.3)
    A = -np.exp(_normal(rng, (di, n), 0.2))
    D = np.ones((di,), np.float32)
    return u, dt, B, C, A, D


def _scan_both(args, **kw):
    want = Rssm._mamba_scan(*map(jnp.asarray, args), **kw)
    got = Tssm._mamba_scan(*map(torch.from_numpy, args), **kw)
    return [_np(t) for t in got], [np.asarray(t) for t in want]


# --------------------------------------------------------------------------- #
# the scan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s,chunk", [(300, 512), (700, 128), (1100, 512)],
                         ids=["single_shot", "chunked_128", "chunked_512"])
def test_mamba_scan_matches_reference(s, chunk):
    args = _scan_inputs(s, 2, s, 16, 4)
    (y, h), (y_ref, h_ref) = _scan_both(args, chunk=chunk)
    assert y.shape == (2, s, 16) and h.shape == (2, 16, 4)
    np.testing.assert_allclose(y, y_ref, atol=LAYER_ATOL)
    np.testing.assert_allclose(h, h_ref, atol=LAYER_ATOL)


@settings(max_examples=6, deadline=None)
@given(st.integers(100, 700), st.integers(0, 4))
def test_chunked_scan_matches_single_shot(s, seed):
    """The reference's ``test_mamba_chunked_matches_full`` on the port."""
    args = [torch.from_numpy(a) for a in _scan_inputs(seed, 2, s, 8, 4)]
    y1, h1 = Tssm._mamba_scan(*args, chunk=4096)
    y2, h2 = Tssm._mamba_scan(*args, chunk=128)
    np.testing.assert_allclose(_np(y1), _np(y2), atol=1e-5)
    np.testing.assert_allclose(_np(h1), _np(h2), atol=1e-5)


@pytest.mark.parametrize("c", [1, 2, 7, 64, 100])
def test_doubling_scan_equals_the_recurrence(c):
    """``_inclusive_scan`` against the step-by-step recurrence ``h_t =
    g_t·h_{t-1} + x_t`` and the running product of ``g``, float64."""
    rng = np.random.default_rng(c)
    g = torch.from_numpy(rng.uniform(0.5, 1.0, (2, c, 3)))
    x = torch.from_numpy(rng.standard_normal((2, c, 3)))
    cum, h = Tssm._inclusive_scan(g, x)
    hw, cw = torch.zeros(2, 3, dtype=torch.float64), torch.ones(
        2, 3, dtype=torch.float64)
    for t in range(c):
        hw = g[:, t] * hw + x[:, t]
        cw = cw * g[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), hw.numpy(), rtol=1e-12)
        np.testing.assert_allclose(cum[:, t].numpy(), cw.numpy(),
                                   rtol=1e-12)


# --------------------------------------------------------------------------- #
# the mixer
# --------------------------------------------------------------------------- #
def _mixer(seed=0, act="float32"):
    """(reference cfg, port cfg, port Mamba, its params as jnp arrays)."""
    rcfg = dataclasses.replace(RC.get_smoke_config(ARCH),
                               activation_dtype=act)
    tcfg = dataclasses.replace(TC.get_smoke_config(ARCH),
                               activation_dtype=act)
    mod = Tssm.Mamba(tcfg, dtype=torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():     # a nonzero bias and skew, so each leaf counts
        mod.conv_b.normal_(generator=torch.Generator().manual_seed(seed))
        mod.dt_bias.fill_(-1.0)
        mod.D.mul_(0.5)
    return rcfg, tcfg, mod, {n: jnp.asarray(_np(p))
                             for n, p in mod.named_parameters()}


def _ref_cache(rcfg, B, dtype=jnp.float32):
    shapes = Rssm.mamba_cache_shape(rcfg, B, dtype)
    return {k: jnp.zeros(v.shape, v.dtype) for k, v in shapes.items()}


def _port_apply(mod, x, dtype=None, cache=None):
    with torch.no_grad():
        return mod(torch.from_numpy(x) if isinstance(x, np.ndarray) else x,
                   cache=cache, dtype=dtype)


@pytest.mark.parametrize("S", [9, LONG])
def test_mamba_apply_full_sequence_matches_reference(S):
    rcfg, tcfg, mod, p = _mixer(1)
    x = _normal(np.random.default_rng(1), (2, S, tcfg.d_model))
    want, wc = Rssm.mamba_apply(p, jnp.asarray(x), rcfg)
    got, gc = _port_apply(mod, x)
    assert wc is None and gc is None
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL,
                               rtol=LAYER_RTOL)


@pytest.mark.parametrize("S", [1, 2, 9, LONG])
def test_mamba_prefill_and_decode_match_reference(S):
    """A prefill of ``S`` tokens (one token takes the decode path from the
    zero state, as in the reference), then three decode steps; the output
    and every cache leaf after each call."""
    rcfg, tcfg, mod, p = _mixer(2)
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, S + 3, tcfg.d_model))
    rc = _ref_cache(rcfg, 2)
    tc = Tssm.mamba_cache_shape(tcfg, 2, torch.float32, device="cpu")
    for lo, hi in [(0, S), (S, S + 1), (S + 1, S + 2), (S + 2, S + 3)]:
        want, rc = Rssm.mamba_apply(p, jnp.asarray(x[:, lo:hi]), rcfg,
                                    cache=rc)
        got, tc = _port_apply(mod, x[:, lo:hi], cache=tc)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LAYER_ATOL, rtol=LAYER_RTOL)
        assert tc["idx"] == int(rc["idx"]) == hi
        for k in ("conv", "h"):
            assert tc[k].shape == rc[k].shape, k
            np.testing.assert_allclose(_np(tc[k]), np.asarray(rc[k]),
                                       atol=LAYER_ATOL, rtol=LAYER_RTOL,
                                       err_msg=k)


def test_decode_from_a_fresh_cache_promotes_like_the_reference():
    """In bf16, one token from the zeroed cache (``h`` float32) runs the
    step in float32 and leaves ``h`` float32 in both packages; after a
    prefill ``h`` is bf16 and stays so through a decode step."""
    rcfg, tcfg, mod, p = _mixer(3, act="bfloat16")
    pb = {k: v.astype(jnp.bfloat16) for k, v in p.items()}
    x = _normal(np.random.default_rng(3), (2, 6, tcfg.d_model))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    rc = _ref_cache(rcfg, 2, jnp.bfloat16)
    tc = Tssm.mamba_cache_shape(tcfg, 2, torch.bfloat16, device="cpu")
    want, rc1 = Rssm.mamba_apply(pb, jnp.asarray(x[:, :1], jnp.bfloat16),
                                 rcfg, cache=rc)
    got, tc1 = _port_apply(mod, xb[:, :1], torch.bfloat16, cache=tc)
    assert rc1["h"].dtype == jnp.float32 and tc1["h"].dtype == torch.float32
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want),
                               atol=BF16_REL * float(jnp.abs(want).max()))
    _, rc2 = Rssm.mamba_apply(pb, jnp.asarray(x[:, :5], jnp.bfloat16), rcfg,
                              cache=rc)
    _, tc2 = _port_apply(mod, xb[:, :5], torch.bfloat16, cache=tc)
    want, rc3 = Rssm.mamba_apply(pb, jnp.asarray(x[:, 5:], jnp.bfloat16),
                                 rcfg, cache=rc2)
    got, tc3 = _port_apply(mod, xb[:, 5:], torch.bfloat16, cache=tc2)
    for c in (rc2, rc3):
        assert c["h"].dtype == c["conv"].dtype == jnp.bfloat16
    for c in (tc2, tc3):
        assert c["h"].dtype == c["conv"].dtype == torch.bfloat16
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               atol=BF16_REL * float(jnp.abs(want).max()))


# --------------------------------------------------------------------------- #
# the Jamba hybrid
# --------------------------------------------------------------------------- #
def _carried(seed=0, act="float32"):
    rcfg = dataclasses.replace(RC.get_smoke_config(ARCH),
                               activation_dtype=act)
    tcfg = dataclasses.replace(TC.get_smoke_config(ARCH),
                               activation_dtype=act)
    params = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return params, rcfg, model, tcfg


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_jamba_forward_matches_reference():
    params, rcfg, model, tcfg = _carried(0)
    assert [s.mixer for s in tcfg.layer_pattern()].count("mamba") == 7
    toks = _tokens(tcfg, 2, LONG)
    want, waux = RM.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    with torch.no_grad():
        got, gaux = TM.forward(model, {"tokens": torch.from_numpy(toks)},
                               tcfg)
    assert got.shape == (2, LONG, tcfg.vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)
    assert float(gaux["moe_dropped"]) == float(waux["moe_dropped"])


def test_jamba_prefill_decode_and_greedy_tokens_match_reference():
    """A 600-token prefill, then greedy decode steps fed each package's own
    tokens: logits within 1e-4 at every step, identical tokens, and the
    caches (Mamba ``conv`` / ``h`` and the attention layer's keys and
    values) within 1e-4, the model's tolerance (a layer's state carries the
    rounding of the layers before it); the step builders serve the same
    tokens."""
    params, rcfg, model, tcfg = _carried(1)
    toks = _tokens(tcfg, 2, LONG, seed=1)
    gen = 5
    max_len = LONG + gen
    want, rc = RM.prefill(params, {"tokens": jnp.asarray(toks)}, rcfg,
                          max_len)
    got, tc = TM.prefill(model, {"tokens": torch.from_numpy(toks)}, tcfg,
                         max_len)
    want_toks, got_toks = [], []
    for step in range(gen):
        if step:
            want, rc = RM.decode_step(
                params, rc, {"tokens": jnp.asarray(want_toks[-1])[:, None]},
                rcfg)
            got, tc = TM.decode_step(
                model, tc, {"tokens": torch.from_numpy(got_toks[-1])[:, None]},
                tcfg)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LOGIT_ATOL)
        want_toks.append(np.asarray(jnp.argmax(want[:, -1], axis=-1)))
        got_toks.append(TS._greedy(got).numpy())
        np.testing.assert_array_equal(got_toks[-1], want_toks[-1])
    pos = LONG + gen - 1
    assert [c["idx"] for c in tc] == [pos] * tcfg.n_layers
    for layer, (spec, c) in enumerate(zip(tcfg.layer_pattern(), tc)):
        ref = rc[layer][0]                 # the smoke config: 8 groups of 1
        assert int(ref["idx"][0]) == pos
        keys = ("conv", "h") if spec.mixer == "mamba" else ("k", "v")
        for k in keys:
            np.testing.assert_allclose(_np(c[k]), np.asarray(ref[k][0]),
                                       atol=LOGIT_ATOL,
                                       err_msg=f"{layer} {k}")

    def serve(prefill, step, model_, wrap):
        nxt, caches = prefill(model_, {"tokens": wrap(toks)})
        out = [np.asarray(nxt)]
        for _ in range(gen - 1):
            nxt, caches = step(model_, caches, {"tokens": nxt[:, None]})
            out.append(np.asarray(nxt))
        return np.stack(out, axis=1)

    ref_serve = serve(jax.jit(RS.make_prefill_step(rcfg, max_len)),
                      jax.jit(RS.make_serve_step(rcfg)), params, jnp.asarray)
    port_serve = serve(TS.make_prefill_step(tcfg, max_len),
                       TS.make_serve_step(tcfg), model, torch.from_numpy)
    np.testing.assert_array_equal(ref_serve, np.stack(want_toks, axis=1))
    np.testing.assert_array_equal(port_serve, ref_serve)


def test_jamba_own_decode_matches_own_forward():
    """The port's seeded init, decode against forward over the same prefix
    (the reference's ``test_decode_matches_forward``); layer 0 is a Mamba
    layer, so the positions come from a Mamba cache's ``idx``."""
    cfg = TC.get_smoke_config(ARCH)
    assert cfg.layer_pattern()[0].mixer == "mamba"
    model = TM.init_model(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=5))
    with torch.no_grad():
        full, _ = TM.forward(model, {"tokens": toks}, cfg)
    P = 11
    lg, caches = TM.prefill(model, {"tokens": toks[:, :P]}, cfg, 16)
    errs = [float((lg[:, -1] - full[:, P - 1]).abs().max())]
    for t in range(P, 16):
        assert caches[0]["idx"] == t
        lg, caches = TM.decode_step(model, caches,
                                    {"tokens": toks[:, t:t + 1]}, cfg)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < SELF_DECODE_ATOL, errs


def test_bf16_prefill_cache_has_the_reference_dtypes():
    """bf16 activations on float32 weights, a 600-token prefill: every
    Mamba layer's ``h`` and ``conv`` are bfloat16 in both packages; layer
    0's agree within 8 bf16 ulps of the largest, and every layer's is as
    close to the float32 prefill's as the reference's is (rms, within a
    factor of 2; the float32 caches agree within 1e-4, tested above)."""
    params, rcfg, model, tcfg = _carried(2, act="bfloat16")
    _, _, model32, f32 = _carried(2, act="float32")
    toks = _tokens(tcfg, 2, LONG, seed=2)
    _, rc = RM.prefill(params, {"tokens": jnp.asarray(toks)}, rcfg,
                       LONG + 4)
    _, tc = TM.prefill(model, {"tokens": torch.from_numpy(toks)}, tcfg,
                       LONG + 4)
    _, fc = TM.prefill(model32, {"tokens": torch.from_numpy(toks)}, f32,
                       LONG + 4)
    n = 0
    for layer, (spec, c) in enumerate(zip(tcfg.layer_pattern(), tc)):
        if spec.mixer != "mamba":
            continue
        n += 1
        for k in ("h", "conv"):
            ref = rc[layer][0][k][0]
            assert ref.dtype == jnp.bfloat16, (layer, k)
            assert c[k].dtype == torch.bfloat16, (layer, k)
            want, got = np.asarray(ref.astype(jnp.float32)), _np(c[k])
            if layer == 0:
                np.testing.assert_allclose(
                    got, want, atol=BF16_REL * np.abs(want).max(),
                    err_msg=f"{layer} {k}")
            exact = _np(fc[layer][k])

            def rms(a):
                return float(np.sqrt(np.mean((a - exact) ** 2)))

            assert rms(got) <= 2 * rms(want), (layer, k, rms(got), rms(want))
    assert n == 7


def test_cache_allocator_follows_the_reference_shapes():
    cfg = dataclasses.replace(TC.get_smoke_config(ARCH),
                              activation_dtype="bfloat16")
    rcfg = dataclasses.replace(RC.get_smoke_config(ARCH),
                               activation_dtype="bfloat16")
    caches = TM.init_cache(cfg, 3, 40, device="cpu")
    ref = RM.init_cache(rcfg, 3, 40)
    for layer, (spec, c) in enumerate(zip(cfg.layer_pattern(), caches)):
        want = ref[layer][0]
        assert set(c) == set(want) and c["idx"] == 0
        for k, t in c.items():
            if k == "idx":
                continue
            assert t.shape == want[k].shape[1:], (layer, k)
            assert str(t.dtype).removeprefix("torch.") == str(
                want[k].dtype), (layer, k)
        if spec.mixer == "mamba":
            assert c["h"].dtype == torch.float32
            assert c["conv"].dtype == torch.bfloat16


def test_a_log_and_d_stay_float32_in_a_bf16_model():
    cfg = dataclasses.replace(TC.get_smoke_config(ARCH),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    model = TM.init_model(cfg, seed=0, device="cpu")
    n, di = cfg.mamba.d_state, int(cfg.mamba.expand * cfg.d_model)
    mixers = [blk.mixer for blk in model.blocks
              if isinstance(blk.mixer, Tssm.Mamba)]
    assert len(mixers) == 7
    for m in mixers:
        for name, p in m.named_parameters():
            want = torch.float32 if name in ("A_log", "D") else torch.bfloat16
            assert p.dtype == want, name
        np.testing.assert_allclose(
            m.A_log.detach().numpy(),
            np.log(np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                                   (di, n))), rtol=1e-7)
        assert bool((m.D == 1).all()) and m.dt_proj.shape == (3, di)
    rcfg = dataclasses.replace(RC.get_smoke_config(ARCH),
                               param_dtype="bfloat16",
                               activation_dtype="bfloat16")
    ref = jax.eval_shape(lambda: RM.init_model(jax.random.PRNGKey(0), rcfg))
    rm = ref["blocks"][0][0]["mixer"]
    assert rm["A_log"].dtype == rm["D"].dtype == jnp.float32
    assert rm["in_proj"].dtype == jnp.bfloat16
    assert {k: v.shape[1:] for k, v in rm.items()} == {
        k: tuple(p.shape) for k, p in mixers[0].named_parameters()}


def test_carried_weights_across_repeated_jamba_blocks():
    """The full config's layout: one scan group of the 8-layer Jamba block
    repeated (here twice, at the smoke width), whose repeat ``r`` of
    position ``i`` is the port's layer ``8 r + i``; forward and a prefill
    plus two decode steps within 1e-4 of the reference."""
    from repro.configs.jamba_v01_52b import _pattern as ref_pattern
    from repro_torch.configs.jamba_v01_52b import _pattern
    rcfg = dataclasses.replace(RC.get_smoke_config(ARCH), n_layers=16,
                               pattern=ref_pattern(16))
    tcfg = dataclasses.replace(TC.get_smoke_config(ARCH), n_layers=16,
                               pattern=_pattern(16))
    assert [n for _, n in rcfg.scan_groups()] == [2]
    params = RM.init_model(jax.random.PRNGKey(6), rcfg)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    toks = _tokens(tcfg, 2, 12, seed=6)
    want, _ = RM.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    with torch.no_grad():
        got, _ = TM.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)
    want, rc = RM.prefill(params, {"tokens": jnp.asarray(toks[:, :10])},
                          rcfg, 12)
    got, tc = TM.prefill(model, {"tokens": torch.from_numpy(toks[:, :10])},
                         tcfg, 12)
    for t in (10, 11):
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LOGIT_ATOL)
        want, rc = RM.decode_step(
            params, rc, {"tokens": jnp.asarray(toks[:, t:t + 1])}, rcfg)
        got, tc = TM.decode_step(
            model, tc, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)
    np.testing.assert_allclose(_np(tc[13]["h"]),
                               np.asarray(rc[0][5]["h"][1]), atol=LOGIT_ATOL)


@pytest.mark.parametrize("fault", ["missing", "misshaped"])
def test_carried_mamba_tree_must_match_every_parameter(fault):
    rcfg, tcfg = RC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray,
                        RM.init_model(jax.random.PRNGKey(0), rcfg))
    mixer = tree["blocks"][3][0]["mixer"]
    if fault == "missing":
        del mixer["dt_bias"]
    else:
        mixer["x_proj"] = mixer["x_proj"][..., :-1]
    with pytest.raises(RuntimeError, match="dt_bias|x_proj"):
        model_params_from_numpy(tree, tcfg, device="cpu")
