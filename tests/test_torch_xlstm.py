"""The xLSTM cells: the port's ``MLSTM`` / ``SLSTM`` (``repro_torch.models.
ssm``) and the ``xlstm_350m`` smoke config against the JAX package's on the
same numpy inputs and carried weights.

Tolerances (float32 on the CPU). The sLSTM is held to ``LAYER_ATOL`` =
1e-5. The mLSTM is held to ``LAYER_ATOL`` scaled by how far the
reference's own float32 arithmetic can pin each value down (``_mlstm_tol``):

- ``h = Σ_s sc[t,s]·v[s] / max(|Σ_s sc[t,s]|, exp(-m))`` sums terms of
  both signs and divides by a sum that may nearly cancel, so its rounding
  is relative to ``M = (Σ_s |sc|·|v| + |h|·Σ_s |sc|) / den``, not to
  ``|h|`` (the bound of any float sum; the graph engine's sums are held
  to 1e-5 of ``Σ |terms|`` likewise);
- every decay weight is ``exp(a[t] - a[s] + i[s])`` with ``a`` the prefix
  sum of the log forget gates, which reaches ``|a| ≈ 0.7·S`` (350 at 500
  tokens, where a float32 ulp is 3.05e-5), so the reference knows each
  exponent only to about two ulps of ``max |a|``, and so does any float32
  port: the two packages' gate projections add in another order and differ
  by an ulp, which the prefix sum carries.

So an mLSTM value is held within ``(LAYER_ATOL + 2·ulp(max |a|)) ·
max(1, M)`` elementwise, ``M`` computed in float64 by the test from the
same inputs (for the layer's output ``y``, ``M·|og|`` through ``|wo|``);
the log stabilizer ``m`` within ``LAYER_ATOL + 2·ulp(max |a|)``. At 9
tokens that is 1e-5 on a well-conditioned value; at 600 tokens the
reference and the port each sit up to ~1e-4 from a float64 evaluation,
and a raw 1e-5 between them cannot hold. ``_cumsum`` adds in the
reference's order, so with the same gate inputs ``a`` agrees bit for bit.

The model: ``forward``, ``prefill`` and ``decode_step`` logits within
``LOGIT_ATOL`` = 1e-4 of the reference, greedy tokens equal; the port's
own decode against its own forward within 5e-4 (the reference's bound,
``tests/test_archs.py``). bfloat16 is held to bounds, not bits
(``BF16_REL`` of the largest output, 8 bf16 ulps), and the bf16 rounding
of the float32-stored leaves (``wi``, ``wf``, ``b``) is held exactly where
it alone decides a value."""
import dataclasses
import math

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

ARCH = "xlstm_350m"
LAYER_ATOL = 1e-5
LOGIT_ATOL = 1e-4
SELF_DECODE_ATOL = 5e-4
BF16_REL = 2.0 ** -5
LENGTHS = [511, 512, 513, 600]      # either side of the chunk of 512


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.float() if x.dtype == torch.bfloat16 else x
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cfgs(act="float32", **kw):
    rcfg = dataclasses.replace(RC.get_smoke_config(ARCH),
                               activation_dtype=act, **kw)
    tcfg = dataclasses.replace(TC.get_smoke_config(ARCH),
                               activation_dtype=act, **kw)
    return rcfg, tcfg


# --------------------------------------------------------------------------- #
# the float64 magnitudes that scale the mLSTM bound
# --------------------------------------------------------------------------- #
def _log_sigmoid(x):
    return -np.logaddexp(0.0, -x)


def _gates(params, x):
    """float64 q, k, v, og, i_pre, f_pre of the mixer on ``x`` [B,S,d]."""
    p = {k: np.asarray(_np(v), np.float64) for k, v in params.items()}
    x = np.asarray(x, np.float64)
    dh = p["wq"].shape[-1]
    q = np.einsum("bsd,dhk->bshk", x, p["wq"]) / math.sqrt(dh)
    k = np.einsum("bsd,dhk->bshk", x, p["wk"]) / math.sqrt(dh)
    v = np.einsum("bsd,dhk->bshk", x, p["wv"])
    og = 1 / (1 + np.exp(-np.einsum("bsd,dhk->bshk", x, p["og"])))
    return q, k, v, og, x @ p["wi"], x @ p["wf"]


def _magnitude(q, k, v, i_pre, f_pre):
    """float64 (M [B,S,H,dh], max |a|) of the parallel form: per element,
    the magnitudes of the terms of numerator and denominator over the
    denominator (``_mlstm_tol``'s ``M``)."""
    a = np.cumsum(_log_sigmoid(f_pre), axis=1)
    S = q.shape[1]
    logD = a[:, :, None] - a[:, None] + i_pre[:, None]
    logD = np.where(np.tril(np.ones((S, S), bool))[None, :, :, None], logD,
                    -np.inf)
    m = logD.max(axis=2, keepdims=True)
    sc = np.einsum("bthk,bshk->btsh", q, k) * np.exp(logD - m)
    den = np.maximum(np.abs(sc.sum(2)), np.exp(-m[:, :, 0]))
    h = np.einsum("btsh,bshk->bthk", sc, v) / den[..., None]
    sc = np.abs(sc)
    M = (np.einsum("btsh,bshk->bthk", sc, np.abs(v))
         + np.abs(h) * sc.sum(2)[..., None]) / den[..., None]
    return M, float(np.abs(a).max())


def _fold_magnitude(k, v, i_pre, f_pre):
    """float64 magnitudes of the state a prefill folds ``k``, ``v`` into:
    (Σ_s w|k||v| [B,H,dh,dh], Σ_s w|k| [B,H,dh]), w = exp(w_s - m_fin)."""
    a = np.cumsum(_log_sigmoid(f_pre), axis=1)
    w = a[:, -1:] - a + i_pre
    wt = np.exp(w - w.max(axis=1, keepdims=True))
    return (np.einsum("bsh,bshk,bshl->bhkl", wt, np.abs(k), np.abs(v)),
            np.einsum("bsh,bshk->bhk", wt, np.abs(k)))


def _ulp2(a_max: float) -> float:
    return 2 * float(np.spacing(np.float32(a_max)))


def _mlstm_tol(M, a_max):
    return (LAYER_ATOL + _ulp2(a_max)) * np.maximum(M, 1.0)


def _close(got, want, tol, what):
    err = np.abs(_np(got) - np.asarray(want, np.float64))
    worst = np.unravel_index(np.argmax(err - tol), err.shape)
    tol = np.broadcast_to(tol, err.shape)
    assert bool((err <= tol).all()), (
        f"{what}: |err| {err[worst]:.3g} > tol {tol[worst]:.3g} at {worst} "
        f"(max err {err.max():.3g})")


# --------------------------------------------------------------------------- #
# the chunkwise form
# --------------------------------------------------------------------------- #
def _cell_inputs(S, seed, B=2, H=2, dh=8):
    """The reference test's distributions (``test_longcontext_paths``),
    drawn with numpy: forget gates near one (pre-activations ~ N(2, 1))."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, S, H, dh), 1 / math.sqrt(dh))
    k = _normal(rng, (B, S, H, dh), 1 / math.sqrt(dh))
    v = _normal(rng, (B, S, H, dh))
    ip = _normal(rng, (B, S, H))
    fp = _normal(rng, (B, S, H)) + np.float32(2.0)
    return q, k, v, ip, fp


@settings(max_examples=6, deadline=None)
@given(st.integers(80, 700), st.integers(0, 4), st.sampled_from([64, 512]))
def test_mlstm_chunked_matches_reference(S, seed, chunk):
    """``_mlstm_chunked`` on the same inputs: h within ``_mlstm_tol``; the
    final state (C, n, m) within the bounds of a prefill's fold."""
    args = _cell_inputs(S, seed)
    h_ref, st_ref = Rssm._mlstm_chunked(*map(jnp.asarray, args), chunk=chunk)
    h, state = Tssm._mlstm_chunked(*map(torch.from_numpy, args), chunk=chunk)
    assert h.shape == h_ref.shape and h.dtype == torch.float32
    M, a_max = _magnitude(*(np.asarray(x, np.float64) for x in args))
    _close(h, h_ref, _mlstm_tol(M, a_max), "h")
    MC, Mn = _fold_magnitude(*(np.asarray(x, np.float64)
                               for x in args[1:]))
    for name, got, want, mag in zip("Cnm", state, st_ref,
                                    (MC, Mn, np.zeros(1))):
        assert got.dtype == torch.float32, name
        _close(got, want, _mlstm_tol(mag, a_max), name)


def test_mlstm_chunked_pads_with_the_reference_sentinels():
    """A length that is not a multiple of the chunk: the padded positions
    (``i_pre`` -1e30, ``log_sigmoid(f)`` 0) add nothing to the state, so
    the state equals the one of the unpadded prefix run in one chunk."""
    q, k, v, ip, fp = (torch.from_numpy(x) for x in _cell_inputs(100, 7))
    h1, s1 = Tssm._mlstm_chunked(q, k, v, ip, fp, chunk=64)
    h2, s2 = Tssm._mlstm_chunked(q, k, v, ip, fp, chunk=100)
    np.testing.assert_allclose(_np(h1), _np(h2), atol=1e-5)
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 9, 16, 17, 256, 512, 600, 4111])
def test_prefix_sum_adds_in_the_reference_order(n):
    x = -np.abs(_normal(np.random.default_rng(n), (2, n, 3))) - 0.1
    np.testing.assert_array_equal(
        Tssm._cumsum(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


# --------------------------------------------------------------------------- #
# the mLSTM mixer
# --------------------------------------------------------------------------- #
def _mlstm(seed=0, act="float32"):
    """(reference cfg, port cfg, port MLSTM, its params as jnp arrays)."""
    rcfg, tcfg = _cfgs(act)
    mod = Tssm.MLSTM(tcfg, dtype=torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    return rcfg, tcfg, mod, {n: jnp.asarray(_np(p))
                             for n, p in mod.named_parameters()}


def _ref_cache(shapes):
    return {k: jnp.zeros(v.shape, v.dtype) for k, v in shapes.items()}


def _apply(mod, x, dtype=None, cache=None):
    with torch.no_grad():
        return mod(torch.from_numpy(x) if isinstance(x, np.ndarray) else x,
                   cache=cache, dtype=dtype)


class _Spy:
    """Counts the calls of a module's ``_mlstm_chunked``."""

    def __init__(self, monkeypatch, module):
        self.calls = 0
        fn = module._mlstm_chunked

        def spy(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, "_mlstm_chunked", spy)


def _y_tol(p, x, span):
    """``_mlstm_tol`` of the layer output at positions ``span`` of the
    sequence ``x``: the parallel form's M over every earlier position,
    times |og|, through |wo|."""
    q, k, v, og, ip, fp = _gates(p, x[:, :span.stop])
    M, a_max = _magnitude(q, k, v, ip, fp)
    wo = np.abs(np.asarray(_np(p["wo"]), np.float64)).reshape(
        -1, x.shape[-1])
    My = (M * og).reshape(M.shape[0], M.shape[1], -1) @ wo
    return _mlstm_tol(My[:, span], a_max), a_max


@pytest.mark.parametrize("S", [9] + LENGTHS)
def test_mlstm_forward_matches_reference(S, monkeypatch):
    """No cache: the fully parallel form up to 512 tokens, the chunkwise
    form past it, in both packages alike."""
    rcfg, _, mod, p = _mlstm(1)
    x = _normal(np.random.default_rng(S), (2, S, rcfg.d_model))
    spies = [_Spy(monkeypatch, m) for m in (Rssm, Tssm)]
    want, wc = Rssm.mlstm_apply(p, jnp.asarray(x), rcfg)
    got, gc = _apply(mod, x)
    assert wc is None and gc is None
    assert spies[0].calls == spies[1].calls == int(S > 512)
    tol, _ = _y_tol(p, x, slice(0, S))
    _close(got, want, tol, f"y at S={S}")


@pytest.mark.parametrize("S", [1, 2, 9] + LENGTHS)
def test_mlstm_prefill_and_decode_match_reference(S, monkeypatch):
    """A prefill of ``S`` tokens on a zeroed cache (one token takes the
    recurrence from the fresh state, ``idx == 0``; up to 512 the parallel
    form folds the prompt into the state; past 512 the chunkwise form),
    then three recurrence steps: the output and every cache leaf after each
    call, float32 throughout."""
    rcfg, tcfg, mod, p = _mlstm(2)
    x = _normal(np.random.default_rng(S + 1), (2, S + 3, tcfg.d_model))
    spies = [_Spy(monkeypatch, m) for m in (Rssm, Tssm)]
    rc = _ref_cache(Rssm.mlstm_cache_shape(rcfg, 2, jnp.float32))
    tc = Tssm.mlstm_cache_shape(tcfg, 2, device="cpu")
    for lo, hi in [(0, S), (S, S + 1), (S + 1, S + 2), (S + 2, S + 3)]:
        want, rc = Rssm.mlstm_apply(p, jnp.asarray(x[:, lo:hi]), rcfg,
                                    cache=rc)
        got, tc = _apply(mod, x[:, lo:hi], cache=tc)
        tol, a_max = _y_tol(p, x, slice(lo, hi))
        _close(got, want, tol, f"y {lo}:{hi}")
        assert tc["idx"] == int(rc["idx"]) == hi
        q, k, v, _, ip, fp = _gates(p, x[:, :hi])
        MC, Mn = _fold_magnitude(k, v, ip, fp)
        for key, mag in (("C", MC), ("n", Mn), ("m", np.zeros(1))):
            assert tc[key].shape == rc[key].shape, key
            assert tc[key].dtype == torch.float32, key
            _close(tc[key], rc[key], _mlstm_tol(mag, a_max),
                   f"{key} after {lo}:{hi}")
    assert spies[0].calls == spies[1].calls == int(S > 512)


def test_cache_holds_no_view_of_the_prefill():
    """The state a prefill hands over owns its storage: no view that keeps
    the [B, S, S, H] decay matrix or a chunk's intermediates alive."""
    _, tcfg, mod, _ = _mlstm(3)
    for S in (40, 600):
        x = _normal(np.random.default_rng(S), (1, S, tcfg.d_model))
        _, c = _apply(mod, x, cache=Tssm.mlstm_cache_shape(tcfg, 1,
                                                           device="cpu"))
        for key in "Cnm":
            t = c[key]
            assert t.untyped_storage().nbytes() == t.numel() * 4, (S, key)


def test_bf16_mlstm_follows_reference():
    """bf16 activations: every form within ``BF16_REL`` of the reference's
    largest output, the outputs bf16 and the state float32 in both
    packages. ``wi`` is stored float32 and used bf16-rounded, promoted
    against float32 activations: after one token from a fresh cache ``m``
    is that token's ``i_pre`` exactly, so it must equal the reference's to
    float32 rounding (a port that skipped the rounding is off by ~2^-9 of
    it)."""
    rcfg, tcfg, mod, p = _mlstm(4, act="bfloat16")
    pb = {k: v.astype(jnp.bfloat16) for k, v in p.items()}
    bf = torch.bfloat16
    for S in (9, 600):
        x = _normal(np.random.default_rng(S), (2, S + 2, tcfg.d_model))
        xb = torch.from_numpy(x).to(bf)
        xj = jnp.asarray(x, jnp.bfloat16)
        want, _ = Rssm.mlstm_apply(pb, xj[:, :S], rcfg)
        got, _ = _apply(mod, xb[:, :S], bf)
        assert want.dtype == jnp.bfloat16 and got.dtype == bf
        scale = float(jnp.abs(want.astype(jnp.float32)).max())
        _close(got, want, BF16_REL * scale, f"bf16 forward S={S}")
        rc = _ref_cache(Rssm.mlstm_cache_shape(rcfg, 2, jnp.bfloat16))
        tc = Tssm.mlstm_cache_shape(tcfg, 2, bf, device="cpu")
        for lo, hi in [(0, S), (S, S + 1), (S + 1, S + 2)]:
            want, rc = Rssm.mlstm_apply(pb, xj[:, lo:hi], rcfg, cache=rc)
            got, tc = _apply(mod, xb[:, lo:hi], bf, cache=tc)
            assert want.dtype == jnp.bfloat16 and got.dtype == bf
            scale = float(jnp.abs(want.astype(jnp.float32)).max())
            _close(got, want, BF16_REL * scale, f"bf16 {lo}:{hi}")
            for key in "Cnm":
                assert rc[key].dtype == jnp.float32, key
                assert tc[key].dtype == torch.float32, key
    rc = _ref_cache(Rssm.mlstm_cache_shape(rcfg, 2, jnp.bfloat16))
    _, rc = Rssm.mlstm_apply(pb, xj[:, :1], rcfg, cache=rc)
    _, tc = _apply(mod, xb[:, :1], bf,
                   cache=Tssm.mlstm_cache_shape(tcfg, 2, bf, device="cpu"))
    exact = xb[:, 0].float() @ mod.wi.detach()     # wi not rounded
    assert float((exact - tc["m"]).abs().max()) > 1e-4
    np.testing.assert_allclose(_np(tc["m"]), np.asarray(rc["m"]),
                               atol=LAYER_ATOL)


# --------------------------------------------------------------------------- #
# the sLSTM mixer
# --------------------------------------------------------------------------- #
def _slstm(seed=0, act="float32"):
    rcfg, tcfg = _cfgs(act)
    mod = Tssm.SLSTM(tcfg, dtype=torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():     # a bias not zero, so the leaf counts
        mod.b.normal_(generator=torch.Generator().manual_seed(seed))
    return rcfg, tcfg, mod, {n: jnp.asarray(_np(p))
                             for n, p in mod.named_parameters()}


@pytest.mark.parametrize("S", [1, 40, 600])
def test_slstm_matches_reference(S):
    """The whole sequence from the zero state; then as a prefill of ``S``
    tokens and three decode steps, every cache leaf after each call."""
    rcfg, tcfg, mod, p = _slstm(1)
    x = _normal(np.random.default_rng(S), (2, S + 3, tcfg.d_model))
    want, wc = Rssm.slstm_apply(p, jnp.asarray(x[:, :S]), rcfg)
    got, gc = _apply(mod, x[:, :S])
    assert wc is None and gc is None and got.shape == (2, S, tcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    rc = _ref_cache(Rssm.slstm_cache_shape(rcfg, 2, jnp.float32))
    tc = Tssm.slstm_cache_shape(tcfg, 2, torch.float32, device="cpu")
    for lo, hi in [(0, S), (S, S + 1), (S + 1, S + 2), (S + 2, S + 3)]:
        want, rc = Rssm.slstm_apply(p, jnp.asarray(x[:, lo:hi]), rcfg,
                                    cache=rc)
        got, tc = _apply(mod, x[:, lo:hi], cache=tc)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LAYER_ATOL, err_msg=f"{lo}:{hi}")
        assert tc["idx"] == int(rc["idx"]) == hi
        for key in "hcnm":
            np.testing.assert_allclose(_np(tc[key]), np.asarray(rc[key]),
                                       atol=LAYER_ATOL,
                                       err_msg=f"{key} {lo}:{hi}")


def test_bf16_slstm_follows_reference():
    """bf16: the carried ``h`` (and the cache's) in bf16, ``c``, ``n``, ``m``
    float32, the output bf16, within ``BF16_REL``. ``b`` is stored float32
    and used bf16-rounded: with a zero input and state the gates are ``b``
    alone, so the first step's ``c = tanh(z)``, ``n`` and ``m = i`` must
    equal the reference's to float32 rounding."""
    rcfg, tcfg, mod, p = _slstm(2, act="bfloat16")
    pb = {k: v.astype(jnp.bfloat16) for k, v in p.items()}
    bf = torch.bfloat16
    x = _normal(np.random.default_rng(2), (2, 33, tcfg.d_model))
    xb, xj = torch.from_numpy(x).to(bf), jnp.asarray(x, jnp.bfloat16)
    rc = _ref_cache(Rssm.slstm_cache_shape(rcfg, 2, jnp.bfloat16))
    tc = Tssm.slstm_cache_shape(tcfg, 2, bf, device="cpu")
    for lo, hi in [(0, 30), (30, 31), (31, 32), (32, 33)]:
        want, rc = Rssm.slstm_apply(pb, xj[:, lo:hi], rcfg, cache=rc)
        got, tc = _apply(mod, xb[:, lo:hi], bf, cache=tc)
        assert want.dtype == jnp.bfloat16 and got.dtype == bf
        scale = float(jnp.abs(want.astype(jnp.float32)).max())
        _close(got, want, BF16_REL * scale, f"bf16 {lo}:{hi}")
        assert rc["h"].dtype == jnp.bfloat16 and tc["h"].dtype == bf
        for key in "cnm":
            assert rc[key].dtype == jnp.float32, key
            assert tc[key].dtype == torch.float32, key
    zero = np.zeros((2, 1, tcfg.d_model), np.float32)
    _, rc = Rssm.slstm_apply(pb, jnp.asarray(zero, jnp.bfloat16), rcfg,
                             cache=_ref_cache(Rssm.slstm_cache_shape(
                                 rcfg, 2, jnp.bfloat16)))
    _, tc = _apply(mod, torch.from_numpy(zero).to(bf), bf,
                   cache=Tssm.slstm_cache_shape(tcfg, 2, bf, device="cpu"))
    d = tcfg.d_model
    assert float((mod.b.detach()[:d] - tc["m"]).abs().max()) > 1e-4
    for key in "cnm":
        np.testing.assert_allclose(_np(tc[key]), np.asarray(rc[key]),
                                   atol=1e-6, err_msg=key)


# --------------------------------------------------------------------------- #
# the xLSTM model
# --------------------------------------------------------------------------- #
def _carried(seed=0, act="float32", **kw):
    rcfg, tcfg = _cfgs(act, **kw)
    params = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return params, rcfg, model, tcfg


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_xlstm_blocks_have_no_mlp():
    """The 7:1 pattern of ``mlp="none"`` blocks: mLSTM and sLSTM mixers,
    no ``norm2`` and no ``mlp`` parameter, as the reference's tree."""
    params, _, model, tcfg = _carried(0)
    assert [type(b.mixer) for b in model.blocks] == [Tssm.MLSTM] * 7 + [
        Tssm.SLSTM]
    for blk in model.blocks:
        assert blk.mlp is None and blk.norm2 is None and blk.cross is None
        assert not any(n.startswith(("norm2", "mlp"))
                       for n, _ in blk.named_parameters())
    for group in params["blocks"]:
        assert set(group[0]) == {"norm1", "mixer"}


def test_xlstm_forward_matches_reference():
    params, rcfg, model, tcfg = _carried(0)
    toks = _tokens(tcfg, 2, 16)
    want, waux = RM.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    with torch.no_grad():
        got, gaux = TM.forward(model, {"tokens": torch.from_numpy(toks)},
                               tcfg)
    assert got.shape == (2, 16, tcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)
    assert float(gaux["moe_dropped"]) == float(waux["moe_dropped"]) == 0.0


def test_xlstm_prefill_decode_and_greedy_tokens_match_reference():
    """A 12-token prefill, then greedy decode steps fed each package's own
    tokens: logits within 1e-4 at every step, identical tokens, the caches
    within 1e-4 (the model's tolerance: a layer's state carries the rounding
    of the layers before it); the step builders serve the same tokens."""
    params, rcfg, model, tcfg = _carried(1)
    toks = _tokens(tcfg, 2, 12, seed=1)
    gen = 6
    max_len = toks.shape[1] + gen
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
                model, tc,
                {"tokens": torch.from_numpy(got_toks[-1])[:, None]}, tcfg)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LOGIT_ATOL)
        want_toks.append(np.asarray(jnp.argmax(want[:, -1], axis=-1)))
        got_toks.append(TS._greedy(got).numpy())
        np.testing.assert_array_equal(got_toks[-1], want_toks[-1])
    pos = toks.shape[1] + gen - 1
    assert [c["idx"] for c in tc] == [pos] * tcfg.n_layers
    groups = [(g, r) for g, (pat, n) in enumerate(rcfg.scan_groups())
              for r in range(n)]
    for layer, c in enumerate(tc):
        g, r = groups[layer]
        ref = rc[g][0]
        assert int(ref["idx"][r]) == pos
        for key, t in c.items():
            if key != "idx":
                np.testing.assert_allclose(_np(t), np.asarray(ref[key][r]),
                                           atol=LOGIT_ATOL,
                                           err_msg=f"{layer} {key}")

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


FLOOR_FACTOR = 2


def test_xlstm_long_prompt_takes_the_chunked_form(monkeypatch):
    """A 600-token prompt: ``forward`` and ``prefill`` run the chunkwise
    mLSTM in both packages; the forward's logits, the prefill's last ones
    and two decode steps' against the reference. Past 512 tokens the
    random-weight model amplifies float32 rounding beyond 1e-4 in the
    reference itself: moving every embedding by one ulp (random signs)
    moves its logits by 3.8e-4-6.4e-4. So, as phase 13 of ``chip_smoke.py``
    holds bf16 Jamba, the bound is max(1e-4, 2 x that one-ulp floor),
    measured here on the same tokens; greedy tokens equal wherever the
    reference's top-2 gap exceeds twice the bound."""
    params, rcfg, model, tcfg = _carried(2)
    toks = _tokens(tcfg, 1, 602, seed=2)
    ref_spy, spy = _Spy(monkeypatch, Rssm), _Spy(monkeypatch, Tssm)
    want, _ = RM.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    emb = np.asarray(params["embed"])
    up = np.random.default_rng(2).random(emb.shape) < 0.5
    moved = np.nextafter(emb, np.where(up, np.float32(np.inf),
                                       np.float32(-np.inf)))
    assert (moved != emb).all()
    want2, _ = RM.forward(dict(params, embed=jnp.asarray(moved)),
                          {"tokens": jnp.asarray(toks)}, rcfg)
    floor = float(jnp.abs(want2 - want).max())
    tol = max(LOGIT_ATOL, FLOOR_FACTOR * floor)
    with torch.no_grad():
        got, _ = TM.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol)
    full = np.asarray(want)
    got, tc = TM.prefill(model, {"tokens": torch.from_numpy(toks[:, :600])},
                         tcfg, 602)
    for t in (600, 601, 602):
        ref = full[:, t - 1:t]
        np.testing.assert_allclose(_np(got), ref, atol=tol, err_msg=str(t))
        top = np.sort(ref[:, -1], axis=-1)[:, -2:]
        if (top[:, 1] - top[:, 0] > 2 * tol).all():
            np.testing.assert_array_equal(TS._greedy(got).numpy(),
                                          ref[:, -1].argmax(-1))
        if t < 602:
            got, tc = TM.decode_step(
                model, tc, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                tcfg)
    assert tc[0]["idx"] == 602
    n_mlstm = [s_.mixer for s_ in tcfg.layer_pattern()].count("mlstm")
    assert ref_spy.calls > 0 and spy.calls == 2 * n_mlstm


def test_xlstm_own_decode_matches_own_forward():
    """The port's seeded init, decode against forward over the same prefix
    (the reference's ``test_decode_matches_forward``); the positions come
    from layer 0's mLSTM cache."""
    cfg = TC.get_smoke_config(ARCH)
    model = TM.init_model(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=5))
    with torch.no_grad():
        full, _ = TM.forward(model, {"tokens": toks}, cfg)
    P = 9
    lg, caches = TM.prefill(model, {"tokens": toks[:, :P]}, cfg, 16)
    errs = [float((lg[:, -1] - full[:, P - 1]).abs().max())]
    for t in range(P, 16):
        assert caches[0]["idx"] == t
        lg, caches = TM.decode_step(model, caches,
                                    {"tokens": toks[:, t:t + 1]}, cfg)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < SELF_DECODE_ATOL, errs


def test_bf16_prefill_cache_has_the_reference_dtypes():
    """bf16 activations on float32 weights: after a prefill (9 tokens, the
    parallel form; 600, the chunkwise one) and a decode step every mLSTM
    layer's C, n, m are float32 and every sLSTM layer's h bf16 beside
    float32 c, n, m, in both packages. The logits are bf16; a random-weight
    xLSTM amplifies bf16 rounding through its 8 layers (about 4% of the
    largest logit at 9 tokens, in the reference as in the port), so they
    are held as ``tests/test_torch_ssm.py`` holds bf16 Jamba: no further
    from the float32 run on the same weights (root mean square) than twice
    the reference's bf16 logits are."""
    params, rcfg, model, tcfg = _carried(3, act="bfloat16")
    _, _, model32, f32 = _carried(3, act="float32")
    for S in (9, 600):
        toks = _tokens(tcfg, 1, S + 1, seed=S)
        want, rc = RM.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                              rcfg, S + 1)
        got, tc = TM.prefill(model, {"tokens": torch.from_numpy(
            toks[:, :S])}, tcfg, S + 1)
        want, rc = RM.decode_step(params, rc,
                                  {"tokens": jnp.asarray(toks[:, S:])}, rcfg)
        got, tc = TM.decode_step(model, tc,
                                 {"tokens": torch.from_numpy(toks[:, S:])},
                                 tcfg)
        assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
        _, c32 = TM.prefill(model32, {"tokens": torch.from_numpy(
            toks[:, :S])}, f32, S + 1)
        exact, _ = TM.decode_step(model32, c32, {"tokens": torch.from_numpy(
            toks[:, S:])}, f32)

        def rms(a):
            return float(np.sqrt(np.mean((_np(a) - _np(exact)) ** 2)))

        assert rms(got) <= 2 * rms(want), (S, rms(got), rms(want))
        groups = [(g, r) for g, (pat, n) in enumerate(rcfg.scan_groups())
                  for r in range(n)]
        for layer, (spec, c) in enumerate(zip(tcfg.layer_pattern(), tc)):
            g, r = groups[layer]
            ref = rc[g][0]
            for key, t in c.items():
                if key == "idx":
                    continue
                assert str(t.dtype).removeprefix("torch.") == str(
                    ref[key].dtype), (S, layer, key)
                want_dt = (torch.bfloat16 if (spec.mixer, key) == (
                    "slstm", "h") else torch.float32)
                assert t.dtype == want_dt, (S, layer, key)


def test_cache_allocator_follows_the_reference_shapes():
    rcfg, tcfg = _cfgs("bfloat16")
    caches = TM.init_cache(tcfg, 3, 40, device="cpu")
    ref = RM.init_cache(rcfg, 3, 40)
    groups = [(g, r) for g, (pat, n) in enumerate(rcfg.scan_groups())
              for r in range(n)]
    for layer, c in enumerate(caches):
        want = ref[groups[layer][0]][0]
        assert set(c) == set(want) and c["idx"] == 0
        for k, t in c.items():
            if k != "idx":
                assert t.shape == want[k].shape[1:], (layer, k)
                assert str(t.dtype).removeprefix("torch.") == str(
                    want[k].dtype), (layer, k)


def test_gate_leaves_stay_float32_in_a_bf16_model():
    """``wi`` / ``wf`` (mLSTM) and ``b`` (sLSTM) are stored float32 beside
    bf16 weights, as the reference's ``init_mlstm`` / ``init_slstm``."""
    cfg = dataclasses.replace(TC.get_smoke_config(ARCH),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    model = TM.init_model(cfg, seed=0, device="cpu")
    rcfg = dataclasses.replace(RC.get_smoke_config(ARCH),
                               param_dtype="bfloat16",
                               activation_dtype="bfloat16")
    ref = jax.eval_shape(lambda: RM.init_model(jax.random.PRNGKey(0), rcfg))
    f32 = {"wi", "wf", "b"}
    for blk in model.blocks:
        for name, p in blk.mixer.named_parameters():
            want = torch.float32 if name in f32 else torch.bfloat16
            assert p.dtype == want, name
    for group in ref["blocks"]:
        for name, leaf in group[0]["mixer"].items():
            assert (leaf.dtype == jnp.float32) == (name in f32), name
    mixers = {type(b.mixer): b.mixer for b in model.blocks}
    for g, kind in ((0, Tssm.MLSTM), (1, Tssm.SLSTM)):
        rm = ref["blocks"][g][0]["mixer"]
        assert {k: v.shape[1:] for k, v in rm.items()} == {
            k: tuple(p.shape) for k, p in mixers[kind].named_parameters()}
    assert float(model.blocks[7].mixer.b.abs().max()) == 0.0


def test_carried_weights_across_repeated_xlstm_blocks():
    """The full config's layout: one scan group of the 8-layer xLSTM block
    repeated (here twice, at the smoke width), whose repeat ``r`` of
    position ``i`` is the port's layer ``8 r + i``; forward and a prefill
    plus two decode steps within 1e-4 of the reference."""
    from repro.configs.xlstm_350m import _pattern as ref_pattern
    from repro_torch.configs.xlstm_350m import _pattern
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
    np.testing.assert_allclose(_np(tc[15]["h"]),
                               np.asarray(rc[0][7]["h"][1]), atol=LOGIT_ATOL)


@pytest.mark.parametrize("fault", ["missing", "misshaped", "extra_mlp"])
def test_carried_xlstm_tree_must_match_every_parameter(fault):
    """The strict load on the xLSTM leaves: a missing or misshaped mixer
    leaf, or an MLP on a block whose spec has none, fails it."""
    rcfg, tcfg = RC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray,
                        RM.init_model(jax.random.PRNGKey(0), rcfg))
    mixer = tree["blocks"][0][0]["mixer"]
    if fault == "missing":
        del mixer["wf"]
        match = "wf"
    elif fault == "misshaped":
        tree["blocks"][1][0]["mixer"]["r"] = \
            tree["blocks"][1][0]["mixer"]["r"][..., :-1]
        match = "mixer.r"
    else:
        n = len(mixer["wq"])
        tree["blocks"][0][0]["norm2"] = {
            "scale": np.ones((n, tcfg.d_model), np.float32),
            "bias": np.zeros((n, tcfg.d_model), np.float32)}
        match = "norm2"
    with pytest.raises(RuntimeError, match=match):
        model_params_from_numpy(tree, tcfg, device="cpu")


@settings(max_examples=6, deadline=None)
@given(st.integers(80, 400), st.integers(0, 4))
def test_chunked_matches_parallel(S, seed):
    """The reference's ``test_mlstm_chunked_matches_parallel`` on the port:
    ``_mlstm_chunked`` (chunk 64) against ``_mlstm_parallel``, within its
    5e-4."""
    args = [torch.from_numpy(a) for a in _cell_inputs(S, seed)]
    h_par, _ = Tssm._mlstm_parallel(*args)
    h_ch, _ = Tssm._mlstm_chunked(*args, chunk=64)
    np.testing.assert_allclose(_np(h_ch), _np(h_par), atol=5e-4)
