"""MoE parity: the port's ``repro_torch.models.moe`` and the MoE models
(``phi35_moe_42b``, ``deepseek_v3_671b`` smoke configs) against the JAX
package's on the same numpy inputs and carried weights.

Tolerances (float32 on the CPU): the MoE layer 1e-5; ``forward``,
``prefill`` and ``decode_step`` logits 1e-4 against the reference; the
port's own decode against its own forward 5e-4 (the reference's bound,
``tests/test_archs.py``). Expert picks, kept pairs, loads and the dropped
share are compared exactly, against the reference's compiled
``moe_apply`` (``jax.jit``, as ``forward`` runs it inside its scan): XLA
divides the load by a multiply with the reciprocal and fuses
``1 - keep.mean()`` into one multiply-add, where the eager reference
rounds each op. bfloat16:
outputs within 2 bf16 ulps of the largest output (2 ** -7 of it); the
reference's XLA fuses the expert SwiGLU and rounds once where the port
rounds per op, about one ulp apart."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypcompat import given, settings, st

import repro.configs as RC
import repro.models.model as RM
import repro.models.moe as Rmoe
import repro_torch.configs as TC
import repro_torch.models.model as TM
import repro_torch.models.moe as Tmoe
from repro_torch.interop import model_params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
MOE = ["phi35_moe_42b", "deepseek_v3_671b"]
LAYER_ATOL = 1e-5
LOGIT_ATOL = 1e-4
SELF_DECODE_ATOL = 5e-4
BF16_REL = 2.0 ** -7


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _cfgs(arch, **moe):
    """(reference cfg, port cfg) of ``arch``'s smoke config, its MoE fields
    replaced by ``moe``."""
    out = []
    for get in (RC.get_smoke_config, TC.get_smoke_config):
        c = get(arch)
        out.append(dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, **moe)))
    return out


def _carried_moe(rcfg, tcfg, seed=0, bias=None):
    """(reference params, port ``MoE`` holding them)."""
    p = Rmoe.init_moe(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    if bias is not None:
        p = dict(p, router_bias=jnp.asarray(bias))
    mod = Tmoe.MoE(tcfg, dtype=torch.float32, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in _flat(p)}, strict=True)
    return p, mod


def _x(cfg, B, S, seed, scale=1.0, skew=0.0):
    """Seeded tokens; ``skew`` adds one shared direction to every token,
    so the router sends most of them to the same experts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)) * scale
    return (x + skew * rng.standard_normal(cfg.d_model)).astype(np.float32)


def _ref(p, x, cfg):
    return jax.jit(lambda p, x: Rmoe.moe_apply(p, x, cfg))(p, jnp.asarray(x))


def _ref_keep(p, x, cfg):
    """The reference's kept (token, expert) pairs, from its own router and
    top-k, sorted and capped in numpy as ``moe.py:87-96`` does."""
    m = cfg.moe
    T, E, k = x.shape[0] * x.shape[1], m.n_experts, m.top_k
    probs = jax.nn.softmax(jnp.asarray(x).reshape(T, -1) @ p["router"], -1)
    sel = probs + p["router_bias"] if m.router_aux_free_bias else probs
    _, idx = jax.lax.top_k(sel, k)
    flat = np.asarray(idx).reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    pos = np.arange(T * k) - np.searchsorted(se, np.arange(E))[se]
    cap = min(int(np.ceil(m.capacity_factor * T * k / E / 8.0) * 8), T * k)
    return pos < cap, np.asarray(idx)


def _params(mod):
    """The MoE module's parameters as ``moe_apply`` takes them."""
    params = dict(mod.named_parameters(recurse=False))
    if mod.shared is not None:
        params["shared"] = dict(mod.shared.named_parameters())
    return params


def _port(mod, x, dtype=None):
    with torch.no_grad():
        return mod(torch.from_numpy(x) if isinstance(x, np.ndarray) else x,
                   dtype)


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_reference(arch):
    """The smoke capacity (64: dropless)."""
    rcfg, tcfg = RC.get_smoke_config(arch), TC.get_smoke_config(arch)
    p, mod = _carried_moe(rcfg, tcfg, seed=1)
    x = _x(tcfg, 2, 9, seed=1)
    y, aux = _ref(p, x, rcfg)
    got, gaux = _port(mod, x)
    np.testing.assert_allclose(_np(got), np.asarray(y), atol=LAYER_ATOL)
    np.testing.assert_array_equal(_np(gaux["load"]), np.asarray(aux["load"]))
    assert gaux["dropped"].dtype == torch.float32
    assert float(gaux["dropped"]) == float(aux["dropped"])
    assert abs(float(aux["dropped"])) < 1e-6


@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_drops_match_reference(arch):
    """The published capacity 1.25 on 96 skewed tokens drops pairs: the
    same pairs are kept, the same loads and dropped share, outputs within
    1e-5."""
    cf = RC.get_config(arch).moe.capacity_factor
    rcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    p, mod = _carried_moe(rcfg, tcfg, seed=2)
    x = _x(tcfg, 3, 32, seed=2, skew=1.5)
    y, aux = _ref(p, x, rcfg)
    keep, idx = _ref_keep(p, x, rcfg)
    assert not keep.all()
    with torch.no_grad():
        got, load, gkeep = Tmoe._moe_apply_grouped(
            _params(mod), torch.from_numpy(x), tcfg, 1)
    np.testing.assert_array_equal(_np(gkeep), keep)
    _, gaux = _port(mod, x)
    assert float(gaux["dropped"]) == float(aux["dropped"]) > 0
    np.testing.assert_array_equal(_np(load), np.asarray(aux["load"]))
    np.testing.assert_allclose(_np(got), np.asarray(y), atol=LAYER_ATOL)
    _, gidx, _ = Tmoe._route(dict(mod.named_parameters()),
                                torch.from_numpy(x).reshape(96, -1),
                                tcfg.moe)
    np.testing.assert_array_equal(_np(gidx), idx)


@pytest.mark.parametrize("arch", MOE)
def test_zero_router_ties_pick_the_lowest_experts(arch):
    """All probabilities 1/E: ``jax.lax.top_k`` picks experts 0..k-1, and
    so does the port; with the lowest experts full past capacity the same
    pairs drop."""
    rcfg, tcfg = _cfgs(arch, capacity_factor=1.25, router_aux_free_bias=False)
    p, mod = _carried_moe(rcfg, tcfg, seed=3)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    with torch.no_grad():
        mod.router.zero_()
    x = _x(tcfg, 2, 16, seed=3)
    _, gidx, _ = Tmoe._route(dict(mod.named_parameters()),
                                torch.from_numpy(x), tcfg.moe)
    k = tcfg.moe.top_k
    assert (_np(gidx) == np.arange(k)).all()
    keep, idx = _ref_keep(p, x, rcfg)
    assert (idx == np.arange(k)).all() and not keep.all()
    y, aux = _ref(p, x, rcfg)
    got, gaux = _port(mod, x)
    np.testing.assert_allclose(_np(got), np.asarray(y), atol=LAYER_ATOL)
    assert float(gaux["dropped"]) == float(aux["dropped"]) > 0


def test_aux_free_bias_and_shared_expert_match_reference():
    """DeepSeek's router: a nonzero aux-free bias moves the picks (the
    gates stay the unbiased probabilities), plus one shared expert."""
    rcfg, tcfg = _cfgs("deepseek_v3_671b", capacity_factor=1.25)
    assert tcfg.moe.router_aux_free_bias and tcfg.moe.n_shared == 1
    E = tcfg.moe.n_experts
    bias = np.linspace(-0.2, 0.2, E).astype(np.float32)
    p, mod = _carried_moe(rcfg, tcfg, seed=4, bias=bias)
    assert mod.shared.w_gate.shape == (tcfg.d_model, tcfg.moe.d_ff_expert)
    x = _x(tcfg, 2, 16, seed=4)
    y, aux = _ref(p, x, rcfg)
    got, gaux = _port(mod, x)
    np.testing.assert_allclose(_np(got), np.asarray(y), atol=LAYER_ATOL)
    np.testing.assert_array_equal(_np(gaux["load"]), np.asarray(aux["load"]))
    assert float(gaux["dropped"]) == float(aux["dropped"])
    _, idx_biased = _ref_keep(p, x, rcfg)
    _, idx_plain = _ref_keep(dict(p, router_bias=jnp.zeros(E)), x, rcfg)
    assert (idx_biased != idx_plain).any()


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 4), st.integers(1, 24), st.integers(0, 5),
       st.sampled_from([1.25, 2.0, 64.0]))
def test_moe_apply_property(B, S, seed, cf):
    rcfg, tcfg = _cfgs("deepseek_v3_671b", capacity_factor=cf)
    p, mod = _carried_moe(rcfg, tcfg, seed=seed,
                          bias=np.random.default_rng(seed).normal(
                              0, 0.05, tcfg.moe.n_experts).astype(np.float32))
    x = _x(tcfg, B, S, seed=seed, scale=0.5)
    y, aux = _ref(p, x, rcfg)
    got, gaux = _port(mod, x)
    np.testing.assert_allclose(_np(got), np.asarray(y), atol=LAYER_ATOL)
    np.testing.assert_array_equal(_np(gaux["load"]), np.asarray(aux["load"]))
    assert float(gaux["dropped"]) == float(aux["dropped"])


def test_hierarchical_one_group_matches_reference():
    """Without a mesh the reference's hierarchical dispatch is one group;
    its ``dropped`` is 0.0 even where pairs drop."""
    rcfg, tcfg = _cfgs("deepseek_v3_671b", capacity_factor=1.25,
                       dispatch="hierarchical")
    p, mod = _carried_moe(rcfg, tcfg, seed=5)
    x = _x(tcfg, 2, 24, seed=5, skew=1.5)
    assert Tmoe._dp_groups(48) == 1
    y, aux = _ref(p, x, rcfg)
    got, gaux = _port(mod, x)
    np.testing.assert_allclose(_np(got), np.asarray(y), atol=LAYER_ATOL)
    np.testing.assert_array_equal(_np(gaux["load"]), np.asarray(aux["load"]))
    assert gaux["dropped"] == float(aux["dropped"]) == 0.0
    assert not _ref_keep(p, x, rcfg)[0].all()


HIER_SCRIPT = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
import repro.configs as RC, repro.models.moe as Rm
from repro.compat import make_mesh, set_mesh
cfg = RC.get_smoke_config("deepseek_v3_671b")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, dispatch="hierarchical", capacity_factor=1.25))
p = Rm.init_moe(jax.random.PRNGKey(6), cfg, jnp.float32)
x = jax.random.normal(jax.random.PRNGKey(7), (2, 24, cfg.d_model))
with set_mesh(make_mesh((2,), ("data",))):
    g, (y, aux) = jax.jit(lambda p, x: (Rm._dp_groups(48),
                                        Rm.moe_apply(p, x, cfg)))(p, x)
flat = {"x": np.asarray(x), "y": np.asarray(y), "load": np.asarray(aux["load"]),
        "groups": np.asarray(g)}
def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, pre + k + ".")
        else:
            flat["p/" + pre + k] = np.asarray(v)
walk(p, "")
np.savez(sys.argv[1], **flat)
"""


def test_hierarchical_two_groups_match_reference_on_a_data_mesh(tmp_path):
    """The reference under a 2-device fake-CPU data mesh dispatches in two
    groups of 24 tokens, each with its own capacity; the port's grouped
    dispatch at G = 2 gives the same outputs and loads, and differs from
    the one-group dispatch (so the grouping is what was tested)."""
    out = tmp_path / "hier.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", HIER_SCRIPT, str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    ref = np.load(out)
    assert int(ref["groups"]) == 2
    _, tcfg = _cfgs("deepseek_v3_671b", capacity_factor=1.25,
                    dispatch="hierarchical")
    mod = Tmoe.MoE(tcfg, dtype=torch.float32, device="cpu")
    mod.load_state_dict({k[2:]: torch.from_numpy(ref[k]) for k in ref.files
                         if k.startswith("p/")}, strict=True)
    params = _params(mod)
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        got, load, _ = Tmoe._moe_apply_grouped(params, x, tcfg, 2)
        one, _, keep1 = Tmoe._moe_apply_grouped(params, x, tcfg, 1)
    np.testing.assert_allclose(_np(got), ref["y"], atol=LAYER_ATOL)
    np.testing.assert_array_equal(_np(load), ref["load"])
    assert not keep1.all()
    assert np.abs(_np(one) - ref["y"]).max() > 1e-3


def test_update_router_bias_matches_reference():
    rcfg, tcfg = RC.get_smoke_config("deepseek_v3_671b"), \
        TC.get_smoke_config("deepseek_v3_671b")
    E = tcfg.moe.n_experts
    rng = np.random.default_rng(8)
    load = rng.dirichlet(np.ones(E)).astype(np.float32)
    load[3] = 1.0 / E                                 # on target: no move
    bias = rng.normal(0, 0.01, E).astype(np.float32)
    want = Rmoe.update_router_bias({"router_bias": jnp.asarray(bias),
                                    "router": 1}, jnp.asarray(load),
                                   rate=2e-3)
    got = Tmoe.update_router_bias({"router_bias": torch.from_numpy(bias),
                                   "router": 1}, torch.from_numpy(load),
                                  rate=2e-3)
    assert got["router"] == 1
    np.testing.assert_array_equal(_np(got["router_bias"]),
                                  np.asarray(want["router_bias"]))
    assert float(got["router_bias"][3]) == bias[3]


@pytest.mark.parametrize("arch", MOE)
def test_bfloat16_moe_follows_reference(arch):
    """bf16 activations: the reference casts the float32 router and bias
    to bf16 (``_cast_floats``) and promotes the product back to float32.
    Random inputs: the same picks and loads, outputs within 2 bf16 ulps of
    the largest. Then a router whose columns 0-2 differ by less than a
    bf16 ulp: cast, they tie and both packages pick the lowest experts,
    where an uncast float32 router would pick others."""
    rcfg, tcfg = (dataclasses.replace(c, activation_dtype="bfloat16")
                  for c in _cfgs(arch, capacity_factor=1.25))
    p, mod = _carried_moe(rcfg, tcfg, seed=9)
    x = _x(tcfg, 4, 16, seed=9)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    for router in (None, "near_tie"):
        if router == "near_tie":
            base = np.asarray(jnp.asarray(
                np.abs(np.asarray(p["router"][:, :1])) + 0.05).astype(
                jnp.bfloat16).astype(jnp.float32))
            r = np.asarray(p["router"]).copy() * 0.01
            r[:, :3] = base * (1 + np.array([0.0, 1e-4, 2e-4], np.float32))
            p = dict(p, router=jnp.asarray(r))
            with torch.no_grad():
                mod.router.copy_(torch.from_numpy(r))
            xb = jnp.abs(xb)
            xt = xt.abs()
        pc = RM._cast_floats(p, jnp.bfloat16)
        y, aux = _ref(pc, xb, rcfg)
        got, gaux = _port(mod, xt, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        keep, idx = _ref_keep(pc, np.asarray(xb.astype(jnp.float32)), rcfg)
        params = {k: v.to(torch.bfloat16)
                  for k, v in mod.named_parameters(recurse=False)}
        _, gidx, _ = Tmoe._route(params, xt.reshape(64, -1), tcfg.moe)
        np.testing.assert_array_equal(_np(gidx), idx)
        np.testing.assert_array_equal(_np(gaux["load"]),
                                      np.asarray(aux["load"]))
        assert float(gaux["dropped"]) == float(aux["dropped"])
        want = np.asarray(y.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_REL * np.abs(want).max(), err
        if router == "near_tie":
            k = tcfg.moe.top_k
            assert (idx[:, :min(k, 3)] == np.arange(min(k, 3))).all()
            _, fidx, _ = Tmoe._route(
                dict(params, router=mod.router.detach()),
                xt.reshape(64, -1), tcfg.moe)
            assert (_np(fidx) != idx).any()


# --------------------------------------------------------------------------- #
# the MoE models
# --------------------------------------------------------------------------- #
def _carried(arch, seed=0, rcfg=None, tcfg=None):
    rcfg = rcfg or RC.get_smoke_config(arch)
    tcfg = tcfg or TC.get_smoke_config(arch)
    params = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return params, rcfg, model, tcfg


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_reference(arch):
    params, rcfg, model, tcfg = _carried(arch, seed=1)
    toks = _tokens(tcfg, 2, 16, seed=1)
    want, waux = RM.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    with torch.no_grad():
        got, aux = TM.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (2, 16, tcfg.vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)
    assert float(aux["moe_dropped"]) == float(waux["moe_dropped"])
    assert ("mtp_hidden" in aux) == bool(tcfg.mtp_depth)


@pytest.mark.parametrize("arch", MOE)
def test_forward_with_capacity_drops_matches_reference(arch):
    """The published capacity 1.25 in a smoke model: every MoE layer
    routes 64 tokens and drops pairs; logits within 1e-4 and the summed
    dropped share equal."""
    rcfg, tcfg = _cfgs(arch, capacity_factor=1.25)
    params, _, model, _ = _carried(arch, seed=2, rcfg=rcfg, tcfg=tcfg)
    toks = _tokens(tcfg, 4, 16, seed=2)
    want, waux = RM.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    with torch.no_grad():
        got, aux = TM.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert float(aux["moe_dropped"]) == float(waux["moe_dropped"]) > 0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch):
    params, rcfg, model, tcfg = _carried(arch, seed=3)
    toks = _tokens(tcfg, 2, 12, seed=3)
    P, max_len = 9, 16
    want, rc = RM.prefill(params, {"tokens": jnp.asarray(toks[:, :P])},
                          rcfg, max_len)
    got, tc = TM.prefill(model, {"tokens": torch.from_numpy(toks[:, :P])},
                         tcfg, max_len)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL)
    for t in range(P, 12):
        want, rc = RM.decode_step(params, rc,
                                  {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                  rcfg)
        got, tc = TM.decode_step(model, tc, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])}, tcfg)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LOGIT_ATOL)
    assert [c["idx"] for c in tc] == [12] * tcfg.n_layers
    layer = 0
    for gi, (pattern, n_rep) in enumerate(tcfg.scan_groups()):
        for r in range(n_rep):
            for i in range(len(pattern)):
                for key in ("ckv", "kr") if tcfg.mla else ("k", "v"):
                    np.testing.assert_allclose(
                        _np(tc[layer][key]), np.asarray(rc[gi][i][key][r]),
                        atol=LAYER_ATOL)
                layer += 1


@pytest.mark.parametrize("arch", MOE)
def test_own_decode_matches_own_forward(arch):
    """The port's seeded init at the smoke capacity (dropless): decode
    against forward over the same prefix."""
    cfg = TC.get_smoke_config(arch)
    model = TM.init_model(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=5))
    with torch.no_grad():
        full, aux = TM.forward(model, {"tokens": toks}, cfg)
    assert abs(float(aux["moe_dropped"])) < 1e-6
    P = 9
    lg, caches = TM.prefill(model, {"tokens": toks[:, :P]}, cfg, 16)
    errs = [float((lg[:, -1] - full[:, P - 1]).abs().max())]
    for t in range(P, 12):
        lg, caches = TM.decode_step(model, caches,
                                    {"tokens": toks[:, t:t + 1]}, cfg)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < SELF_DECODE_ATOL, errs


def test_moe_init_keeps_the_router_float32():
    """bf16 parameters: the router and its bias stay float32 (reference
    ``moe.py:29-30``), the expert stacks are bf16, and carried bf16 leaves
    load bit for bit."""
    rcfg, tcfg = (dataclasses.replace(get("phi35_moe_42b"),
                                      param_dtype="bfloat16")
                  for get in (RC.get_smoke_config, TC.get_smoke_config))
    params, _, model, _ = _carried("phi35_moe_42b", seed=6, rcfg=rcfg,
                                   tcfg=tcfg)
    moe = model.blocks[1].mlp
    assert moe.router.dtype == moe.router_bias.dtype == torch.float32
    assert moe.w_gate.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(moe.router), np.asarray(params["blocks"][0][0]["mlp"]["router"][1]))
    np.testing.assert_array_equal(
        moe.w_down.detach().float().numpy(),
        np.asarray(params["blocks"][0][0]["mlp"]["w_down"][1]
                   .astype(jnp.float32)))
    seeded = TM.init_model(tcfg, seed=0, device="cpu").blocks[0].mlp
    assert seeded.router.dtype == torch.float32
    assert not seeded.router_bias.any()


def test_carried_moe_weights_must_match_every_parameter():
    params, _, _, tcfg = _carried("deepseek_v3_671b")
    tree = jax.tree.map(np.asarray, params)
    del tree["blocks"][1][0]["mlp"]["shared"]["w_up"]
    with pytest.raises(RuntimeError, match="shared.w_up"):
        model_params_from_numpy(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    tree["blocks"][1][0]["mlp"]["router_scale"] = np.ones(8, np.float32)
    with pytest.raises(RuntimeError, match="router_scale"):
        model_params_from_numpy(tree, tcfg, device="cpu")


def test_seeded_expert_stacks_are_drawn_in_slices(monkeypatch):
    """A stack above the chunk size is drawn slice by slice from the one
    generator: reproducible, scaled by its fan-in, and the float32 draw of
    the whole stack never exists."""
    import repro_torch.models.layers as TL
    monkeypatch.setattr(TL, "_INIT_CHUNK", 3000)
    sizes = []
    real = torch.randn

    def spy(*a, **kw):
        out = real(*a, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    g = torch.Generator().manual_seed(0)
    w = TL._dense_init(g, (8, 48, 40), 48, torch.float32)
    assert w.shape == (8, 48, 40) and max(sizes) <= 3000
    assert sizes == [1920] * 8
    again = TL._dense_init(torch.Generator().manual_seed(0), (8, 48, 40), 48,
                           torch.float32)
    assert torch.equal(w, again)
    assert abs(float(w.std()) * np.sqrt(48) - 1) < 0.1
