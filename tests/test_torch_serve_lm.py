"""The LM serving path of the port against the JAX package's: a 2-prompt
prefill + greedy decode loop on carried weights (float32, logits within
1e-4 at every step, identical greedy tokens) for the dense, the MoE and the
Jamba hybrid archs, and the port's ``examples/torch_serve_lm.py`` on the
CPU."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.model as RM
import repro_torch.configs as TC
from repro.training import steps as RS
from repro_torch.interop import model_params_from_numpy
from repro_torch.models import model as TM
from repro_torch.training import steps as TS

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["olmo_1b", "phi4_mini_3p8b", "stablelm_3b", "llama3_405b"]
MOE = ["phi35_moe_42b", "deepseek_v3_671b"]
HYBRID = ["jamba_v01_52b"]
LOGIT_ATOL = 1e-4


def _serve(prefill, step, model, prompts, gen, wrap):
    """serve_lm's loop: the greedy tokens [B, gen]."""
    nxt, caches = prefill(model, {"tokens": wrap(prompts)})
    toks = [np.asarray(nxt)]
    for _ in range(gen - 1):
        nxt, caches = step(model, caches, {"tokens": nxt[:, None]})
        toks.append(np.asarray(nxt))
    return np.stack(toks, axis=1)


@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID)
def test_serve_loop_matches_reference(arch):
    rcfg, tcfg = RC.get_smoke_config(arch), TC.get_smoke_config(arch)
    params = RM.init_model(jax.random.PRNGKey(7), rcfg)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    prompts = np.random.default_rng(7).integers(
        0, tcfg.vocab, (2, 10)).astype(np.int32)
    P, gen = prompts.shape[1], 8
    max_len = P + gen

    want_toks, got_toks = [], []
    for step in range(gen):
        if step == 0:
            want_lg, rc = RM.prefill(
                params, {"tokens": jnp.asarray(prompts)}, rcfg, max_len)
            got_lg, tc = TM.prefill(
                model, {"tokens": torch.from_numpy(prompts)}, tcfg, max_len)
        else:
            want_lg, rc = RM.decode_step(
                params, rc, {"tokens": jnp.asarray(want_toks[-1])[:, None]},
                rcfg)
            got_lg, tc = TM.decode_step(
                model, tc,
                {"tokens": torch.from_numpy(got_toks[-1])[:, None]}, tcfg)
        np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg),
                                   atol=LOGIT_ATOL)
        want_toks.append(np.asarray(jnp.argmax(want_lg[:, -1], axis=-1)))
        got_toks.append(TS._greedy(got_lg).numpy())
        np.testing.assert_array_equal(got_toks[-1], want_toks[-1])

    # the step builders, driven as serve_lm drives them, give the same tokens
    want = _serve(jax.jit(RS.make_prefill_step(rcfg, max_len)),
                  jax.jit(RS.make_serve_step(rcfg)), params, prompts,
                  gen, jnp.asarray)
    got = _serve(TS.make_prefill_step(tcfg, max_len),
                 TS.make_serve_step(tcfg), model, prompts, gen,
                 torch.from_numpy)
    np.testing.assert_array_equal(want, np.stack(want_toks, axis=1))
    np.testing.assert_array_equal(got, want)


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_serve_lm", ROOT / "examples" / "torch_serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_serves_on_cpu(capsys):
    ex = _example()
    toks = ex.main(["--arch", "olmo_1b", "--device", "cpu"])
    assert toks.shape == (4, 32) and toks.dtype == torch.int32
    out = capsys.readouterr().out
    assert "olmo_1b: generated 4x32 tokens" in out and "on CPU" in out
    # seeded: a second run serves the same tokens
    again = ex.main(["--arch", "olmo_1b", "--device", "cpu", "--batch", "2",
                     "--gen", "5"])
    # the first lane's prompt is drawn first, so its tokens agree
    np.testing.assert_array_equal(again[0], toks[0, :5])
    # the xLSTM, VLM and encoder-decoder archs, once refused, serve too
    for arch in ("xlstm_350m", "internvl2_26b", "seamless_m4t_large_v2"):
        got = ex.main(["--arch", arch, "--device", "cpu", "--gen", "4"])
        assert got.shape == (4, 4) and got.dtype == torch.int32
        assert f"{arch}: generated 4x4 tokens" in capsys.readouterr().out
        np.testing.assert_array_equal(
            ex.main(["--arch", arch, "--device", "cpu", "--gen", "4"]), got)


@pytest.mark.parametrize("arch", MOE)
def test_example_serves_moe_archs_on_cpu(arch, capsys):
    toks = _example().main(["--arch", arch, "--device", "cpu", "--gen",
                            "6"])
    assert toks.shape == (4, 6) and toks.dtype == torch.int32
    assert f"{arch}: generated 4x6 tokens" in capsys.readouterr().out


def test_example_serves_jamba_on_cpu(capsys):
    """The Jamba smoke config (7 Mamba layers and one attention layer, MoE
    on the odd layers) through the example's loop; a prompt past the scan
    chunk of 512 takes the chunked path."""
    ex = _example()
    toks = ex.main(["--arch", "jamba_v01_52b", "--device", "cpu", "--gen",
                    "6"])
    assert toks.shape == (4, 6) and toks.dtype == torch.int32
    assert "jamba_v01_52b: generated 4x6 tokens" in capsys.readouterr().out
    long = ex.main(["--arch", "jamba_v01_52b", "--device", "cpu", "--batch",
                    "1", "--prompt-len", "520", "--gen", "3"])
    assert long.shape == (1, 3)


def test_example_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _example().main(["--arch", "olmo_1b"])
