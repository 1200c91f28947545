"""The port's training substrate against the JAX package's: AdamW, the clip
and the schedule, the synthetic token stream, checkpoints and restart,
gradient compression, the loss, and the training driver.

Tolerances (float32 on the CPU): ``adamw_update`` within 1e-7 relative
(zero-gradient leaves too); ``lr_schedule`` within 1 float32 ulp; the token
stream bit-identical; the clipped leaves and the norm within 1e-6
relative (the norm adds its leaves in another order); ``quantize_grad``
on the reference's noise bit-equal; ``compressed_psum`` on 4 gloo ranks
within 0.05 of the exact mean (the reference's bar); losses within 1e-5
relative; the port's own restart bit for bit; a reference checkpoint
resumed by the port within 1e-5 of the reference's continuation.
"""
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.launch.train as RT
import repro_torch.configs as TC
from repro.training import checkpoint as RCk
from repro.training import data as RD
from repro.training import optimizer as RO
from repro.training import steps as RS
from repro_torch.interop import model_params_from_numpy, train_state_from_numpy
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as TCk
from repro_torch.training import data as TD
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TS

ROOT = Path(__file__).resolve().parents[1]
ADAMW_RTOL = 1e-7
CLIP_RTOL = 1e-6
LOSS_RTOL = 1e-5


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #
def test_adamw_update_matches_reference():
    """3 steps on random float32 leaves with the schedule's lr, one leaf
    with a zero gradient (``None`` in the port, as ``p.grad`` is for the
    MoE router bias): parameters and moments within 1e-7 relative; the
    zero-gradient leaf decays as the reference's does."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 33), "b": (7,), "bias": (5, 3)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rs, ts = RO.adamw_init(rp), TO.adamw_init(tp)
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-4, 1))
             .astype(np.float32) for k, s in shapes.items()}
        g["bias"][:] = 0
        sched = dict(peak_lr=1e-3, warmup=2, total=10)
        rp, rs = RO.adamw_update(
            rp, {k: jnp.asarray(v) for k, v in g.items()}, rs,
            lr=RO.lr_schedule(rs.step, **sched))
        tp, ts = TO.adamw_update(
            tp, {k: None if k == "bias" else torch.from_numpy(v)
                 for k, v in g.items()}, ts,
            lr=TO.lr_schedule(ts.step, **sched))
        for k in shapes:
            for want, got in ((rp[k], tp[k]), (rs.m[k], ts.m[k]),
                              (rs.v[k], ts.v[k])):
                np.testing.assert_allclose(_np(got), np.asarray(want),
                                           rtol=ADAMW_RTOL, atol=0)
    assert int(ts.step) == int(rs.step) == 3
    assert ts.m["bias"].dtype == torch.float32
    assert not np.array_equal(_np(tp["bias"]), p0["bias"])    # decayed


def test_adamw_converges_quadratic():
    """``tests/test_training.py``'s quadratic, step by step against the
    reference."""
    rp = {"w": jnp.array([3.0, -2.0])}
    tp = {"w": torch.tensor([3.0, -2.0])}
    rs, ts = RO.adamw_init(rp), TO.adamw_init(tp)
    for _ in range(300):
        rp, rs = RO.adamw_update(rp, {"w": 2 * rp["w"]}, rs, lr=0.05,
                                 weight_decay=0.0)
        tp, ts = TO.adamw_update(tp, {"w": 2 * tp["w"]}, ts, lr=0.05,
                                 weight_decay=0.0)
    assert float(tp["w"].abs().max()) < 1e-2
    np.testing.assert_allclose(_np(tp["w"]), np.asarray(rp["w"]),
                               rtol=ADAMW_RTOL, atol=1e-9)


def test_clip_by_global_norm_matches_reference():
    g = {"a": torch.ones(10) * 3.0}
    clipped, norm = TO.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 3.0 * np.sqrt(10)) < 1e-4
    assert abs(float(clipped["a"].square().sum().sqrt()) - 1.0) < 1e-5
    rng = np.random.default_rng(1)
    leaves = {"x": (rng.standard_normal((40, 7)) * 3).astype(np.float32),
              "y": rng.standard_normal((5,)).astype(np.float32),
              "z": (rng.standard_normal((3, 3, 3)) * 1e-3)
              .astype(np.float32)}
    for max_norm in (1.0, 1e3):
        want, wnorm = RO.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in leaves.items()}, max_norm)
        got, gnorm = TO.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in leaves.items()},
            max_norm)
        np.testing.assert_allclose(float(gnorm), float(wnorm),
                                   rtol=CLIP_RTOL)
        for k in leaves:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       rtol=CLIP_RTOL, atol=0)


def test_lr_schedule_equals_reference():
    """The schedule against the reference's at steps 0-99, to 1 float32
    ulp: the port's cosine is the float64 one rounded once to float32, the
    reference's is the CPU library's float32 ``cosf``, within an ulp of it
    (they differ at one of these 300 steps). Bit equality is not needed:
    the compiled reference is itself an ulp off its eager self at some
    steps, and the card computes the port's schedule as the CPU does."""
    for sched in (dict(peak_lr=1e-3, warmup=10, total=100),
                  dict(peak_lr=1e-3, warmup=2, total=50),
                  dict(peak_lr=3e-4, warmup=20, total=6)):
        want = np.array([np.float32(RO.lr_schedule(jnp.int32(s), **sched))
                         for s in range(100)])
        got = np.array([np.float32(TO.lr_schedule(
            torch.tensor(s, dtype=torch.int32), **sched))
            for s in range(100)])
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    lrs = [float(TO.lr_schedule(torch.tensor(s), peak_lr=1e-3, warmup=10,
                                total=100)) for s in range(100)]
    assert lrs[0] < lrs[9] and abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[-1] < lrs[20]


def test_quantize_grad_on_reference_noise_is_bit_equal():
    rng = np.random.default_rng(3)
    g = (rng.standard_normal((64, 33)) * 0.01).astype(np.float32)
    err = (rng.standard_normal((64, 33)) * 1e-4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    scale = jnp.max(jnp.abs(jnp.asarray(g) + jnp.asarray(err))) / 127.0 \
        + 1e-12
    q, ne = RO.quantize_grad(jnp.asarray(g), jnp.asarray(err), key, scale)
    noise = jax.random.uniform(key, g.shape, minval=-0.5, maxval=0.5)
    tq, tne = TO._quantize(torch.from_numpy(g), torch.from_numpy(err),
                           torch.from_numpy(np.array(noise)),
                           torch.from_numpy(np.array(scale)))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(_np(tq), np.asarray(q))
    np.testing.assert_array_equal(_np(tne), np.asarray(ne))
    np.testing.assert_array_equal(
        _np(TO.dequantize_grad(tq, torch.from_numpy(np.asarray(scale)))),
        np.asarray(RO.dequantize_grad(q, scale)))
    gen = torch.Generator().manual_seed(0)
    q2, _ = TO.quantize_grad(torch.from_numpy(g), torch.from_numpy(err),
                             gen, torch.from_numpy(np.asarray(scale)))
    assert int((q2.int() - tq.int()).abs().max()) <= 1


_COMPRESS_RANK = r"""
import os, numpy as np, torch, torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["DRONE_INIT"],
                        rank=rank, world_size=world)
from repro_torch.training.optimizer import compressed_psum
g = np.random.default_rng(0).standard_normal((world, 256)).astype(
    np.float32) * 0.01
exact = g.mean(axis=0)
gen = torch.Generator().manual_seed(1 + rank)
out, err = compressed_psum({"g": torch.from_numpy(g[rank].copy())}, None,
                           gen)
again, _ = compressed_psum({"g": torch.from_numpy(g[rank].copy())}, err,
                           gen)
rel = float(np.abs(out["g"].numpy() - exact).max() / np.abs(exact).max())
rel2 = float(np.abs(again["g"].numpy() - exact).max() / np.abs(exact).max())
assert rel < 0.05 and rel2 < 0.05, (rel, rel2)
# every rank holds the same mean
ref = out["g"].clone(); dist.broadcast(ref, 0)
assert torch.equal(ref, out["g"])
dist.destroy_process_group()
print("COMPRESS_OK", rank, rel, rel2)
"""


def test_compressed_psum_gloo(tmp_path):
    """``tests/test_training.py``'s compression case on 4 gloo ranks: the
    int8 mean within 0.05 of the exact one (relative to its largest
    value), on zero errors and then on the errors fed back."""
    from test_torch_shard import spawn_ranks, wait_all
    out = wait_all(spawn_ranks(_COMPRESS_RANK, 4, [], tmp_path / "store"),
                   240)
    assert all("COMPRESS_OK" in text for _, text in out), out


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("vocab,seq,batch,seed,index", [
    (1000, 64, 4, 3, 7), (128, 32, 2, 0, 0), (50304, 128, 2, 0, 5),
    (256, 17, 3, 11, 123456)])
def test_synthetic_tokens_bit_identical(vocab, seq, batch, seed, index):
    want = RD.SyntheticTokens(vocab, seq, batch, seed=seed).batch(index)
    ds = TD.SyntheticTokens(vocab, seq, batch, seed=seed)
    got = ds.batch(index)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])
    assert not np.array_equal(ds.batch(index + 1)["tokens"], got["tokens"])
    it = TD.synthetic_batches(vocab, seq, batch, seed=seed, start=index)
    i, b = next(it)
    assert i == index and np.array_equal(b["tokens"], got["tokens"])
    assert next(it)[0] == index + 1


# --------------------------------------------------------------------------- #
# checkpoints and restart
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip_and_retention(tmp_path):
    """A train state (after a step, so the moments are not zero) saved and
    restored into a state drawn from another seed: every tensor equal;
    retention keeps the newest; the reference's ``load_pytree`` reads the
    port's file."""
    cfg = TC.get_smoke_config("olmo_1b")
    state = TS.make_train_state(cfg, seed=0, device="cpu")
    b = TD.SyntheticTokens(cfg.vocab, 16, 2).batch(0)
    state, _ = TS.make_train_step(cfg)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    p = str(tmp_path / "step_0000010.npz")
    TCk.save_pytree(p, state, extra_meta={"data_cursor": 10, "arch": "x"})
    other = TS.make_train_state(cfg, seed=1, device="cpu")
    restored, meta = TCk.load_pytree(p, like=other)
    assert meta == {"data_cursor": 10, "arch": "x"}
    for (ka, a), (kb, b_) in zip(TCk._leaves(state), TCk._leaves(restored)):
        assert ka == kb and torch.equal(a, b_), ka
    assert int(restored.opt.step) == 1
    flat, rmeta = RCk.load_pytree(p)
    assert rmeta == meta and sorted(flat) == sorted(k for k, _ in
                                                   TCk._leaves(state))
    assert "params|embed" in flat and "opt|m|embed" in flat
    np.testing.assert_array_equal(flat["opt|v|embed"],
                                  state.opt.v["embed"].numpy())
    bad = TS.make_train_state(TC.get_smoke_config("stablelm_3b"),
                              device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        TCk.load_pytree(p, like=bad)
    for i in (20, 30, 40):
        TCk.save_pytree(str(tmp_path / f"step_{i:07d}.npz"), state,
                        extra_meta={"data_cursor": i})
    TCk.keep_last(str(tmp_path), 2)
    assert TCk.latest_checkpoint(str(tmp_path)).endswith("0000040.npz")
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 2
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert TCk.latest_checkpoint(str(tmp_path / "none")) is None


def test_train_restart_bitexact(tmp_path):
    """``tests/test_training.py``'s restart on the port, port against
    port: 6 steps straight equal 3 steps, a checkpoint, and 3 resumed, bit
    for bit (losses and every parameter and moment)."""
    from repro_torch.launch.train import train
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    s_full, h_full = train("olmo_1b", steps=6, batch=2, seq=32, ckpt_dir=d1,
                           ckpt_every=100, log_every=100, device="cpu")
    train("olmo_1b", steps=3, batch=2, seq=32, ckpt_dir=d2, ckpt_every=3,
          log_every=100, device="cpu")
    s_res, h_res = train("olmo_1b", steps=6, batch=2, seq=32, ckpt_dir=d2,
                         ckpt_every=100, resume=True, log_every=100,
                         device="cpu")
    assert len(h_res) == 3 and h_full[3:] == h_res
    for (ka, a), (kb, b) in zip(TCk._leaves(s_full), TCk._leaves(s_res)):
        assert ka == kb and torch.equal(a, b), ka


def test_reference_checkpoint_resumed_by_the_port(tmp_path):
    """The reference's driver trains 3 steps and checkpoints; the state is
    carried (``train_state_from_numpy``) into a port checkpoint, and the
    port's ``train(resume=True)`` continues to step 6: its losses within
    1e-5 of the reference's own continuation."""
    rdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(steps=6, batch=2, seq=32, log_every=100)
    RT.train("olmo_1b", **dict(kw, steps=3), ckpt_dir=rdir, ckpt_every=3)
    _, want = RT.train("olmo_1b", **kw, ckpt_dir=rdir, ckpt_every=100,
                       resume=True)
    rcfg, tcfg = RC.get_smoke_config("olmo_1b"), TC.get_smoke_config(
        "olmo_1b")
    like = RS.make_train_state(jax.random.PRNGKey(0), rcfg)
    rstate, meta = RCk.load_pytree(os.path.join(rdir, "step_0000003.npz"),
                                   like=like)
    assert meta["data_cursor"] == 3
    carried = train_state_from_numpy(jax.tree.map(np.asarray, rstate),
                                     tcfg, device="cpu")
    assert int(carried.opt.step) == 3
    TCk.save_pytree(os.path.join(tdir, "step_0000003.npz"), carried,
                    extra_meta=meta)
    from repro_torch.launch.train import train
    _, got = train("olmo_1b", **kw, ckpt_dir=tdir, ckpt_every=100,
                   resume=True, device="cpu")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_train_state_from_numpy_is_strict():
    """Every moment lands on its parameter by name (the stacked archs are
    carried in ``tests/test_torch_train_archs*.py``); a missing leaf
    raises."""
    cfg_r, cfg_t = RC.get_smoke_config("olmo_1b"), \
        TC.get_smoke_config("olmo_1b")
    state = RS.make_train_state(jax.random.PRNGKey(0), cfg_r)
    tree = jax.tree.map(np.asarray, state)
    port = train_state_from_numpy(tree, cfg_t, device="cpu")
    names = dict(port.params.named_parameters())
    assert sorted(port.opt.m) == sorted(port.opt.v) == sorted(names)
    assert all(m.dtype == torch.float32 and m.shape == names[n].shape
               for n, m in port.opt.m.items())
    bad_m = dict(tree.opt.m)
    bad_m.pop("embed")
    with pytest.raises(ValueError, match="opt.m"):
        train_state_from_numpy({"params": tree.params, "opt": {
            "step": tree.opt.step, "m": bad_m, "v": tree.opt.v}}, cfg_t,
            device="cpu")


# --------------------------------------------------------------------------- #
# loss and remat
# --------------------------------------------------------------------------- #
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 9, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    labels[0, :4] = -1
    mask = (labels >= 0).astype(np.float32)
    lab = np.maximum(labels, 0)
    want = RS.cross_entropy(jnp.asarray(logits), jnp.asarray(lab),
                            jnp.asarray(mask))
    got = TS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab),
                           torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    zero = TS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab),
                            torch.zeros(3, 9))
    assert float(zero) == 0.0


@pytest.mark.parametrize("arch", ["olmo_1b", "internvl2_26b",
                                  "deepseek_v3_671b"])
def test_loss_fn_matches_reference(arch):
    """``loss_fn`` with ``-1`` labels (masked), a frontend prefix
    (internvl2) and the MTP term (DeepSeek), on carried weights."""
    rcfg, tcfg = RC.get_smoke_config(arch), TC.get_smoke_config(arch)
    params = RS.make_train_state(jax.random.PRNGKey(5), rcfg).params
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[1, 3:7] = -1
    b = {"tokens": toks, "labels": labels}
    if tcfg.frontend:
        b["frontend"] = (rng.standard_normal(
            (2, tcfg.frontend_len, tcfg.frontend_dim)) * 0.02).astype(
                np.float32)
    want_loss, want = RS.loss_fn(params, {k: jnp.asarray(v)
                                          for k, v in b.items()}, rcfg)
    got_loss, got = TS.loss_fn(model, {k: torch.from_numpy(v)
                                       for k, v in b.items()}, tcfg)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    got_loss.backward()
    assert model.embed.grad is not None


@pytest.mark.parametrize("arch", ["olmo_1b", "seamless_m4t_large_v2",
                                  "jamba_v01_52b"])
def test_remat_keeps_forward_and_gradients(arch, monkeypatch):
    """``forward`` under ``torch.no_grad()`` gives the same logits as with
    grad on (every block, the encoder's too, under
    ``torch.utils.checkpoint``), and the remat'd gradients equal those of
    the model with remat taken out, bit for bit."""
    cfg = TC.get_smoke_config(arch)
    model = TM.init_model(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    b = {"tokens": torch.randint(0, cfg.vocab, (2, 10), generator=gen)}
    b["labels"] = torch.roll(b["tokens"], -1, 1)
    if cfg.frontend:
        b["frontend"] = torch.randn((2, cfg.frontend_len, cfg.frontend_dim),
                                    generator=gen) * 0.02
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(TM, "checkpoint", spy)
    with torch.no_grad():
        quiet, _ = TM.forward(model, b, cfg)
    assert not calls
    loud, _ = TM.forward(model, b, cfg)
    assert torch.equal(quiet, loud)
    assert len(calls) == cfg.n_layers + cfg.n_enc_layers
    loss, _ = TS.loss_fn(model, b, cfg)
    loss.backward()
    remat = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    monkeypatch.setattr(TM, "_remat", lambda blk: blk)
    loss, _ = TS.loss_fn(model, b, cfg)
    loss.backward()
    plain = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    assert sorted(plain) == sorted(remat)
    for n in plain:
        assert torch.equal(plain[n], remat[n]), n


# --------------------------------------------------------------------------- #
# the driver and the example
# --------------------------------------------------------------------------- #
def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_on_cpu(tmp_path, monkeypatch, capsys):
    """``examples/torch_train_lm.py --device cpu --steps 20``: the loss
    falls and the final checkpoint lands under ``ckpts/<arch>``."""
    monkeypatch.chdir(tmp_path)
    hist = _example().main(["--device", "cpu", "--steps", "20"])
    assert len(hist) == 20 and hist[-1] < hist[0]
    assert os.listdir(tmp_path / "ckpts" / "olmo_1b") == [
        "step_0000020.npz"]
    assert "loss" in capsys.readouterr().out


def test_training_entry_points_refuse_missing_gpu(tmp_path, monkeypatch):
    from repro_torch.launch.train import train
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_smoke_config("olmo_1b")
    for call in (lambda: TS.make_train_state(cfg),
                 lambda: train("olmo_1b", steps=1),
                 lambda: _example().main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not (tmp_path / "ckpts").exists()
