"""The train-step parity check shared by ``tests/test_torch_train_archs*.py``:
the port's ``make_train_step`` against the reference's (``jax.jit``, as
``tests/test_archs.py:39-51`` runs it) on the reference's smoke-config
state carried over, the same batch, 5 steps.

Tolerances (float32 on the CPU):

- Step 1's gradient: every leaf within ``GRAD_TOL`` (1e-5) of that leaf's
  largest magnitude, except Jamba's and xLSTM's, held at the fixed
  ``GRAD_BAR`` of their arch. Their Mamba scan and mLSTM sum long chains
  of float32 terms, and the reference's own float32 gradient sits that
  far from the same reference evaluated in float64. The readings, as
  ``python tests/_train_parity.py`` prints them (the reference with x64
  on and its float32 read as float64, on the same weights and batch;
  the largest distance over all leaves, relative to each leaf's scale):

  ==================  ===========  ===========  =============
  arch                reference    port         port - ref
  ==================  ===========  ===========  =============
  jamba_v01_52b       1.36e-05     2.32e-05     1.64e-05
  xlstm_350m          1.46e-05     2.04e-05     1.95e-05
  (the other 8)       <= 2.2e-06   <= 2.7e-06   <= 3.5e-06
  ==================  ===========  ===========  =============

  Each bar is twice the reference's reading, rounded up; it does not
  move with the port. ``tests/test_torch_train_archs*.py`` plant a
  relative error of 5e-5 (olmo) and 6e-5 (xLSTM) in one leaf's gradient
  and show that the check fails.
  The gradient is read from the first moments after step 1, which from
  zero moments are ``(1 - b1)`` times the clipped gradient on both sides
  (the reference's step returns no gradient, and a second compile of its
  backward would double the suite's time); the clip's scale comes from
  ``grad_norm``, compared on its own.
- Every step's ``loss`` and ``mtp_loss`` within 1e-5 relative; step 1's
  ``grad_norm`` within 1e-5 relative, later steps' within 1e-4: from
  step 2 on the parameters differ by rounding, and the recurrent archs'
  norm moves by up to ~2e-5 with that, where the loss, flat to first
  order, does not. ``moe_dropped`` within 1e-6; ``lr`` within 1e-6
  relative (the compiled reference fuses the schedule's float32 ops and
  is an ulp off its eager self at some steps).
- The parameters' change over the 5 steps, leaf by leaf: ``||dp_port -
  dp_ref|| / ||dp_ref|| <= PARAM_RTOL`` (2e-3; a leaf the reference does
  not move must not move). An element whose gradient sits at rounding
  noise can take AdamW's full step either way, up to ``2 * sum_t lr_t
  R_t`` (``param_bar``) apart, so the elementwise distance is held to
  that too; the relative bar on the whole change is what fails a port
  that does not step, or steps the wrong way (a relative 1 or 2). The
  readings: at most 6.0e-4 (xLSTM), 2.9e-4 (Jamba), 1.4e-4 (the other 8).
"""
import json
import math
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as RC
from repro.training import steps as RS
import repro_torch.configs as TC
from repro_torch.interop import _unstacked, train_state_from_numpy
from repro_torch.training import steps as TS

B1, B2 = 0.9, 0.95
STEPS = 5
SCHEDULE = dict(peak_lr=1e-3, warmup=2, total=50)
GRAD_TOL = 1e-5
GRAD_BAR = {"jamba_v01_52b": 3e-5, "xlstm_350m": 3e-5}
CLIP = 1.0
LOSS_RTOL = 1e-5
LATER_NORM_RTOL = 1e-4
LR_RTOL = 1e-6
DROPPED_ATOL = 1e-6
PARAM_RTOL = 2e-3
# tests/test_archs.py's LM_ARCHS
ARCHS = ["olmo_1b", "phi4_mini_3p8b", "stablelm_3b", "llama3_405b",
         "internvl2_26b", "seamless_m4t_large_v2", "phi35_moe_42b",
         "deepseek_v3_671b", "jamba_v01_52b", "xlstm_350m"]


def batch(cfg, key, B=4, S_len=32):
    """``tests/test_archs.py``'s ``_batch`` as numpy."""
    toks = jax.random.randint(key, (B, S_len), 0, cfg.vocab)
    out = {"tokens": toks, "labels": jnp.roll(toks, -1, axis=1)}
    if cfg.frontend:
        out["frontend"] = jax.random.normal(
            key, (B, cfg.frontend_len, cfg.frontend_dim)) * 0.02
    return {k: np.asarray(v) for k, v in out.items()}


def adam_ratio_bound(t: int) -> float:
    """``R_t``: the largest ``|mhat| / sqrt(vhat)`` after ``t`` steps from
    zero moments, over any gradient sequence (Cauchy-Schwarz over the
    moment sums)."""
    a = [(1 - B1) * B1 ** (t - i) / (1 - B1 ** t) for i in range(1, t + 1)]
    w = [(1 - B2) * B2 ** (t - i) / (1 - B2 ** t) for i in range(1, t + 1)]
    return math.sqrt(sum(x * x / y for x, y in zip(a, w)))


def param_bar(lrs) -> float:
    return 2 * sum(lr * adam_ratio_bound(t)
                   for t, lr in enumerate(lrs, start=1))


def _port(state, cfg):
    """A reference state as the port's (every leaf carried by name)."""
    return train_state_from_numpy(jax.tree.map(np.asarray, state), cfg,
                                  device="cpu")


def _setup(arch: str, plant):
    """(reference config, port config, reference state, port state, numpy
    batch) of the parity test; ``plant``, ``(name, factor)``, scales that
    leaf's gradient in the port through a hook."""
    rcfg, tcfg = RC.get_smoke_config(arch), TC.get_smoke_config(arch)
    key = jax.random.PRNGKey(1)
    rstate = RS.make_train_state(key, rcfg)
    tstate = _port(rstate, tcfg)
    if plant is not None:
        tstate.params.get_parameter(plant[0]).register_hook(
            lambda g: g * plant[1])
    return rcfg, tcfg, rstate, tstate, batch(rcfg, key)


def _gradient_pairs(tstate, rstate, tcfg) -> dict:
    """``{name: (port, reference)}`` float64 clipped gradients of step 1,
    read from the first moments."""
    ref_m = _port(rstate, tcfg).opt.m
    return {n: (m.double() / (1 - B1), ref_m[n].double() / (1 - B1))
            for n, m in tstate.opt.m.items()}


def step1_gradients(arch: str, plant=None):
    """One step of both train steps on the parity test's state and batch:
    (``_gradient_pairs``, the reference's initial state, the batch);
    ``plant`` as in ``_setup``."""
    rcfg, tcfg, rstate, tstate, b = _setup(arch, plant)
    tstate, _ = TS.make_train_step(tcfg, **SCHEDULE)(
        tstate, {k: torch.from_numpy(v.copy()) for k, v in b.items()})
    r1, _ = jax.jit(RS.make_train_step(rcfg, **SCHEDULE))(
        rstate, {k: jnp.asarray(v) for k, v in b.items()})
    return _gradient_pairs(tstate, r1, tcfg), rstate, b


def check_gradients(arch: str, pairs: dict) -> float:
    """Hold every leaf of step 1's port gradient to the reference's within
    the arch's bar of the leaf's scale; returns the largest distance."""
    bar, worst = GRAD_BAR.get(arch, GRAD_TOL), 0.0
    for name, (got, want) in pairs.items():
        scale = float(want.abs().max())
        diff = float((got - want).abs().max())
        worst = max(worst, diff / scale if scale else diff)
        assert diff <= bar * scale, (
            f"{arch} step-1 gradient of {name}: {diff:.3e} > "
            f"{bar:g} x {scale:.3e}")
    return worst


def check_train_steps(arch: str) -> dict:
    """The whole parity check (the module's docstring)."""
    rcfg, tcfg, rstate, tstate, b = _setup(arch, None)
    p0 = {n: p.detach().clone()
          for n, p in tstate.params.named_parameters()}
    rbatch = {k: jnp.asarray(v) for k, v in b.items()}
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    rstep = jax.jit(RS.make_train_step(rcfg, **SCHEDULE))
    tstep = TS.make_train_step(tcfg, **SCHEDULE)
    rl, tl, lrs = [], [], []
    grad_worst = 0.0
    for i in range(STEPS):
        rstate, rm = rstep(rstate, rbatch)
        tstate, tm = tstep(tstate, tbatch)
        rl.append(float(rm["loss"]))
        tl.append(float(tm["loss"]))
        lrs.append(float(rm["lr"]))
        np.testing.assert_allclose(tl[-1], rl[-1], rtol=LOSS_RTOL,
                                   err_msg=f"{arch} step {i + 1} loss")
        if i == 0:
            grad_worst = check_gradients(
                arch, _gradient_pairs(tstate, rstate, tcfg))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]),
                                   rtol=LOSS_RTOL if i == 0
                                   else LATER_NORM_RTOL,
                                   err_msg=f"{arch} step {i + 1} grad_norm")
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=LR_RTOL, atol=0)
        np.testing.assert_allclose(float(tm["moe_dropped"]),
                                   float(rm["moe_dropped"]),
                                   atol=DROPPED_ATOL)
        assert ("mtp_loss" in tm) == ("mtp_loss" in rm) == bool(
            rcfg.mtp_depth)
        if "mtp_loss" in rm:
            np.testing.assert_allclose(float(tm["mtp_loss"]),
                                       float(rm["mtp_loss"]),
                                       rtol=LOSS_RTOL)
    assert all(np.isfinite(tl)), tl
    assert tl[-1] < tl[0] and rl[-1] < rl[0], (tl, rl)
    bar = param_bar(lrs)
    ref = _port(rstate, tcfg)
    worst, worst_rel = 0.0, 0.0
    for name, p in tstate.params.named_parameters():
        got = p.detach().double() - p0[name].double()
        want = ref.params.get_parameter(name).detach().double() \
            - p0[name].double()
        diff = float((got - want).abs().max())
        rel = float((got - want).norm() / want.norm()) if want.any() \
            else float(got.abs().max())
        worst, worst_rel = max(worst, diff), max(worst_rel, rel)
        assert diff <= bar, (arch, name, diff, bar)
        assert rel <= PARAM_RTOL, (
            f"{arch} change of {name}: relative distance {rel:.3e} > "
            f"{PARAM_RTOL:g}")
    assert int(tstate.opt.step) == int(rstate.opt.step) == STEPS
    return dict(losses=tl, ref_losses=rl, bar=bar, worst_param=worst,
                worst_param_rel=worst_rel, grad_worst=grad_worst)


# --------------------------------------------------------------------------- #
# the readings behind GRAD_BAR: python tests/_train_parity.py [arch ...]
# --------------------------------------------------------------------------- #
_FLOAT64_REFERENCE = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import dataclasses
import repro.configs as RC
import repro.models.layers, repro.models.model, repro.models.moe
import repro.models.ssm
from repro.training import steps as RS

arch, src, dst = sys.argv[1:]
cfg = RC.get_smoke_config(arch)
like = jax.eval_shape(lambda: RS.make_train_state(jax.random.PRNGKey(0),
                                                  cfg).params)
with np.load(src) as z:
    leaves = [jnp.asarray(z[f"p{i}"], jnp.float64)
              for i in range(len(jax.tree.leaves(like)))]
    b = {k[2:]: z[k] for k in z.files if k.startswith("b_")}
params = jax.tree.unflatten(jax.tree.structure(like), leaves)
b = {k: jnp.asarray(v, jnp.float64) if v.dtype.kind == "f" else
     jnp.asarray(v) for k, v in b.items()}


class F64:
    # every float32 the reference names reads as float64
    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


for mod in (repro.models.layers, repro.models.model, repro.models.moe,
            repro.models.ssm, RS):
    mod.jnp = F64()
cfg = dataclasses.replace(cfg, param_dtype="float64",
                          activation_dtype="float64")
g = jax.jit(jax.grad(lambda p: RS.loss_fn(p, b, cfg)[0]))(params)
leaves = [np.asarray(x, np.float64) for x in jax.tree.leaves(g)]
norm = np.sqrt(sum(float((x * x).sum()) for x in leaves))
clip = min(1.0, 1.0 / max(norm, 1e-9))
np.savez(dst, *[x * clip for x in leaves])
"""


def reference_float64_gradient(arch: str, rstate, b: dict) -> dict:
    """``{port name: float64 clipped gradient}`` of the reference itself,
    evaluated with x64 on and every float32 it names read as float64, on
    ``rstate``'s parameters and ``b``, in a process of its own."""
    tcfg = TC.get_smoke_config(arch)
    leaves = jax.tree.leaves(rstate.params)
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(src, **{f"p{i}": np.asarray(x, np.float32)
                         for i, x in enumerate(leaves)},
                 **{f"b_{k}": v for k, v in b.items()})
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, "-c", _FLOAT64_REFERENCE, arch, src,
                        dst], env=env, check=True)
        with np.load(dst) as z:
            grads = [z[f"arr_{i}"] for i in range(len(leaves))]
    tree = jax.tree.unflatten(jax.tree.structure(rstate.params), grads)
    return {n: torch.from_numpy(np.ascontiguousarray(a))
            for n, a in _unstacked(tree, tcfg).items()}


def _distance(pairs: dict, truth: dict, side: int) -> float:
    return max(float((p[side] - truth[n]).abs().max())
               / float(truth[n].abs().max())
               for n, p in pairs.items() if truth[n].abs().max() > 0)


def readings(arch: str) -> dict:
    pairs, rstate, b = step1_gradients(arch)
    truth = reference_float64_gradient(arch, rstate, b)
    return {"arch": arch, "reference": _distance(pairs, truth, 1),
            "port": _distance(pairs, truth, 0),
            "port_minus_reference": max(
                float((g - w).abs().max()) / float(w.abs().max())
                for g, w in pairs.values() if w.abs().max() > 0)}


if __name__ == "__main__":
    for a in sys.argv[1:] or ARCHS:
        print(json.dumps(readings(a)), flush=True)
