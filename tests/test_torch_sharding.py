"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's.

The reference runs once, in a subprocess on 512 fake XLA devices (as
``tests/test_dryrun.py`` runs it): ``param_shardings(mesh, model_specs(cfg),
eval_shape(init_model))`` and the ``decode_32k`` ``cache_shardings`` for
every LM arch's full config on both production meshes, hand-picked
``logical_to_spec`` / divisibility cases, and ``roofline.param_counts``.
The port builds the same meshes in a fake world of 512 ranks, its
parameters on the ``meta`` device, and every spec must be the
reference's: the reference's stacked leaves are split into the port's
layers by ``interop._unstacked`` (their leading ``"layers"`` entry, None,
dropped). With no mesh active the sharding hints and the
``fsdp_gather_weights`` / ``tp_bf16_payload`` levers leave every LM
output bit-identical.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

#: (logical axes, shape) cases for logical_to_spec and the divisibility drop
SPEC_CASES = [
    (("embed", "embed"), (4096, 4096)),
    (("vocab", "embed"), (50304, 2048)),
    (("vocab", "embed"), (256206, 1024)),
    (("embed", "kv_heads", "qkv"), (4096, 8, 128)),
    (("embed", "heads", "qkv"), (4096, 24, 128)),
    (("experts", "embed", "ff_expert"), (16, 4096, 6400)),
    (("batch", "kv_seq", "kv_heads", None), (128, 32768, 8, 128)),
    (("batch", "embed"), (1, 1024)),
    (("inner", None), (8192, 16)),
    ((None, "inner"), (4, 8190)),
    (("layers", "embed", "ff"), (3, 4096, 14336)),
]

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
from repro.configs import ARCHS, get_config
from repro.launch import roofline
from repro.launch.mesh import make_production_mesh
from repro.models import model as M
from repro.sharding import rules as R

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]

def tree(t):
    return jax.tree.map(lambda s: spec(s.spec), t,
                        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))

cases = json.loads(sys.argv[1])
out = {"archs": {}, "cases": {}, "params": {}}
meshes = {"single": make_production_mesh(multi_pod=False),
          "multipod": make_production_mesh(multi_pod=True)}
for arch in ARCHS:
    if arch == "drone_graph":
        continue
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda k: M.init_model(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    caches = M.init_cache(cfg, 128, 32768 + (
        cfg.frontend_len if cfg.frontend and not cfg.n_enc_layers else 0))
    out["archs"][arch] = {
        mk: {"params": tree(R.param_shardings(mesh, M.model_specs(cfg),
                                              shapes)),
             "caches": tree(R.cache_shardings(mesh, M.cache_specs(cfg),
                                              caches))}
        for mk, mesh in meshes.items()}
    out["params"][arch] = list(roofline.param_counts(arch))
for mk, mesh in meshes.items():
    rules = R.rules_for(mesh)
    got = []
    for axes, shape in cases:
        axes = tuple(axes)
        sds = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
        fixed = R.param_shardings(mesh, {"x": axes}, {"x": sds})["x"].spec
        got.append([spec(R.logical_to_spec(axes, rules)), spec(fixed)])
    out["cases"][mk] = got
print(json.dumps(out))
"""


def _spec(s):
    return tuple(tuple(e) if isinstance(e, list) else e for e in s)


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE,
                          json.dumps(SPEC_CASES)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def meshes():
    """The production meshes in a fake world of 512 ranks."""
    from repro_torch.launch.mesh import (fake_world, make_mesh,
                                         make_production_mesh)
    with fake_world(512):
        yield {"single": make_production_mesh(multi_pod=False),
               "multipod": make_production_mesh(multi_pod=True),
               "other": make_mesh((4, 4), ("data", "model"))}


def _unstacked(cfg, tree):
    """The reference's per-leaf specs keyed by the port's names: each
    stacked leaf's spec without its leading 'layers' entry, once per
    repeat (``interop._unstacked``'s mapping)."""
    from repro_torch.interop import _unstacked

    def strip(t, n):
        if isinstance(t, dict):
            return {k: strip(v, n) for k, v in t.items()}
        a = np.empty(n, dtype=object)
        for i in range(n):
            a[i] = _spec(t[1:])
        return a

    stacked = dict(tree)
    stacked["blocks"] = [[strip(pos, n) for pos in grp] for grp, (_, n) in
                         zip(tree["blocks"], cfg.scan_groups())]
    if "encoder" in tree:
        stacked["encoder"] = [strip(tree["encoder"][0], cfg.n_enc_layers)]
    flat = {k: v for k, v in tree.items() if k not in ("blocks", "encoder")}

    def leaves(t):
        return {k: _spec(v) if isinstance(v, list) else leaves(v)
                for k, v in t.items()}
    stacked.update(leaves(flat))
    return _unstacked(stacked, cfg)


ARCHS = ["deepseek_v3_671b", "phi35_moe_42b", "olmo_1b", "phi4_mini_3p8b",
         "llama3_405b", "stablelm_3b", "internvl2_26b",
         "seamless_m4t_large_v2", "jamba_v01_52b", "xlstm_350m"]


def test_archs_are_the_references(ref):
    from repro_torch.launch.dryrun import LM_ARCHS
    assert sorted(LM_ARCHS) == sorted(ref["archs"]) == sorted(ARCHS)


@pytest.mark.parametrize("mk", ["single", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_match_reference(ref, meshes, arch, mk):
    """Every parameter's spec (after the divisibility drop) is the
    reference's for the same leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, model_specs
    from repro_torch.sharding import rules as R
    cfg = get_config(arch)
    want = _unstacked(cfg, ref["archs"][arch][mk]["params"])
    model = Model(cfg, device="meta")
    named = dict(model.named_parameters())
    got = R.param_shardings(meshes[mk], model_specs(cfg), named)
    assert set(got) == set(want) == set(named)
    bad = {n: (got[n].spec, want[n]) for n in named
           if got[n].spec != tuple(want[n])}
    assert not bad, list(bad.items())[:5]
    # placements: a spec entry's mesh dims each shard its tensor dim
    names = meshes[mk].mesh_dim_names
    for n, sh in got.items():
        for d, entry in enumerate(sh.spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                assert sh.placements[names.index(a)].dim == d, n


@pytest.mark.parametrize("mk", ["single", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placements_match_reference(ref, meshes, arch, mk):
    """Every decode_32k cache field's spec is the reference's, layer by
    layer (the host-int ``idx`` has none in the port)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import cache_len
    from repro_torch.models import model as M
    from repro_torch.sharding import rules as R
    cfg = get_config(arch)
    layers = M.cache_layers(cfg, 128, cache_len(cfg, 32768),
                            torch.device("meta"))
    got = R.cache_shardings(meshes[mk], M.cache_specs(cfg), layers)
    ref_tree = ref["archs"][arch][mk]["caches"]
    want = []
    for grp, (pattern, n_rep) in zip(ref_tree, cfg.scan_groups()):
        for _ in range(n_rep):
            for pos in grp:
                want.append({f: _spec(s[1:]) for f, s in pos.items()
                             if f != "idx"})
    assert len(got) == len(want) == cfg.n_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert {f: s.spec for f, s in g.items()} == w, i


@pytest.mark.parametrize("mk", ["single", "multipod"])
def test_logical_to_spec_and_divisibility(ref, meshes, mk):
    from repro_torch.sharding import rules as R
    mesh = meshes[mk]
    for (axes, shape), (want_spec, want_fixed) in zip(SPEC_CASES,
                                                     ref["cases"][mk]):
        assert R.logical_to_spec(axes, R.rules_for(mesh)) == \
            _spec(want_spec), axes
        got = R.param_shardings(mesh, {"x": axes}, {"x": shape})["x"]
        assert got.spec == _spec(want_fixed), (axes, shape)


def test_pod_major_placements(meshes):
    """A dim over ('pod', 'data') shards on both mesh dims, pod first; the
    other order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding import rules as R
    mesh = meshes["multipod"]
    assert R.to_placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert R.to_placements((None, None), meshes["single"]) == \
        [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        R.to_placements((("data", "pod"),), mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(ref, arch):
    from repro_torch.launch.roofline import param_counts
    assert list(param_counts(arch)) == ref["params"][arch]


def test_optimized_variant_matches_reference():
    import repro.configs as RC
    from repro.configs.variants import optimized as ref_opt
    from repro_torch.configs import get_config
    from repro_torch.configs.variants import optimized
    for arch in ARCHS:
        got = dataclasses.asdict(optimized(get_config(arch)))
        want = dataclasses.asdict(ref_opt(RC.get_config(arch)))
        assert got == want, arch


def _outputs(cfg, seed=0):
    """Forward logits, a prefill's logits and two decode steps' logits of
    ``cfg``'s model drawn from ``seed``, on the CPU."""
    from repro_torch.models import model as M
    torch.manual_seed(0)
    model = M.init_model(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(1)
    B, L = 2, 8
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, L)).astype(np.int32))}
    if cfg.frontend:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim or cfg.d_model))
            .astype(np.float32))
    out = []
    with torch.no_grad():
        out.append(M.forward(model, batch, cfg)[0])
        extra = cfg.frontend_len if cfg.frontend and not cfg.n_enc_layers \
            else 0
        lg, caches = M.prefill(model, batch, cfg, L + extra + 2)
        out.append(lg)
        step = {"tokens": batch["tokens"][:, :1]}
        if cfg.n_enc_layers:
            step["memory"] = M._encode(model, batch, cfg)
        for _ in range(2):
            lg, caches = M.decode_step(model, caches, step, cfg)
            out.append(lg)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_no_mesh_outputs_bit_identical(arch):
    """Without a mesh the hints are identities and the two layout levers
    change no bit of any LM output."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import _dp_groups
    from repro_torch.sharding import rules as R
    assert R.get_mesh() is None
    x = torch.ones(4, 8)
    assert R.maybe_constrain(x, ("pod", "data"), None) is x
    assert R.replicate_partial(x) is x
    assert R.constrain_gathered({"w": x}, {"w": ("embed", "ff")})["w"] is x
    assert _dp_groups(64) == 1
    cfg = get_smoke_config(arch)
    levers = dataclasses.replace(cfg, fsdp_gather_weights=True,
                                 tp_bf16_payload=True)
    for a, b in zip(_outputs(cfg), _outputs(levers)):
        assert torch.equal(a, b)
