"""The port's LM dry run (``repro_torch.launch.dryrun``) on fake worlds of
ranks, and the same sharded step on a real 4-rank gloo job.

  - the fake process group the dry runs rely on (a private module of
    PyTorch's): a world of 512 ranks starts and stops, a functional
    all-gather on a fake tensor returns the gathered shape;
  - the reference's ``WALKER_SCRIPT`` (``tests/test_dryrun.py``): smoke
    olmo's loss on a (4, 4) fake world, every rank's dot FLOPs x 16 within
    2% of the analytic count;
  - the windows: a 4-layer smoke config's full run equals its 1- and
    2-repeat extrapolation exactly (FLOPs, bytes, collective counts and
    payloads), and smoke xLSTM's prefill over two mLSTM chunks and 520
    sLSTM steps equals its trip windows' extrapolation;
  - every cell's status and skip reason against the reference's
    ``shape_applicable``;
  - a (2, 2) gloo job of 4 CPU ranks takes one smoke-olmo train step on
    DTensors placed by the rules: its loss and gradients equal the
    unsharded port's within 1e-5 relative, and each rank's argument bytes
    and collective payloads by kind equal the dry run of that rank;
  - a second such job runs every mesh path (``ARCH_CASES``): each
    config's loss, gradients, prefill and decode logits against the
    unsharded port's;
  - the mesh cache writes raise where the plain ones do, and for a
    prompt after earlier positions; a trip window opens only on fake
    tensors.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_shard import spawn_ranks, wait_all  # noqa: E402

TRAIN = dict(kind="train", seq_len=32, global_batch=4)


def _smoke_f32(arch="olmo_1b", layers=None):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import cut_config
    cfg = dataclasses.replace(get_smoke_config(arch),
                              activation_dtype="float32",
                              param_dtype="float32")
    return cut_config(cfg, {"group0": layers}) if layers else cfg


def test_fake_world_of_512_ranks():
    """What the dry runs take from ``torch.testing._internal``'s fake
    process group: 512 ranks start and stop in one process, and a
    functional all-gather of a fake tensor over a mesh dim returns the
    gathered shape without moving anything."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    with fake_world(512, rank=7):
        assert dist.get_world_size() == 512 and dist.get_rank() == 7
        mesh = make_production_mesh(multi_pod=True)
        with FakeTensorMode():
            x = torch.empty(3, 5)
            y = funcol.all_gather_tensor(x, 0, mesh.get_group("data"))
            y = funcol.wait_tensor(y)
            assert tuple(y.shape) == (48, 5)
        with pytest.raises(RuntimeError):
            with fake_world(4):
                pass
    assert not dist.is_initialized()


def test_walker_matches_analytic_flops():
    """Smoke olmo's loss (no grad) on a (4, 4) fake world: one rank's dot
    FLOPs x 16 within 2% of the analytic count, as the reference's HLO
    walker is held."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.fake_stats import OpCounter
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.specs import train_batch_specs
    from repro_torch.models import model as M, sharded
    from repro_torch.sharding import rules as R
    from repro_torch.training import steps as S
    cfg = get_smoke_config("olmo_1b")
    B, S_, d, ff, V, L = 8, 64, 64, 256, 128, 2
    assert (cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers) == (d, ff, V, L)
    with fake_world(16):
        mesh = make_mesh((4, 4), ("data", "model"))
        with FakeTensorMode(), R.set_mesh(mesh):
            model = M.Model(cfg, device="cpu")
            sharded.shard_params(model, mesh, fresh=True)
            batch = train_batch_specs(cfg, S_, B, "cpu")
            counter = OpCounter()
            with counter, torch.no_grad():
                S.loss_fn(model, batch, cfg)
    per_layer = 2*B*S_*d*(4*d) + 2*B*S_*d*(3*ff) + 2*2*B*S_*S_*d
    total = L * per_layer + 2*B*S_*d*V
    got = counter.dot_flops * 16
    assert abs(got - total) / total < 0.02, (got, total)


def _exact(a: dict, b: dict):
    for k in ("dot_flops", "hbm_bytes", "ops", "collective_counts",
              "collective_bytes"):
        assert a[k] == b[k], (k, a[k], b[k])
    assert abs(a["wire_bytes"] - b["wire_bytes"]) <= 1e-6 * a["wire_bytes"]


def test_windows_extrapolate_exactly():
    """A 4-layer smoke config's train step run whole equals the windows'
    extrapolation from one and two repeats."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_world, make_mesh
    cfg = _smoke_f32(layers=4)
    with fake_world(16):
        mesh = make_mesh((4, 4), ("data", "model"))
        full = D.step_counts(cfg, TRAIN, mesh, "cpu")
        dry = D.lower_cell("olmo_1b", TRAIN, None, cfg=cfg, mesh=mesh,
                           device="cpu")
    assert dry["depths"] == {"group0": 4} and len(dry["windows"]) == 2
    assert dry["memory"]["temp_size_in_bytes"] == full["peak"]
    w = dry["walk"]
    _exact(full, {"dot_flops": w["dot_flops_per_device"],
                  "hbm_bytes": w["hbm_bytes_per_device"],
                  "ops": w["ops_per_device"],
                  "collective_counts": w["collective_counts"],
                  "collective_bytes": w["collective_by_kind"],
                  "wire_bytes": w["collective_wire_bytes_per_device"]})
    assert full["collective_bytes"]["all_reduce"] > 0


def test_trip_windows_extrapolate_exactly():
    """Smoke xLSTM's prefill over 520 tokens (two mLSTM chunks, 520 sLSTM
    steps) run whole equals the extrapolation from its layer and trip
    windows."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_world, make_mesh
    cfg = get_smoke_config("xlstm_350m")
    shape = dict(kind="prefill", seq_len=520, global_batch=2)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        full = D.step_counts(cfg, shape, mesh, "cpu")
        dry = D.lower_cell("xlstm_350m", shape, None, cfg=cfg, mesh=mesh,
                           device="cpu")
        part = D.step_counts(cfg, shape, mesh, "cpu",
                             dict(slstm=2, mlstm=1))
    assert dry["trips"] == {"slstm": 520, "mlstm": 2}
    assert part["ops"] < full["ops"]
    # the peak: never below the step's, at most 3% above it here
    temp = dry["memory"]["temp_size_in_bytes"]
    assert full["peak"] <= temp <= 1.03 * full["peak"], (temp, full["peak"])
    w = dry["walk"]
    _exact(full, {"dot_flops": w["dot_flops_per_device"],
                  "hbm_bytes": w["hbm_bytes_per_device"],
                  "ops": w["ops_per_device"],
                  "collective_counts": w["collective_counts"],
                  "collective_bytes": w["collective_by_kind"],
                  "wire_bytes": w["collective_wire_bytes_per_device"]})


def test_cell_statuses_match_reference(tmp_path):
    """Every (arch, shape) is applicable as the reference says; the
    skipped cells are written as skipped with its reason, on both
    meshes, without a run."""
    from repro.models.config import shape_applicable as ref_applicable
    import repro.configs as RC
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import SHAPES, shape_applicable
    n_ok = n_skip = 0
    for arch in D.LM_ARCHS:
        for shape in SHAPES:
            want = ref_applicable(RC.get_config(arch), shape)
            assert shape_applicable(get_config(arch), shape) == want
            if want[0]:
                n_ok += 1
                continue
            n_skip += 1
            for mk in ("single", "multipod"):
                rec = D.run_cell(arch, shape, mk, str(tmp_path))
                assert (rec["status"], rec["reason"]) == ("skipped",
                                                          want[1])
                assert json.loads((tmp_path / f"{arch}__{shape}__{mk}.json")
                                  .read_text())["status"] == "skipped"
    assert (2 * n_ok, 2 * n_skip) == (64, 16)


RANK = r"""
import json, os, sys, copy, dataclasses
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["DRONE_INIT"],
                        rank=rank, world_size=world)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.fake_stats import OpCounter
from repro_torch.models import model as M, sharded
from repro_torch.sharding import rules as R
from repro_torch.training import steps as S
from repro_torch.training.optimizer import adamw_init
spec = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_smoke_config("olmo_1b"),
                          activation_dtype="float32", param_dtype="float32")
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
model = M.init_model(cfg, seed=0, device="cpu")
rng = np.random.default_rng(0)
tok = torch.from_numpy(rng.integers(0, cfg.vocab, (spec["B"], spec["L"]))
                       .astype(np.int32))
batch = {"tokens": tok, "labels": tok}
ref = copy.deepcopy(model)
loss_r, _ = S.loss_fn(ref, batch, cfg)
loss_r.backward()
with R.set_mesh(mesh):
    sharded.shard_params(model, mesh)
    bpl = R.to_placements((("data",), None), mesh)
    sb = {k: sharded.shard_tensor(v, mesh, bpl) for k, v in batch.items()}
    state = S.TrainState(params=model, opt=adamw_init(model))
    args = sum(t.to_local().numel() * t.to_local().element_size()
               for t in list(model.parameters()) + list(state.opt.m.values())
               + list(state.opt.v.values()) + list(sb.values())) + 4
    loss, _ = S.loss_fn(model, sb, cfg)
    loss.backward()
    grads = {n: p.grad.full_tensor().numpy()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    counter = OpCounter()
    with counter:
        S.make_train_step(cfg)(state, sb)
    c = counter.counts()
out = spec["out"]
np.savez(os.path.join(out, f"grads_{rank}.npz"),
         **{"sharded/" + n: g for n, g in grads.items()},
         **{"ref/" + n: p.grad.numpy() for n, p in ref.named_parameters()})
with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
    json.dump(dict(loss=loss.full_tensor().item(), loss_ref=loss_r.item(),
                   args=args, counts=c), f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.fixture(scope="module")
def gloo22(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm22")
    spec = json.dumps(dict(B=TRAIN["global_batch"], L=TRAIN["seq_len"],
                           out=str(tmp)))
    procs = spawn_ranks(RANK, 4, [spec], tmp / "store")
    wait_all(procs, 300, [f"rank {r}" for r in range(4)])
    return [json.loads((tmp / f"rank_{r}.json").read_text())
            for r in range(4)], [dict(np.load(tmp / f"grads_{r}.npz"))
                                 for r in range(4)]


def test_gloo_train_step_matches_unsharded(gloo22):
    reports, grads = gloo22
    for r, (rep, g) in enumerate(zip(reports, grads)):
        assert abs(rep["loss"] - rep["loss_ref"]) <= 1e-5 * abs(
            rep["loss_ref"]), r
        names = [k[len("ref/"):] for k in g if k.startswith("ref/")]
        assert len(names) > 10
        for n in names:
            want, got = g["ref/" + n], g["sharded/" + n]
            scale = float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= 1e-5 * scale, (r, n)


def test_gloo_counts_equal_dry_run(gloo22):
    """Each rank's argument bytes and its step's collectives by kind
    (counts and payload bytes), FLOPs and bytes, as the dry run of that
    rank of a fake (2, 2) world says (rank 0 through ``lower_cell``'s
    windows, the others through one whole step)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_world, make_mesh
    reports, _ = gloo22
    cfg = _smoke_f32()
    for r, rep in enumerate(reports):
        with fake_world(4, rank=r):
            mesh = make_mesh((2, 2), ("data", "model"))
            if r == 0:
                dry = D.lower_cell("olmo_1b", TRAIN, None, cfg=cfg,
                                   mesh=mesh, device="cpu")
                w, args = dry["walk"], dry["memory"]["argument_size_in_bytes"]
                w = dict(dot_flops=w["dot_flops_per_device"],
                         hbm_bytes=w["hbm_bytes_per_device"],
                         collective_counts=w["collective_counts"],
                         collective_bytes=w["collective_by_kind"])
            else:
                w = D.step_counts(cfg, TRAIN, mesh, "cpu")
                a = D.argument_bytes(cfg, "train", TRAIN, mesh)
                args = a["params"] + a["opt"] + w["batch"]
        c = rep["counts"]
        assert rep["args"] == args, r
        for k in ("collective_bytes", "collective_counts", "dot_flops",
                  "hbm_bytes"):
            assert c[k] == w[k], (r, k)
        assert set(c["collective_bytes"]) >= {"all_gather", "all_reduce",
                                              "reduce_scatter"}


ARCH_RANK = r"""
import copy, dataclasses, json, os, sys, traceback
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["DRONE_INIT"],
                        rank=rank, world_size=world)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.variants import optimized
from repro_torch.models import model as M, moe, sharded
from repro_torch.sharding import rules as R
from repro_torch.training import steps as S
spec = json.loads(sys.argv[1])
B, L, P, N = spec["B"], spec["L"], spec["P"], spec["N"]
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def run(model, cfg, ins, put):
    # the loss and every gradient, then a prefill of P tokens and N decode
    # steps' logits
    b = {k: put(v) for k, v in ins.items() if k != "steps"}
    loss, _ = S.loss_fn(model, b, cfg)
    loss.backward()
    out = {"loss": loss}
    out.update({"grad/" + n: p.grad for n, p in model.named_parameters()
                if p.grad is not None})
    model.zero_grad(set_to_none=True)
    pb = {k: v for k, v in b.items() if k not in ("tokens", "labels")}
    pb["tokens"] = put(ins["tokens"][:, :P].contiguous())
    pre = cfg.frontend_len if cfg.frontend and not cfg.n_enc_layers else 0
    lg, caches = M.prefill(model, pb, cfg, spec["max_len"] + pre)
    out["logits/0"] = lg
    extra = {}
    if cfg.n_enc_layers:
        with torch.no_grad():
            extra["memory"] = M._encode(model, pb, cfg)
    for i in range(N):
        lg, caches = M.decode_step(model, caches, dict(
            tokens=put(ins["tokens"][:, P + i:P + i + 1].contiguous()),
            **extra), cfg)
        out[f"logits/{i + 1}"] = lg
    return out


for i, (name, (arch, over, opt)) in enumerate(spec["cases"].items()):
    try:
        cfg = dataclasses.replace(get_smoke_config(arch), **dict(
            dict(activation_dtype="float32", param_dtype="float32"),
            **over))
        cfg = optimized(cfg) if opt else cfg
        model = M.init_model(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(1)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, L))
                               .astype(np.int32))
        ins = {"tokens": tok, "labels": tok}
        if cfg.frontend:
            ins["frontend"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim or cfg.d_model))
                .astype(np.float32))
        plain = copy.deepcopy(model)
        with R.set_mesh(mesh):
            sharded.shard_params(model, mesh)

            def put(t):
                return sharded.shard_tensor(t, mesh, R.to_placements(
                    (("data",),) + (None,) * (t.ndim - 1), mesh))

            res = run(model, cfg, ins, put)
            full = {k: v.full_tensor().detach().numpy()
                    for k, v in res.items()}
        if rank == i % world:      # the cases' unsharded runs in turn
            # the hierarchical dispatch in one group per data-parallel
            # rank, as on the mesh
            groups = moe._dp_groups
            moe._dp_groups = lambda n: 2 if n % 2 == 0 else 1
            try:
                ref = run(copy.deepcopy(plain), cfg, ins, lambda t: t)
                # the rounding floor: the same with every embedding entry
                # moved by one float32 ulp, random signs
                with torch.no_grad():
                    e = plain.embed
                    ulp = torch.nextafter(e.abs(), torch.tensor(np.inf)) \
                        - e.abs()
                    sign = torch.from_numpy(np.random.default_rng(2).choice(
                        [-1.0, 1.0], e.shape).astype(np.float32))
                    e.add_(ulp * sign)
                ulp1 = run(plain, cfg, ins, lambda t: t)
            finally:
                moe._dp_groups = groups
            np.savez(os.path.join(spec["out"], name + ".npz"),
                     **{"ref/" + k: v.detach().numpy()
                        for k, v in ref.items()},
                     **{"ulp/" + k: v.detach().numpy()
                        for k, v in ulp1.items()},
                     **{"mesh/" + k: v for k, v in full.items()})
    except Exception:
        with open(os.path.join(spec["out"], f"{name}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
dist.destroy_process_group()
print("RANK_OK", rank)
"""

#: the mesh paths: attention and the dense MLP (olmo), MLA, the global MoE
#: and MTP (deepseek), the hierarchical dispatch and the two levers of the
#: ``opt`` variant, Mamba with a MoE (jamba), the mLSTM and sLSTM (xlstm),
#: the encoder, cross-attention and the frame frontend (seamless), the
#: patch frontend's adapter and prefix (internvl2), and GQA with kv heads
#: that do not split over ``model`` = 2 (one kv head for 8 query heads; 3
#: for 6, which the query heads of a rank read unevenly)
ARCH_CASES = {
    "olmo": ("olmo_1b", {}, False),
    "deepseek": ("deepseek_v3_671b", {}, False),
    "deepseek_opt": ("deepseek_v3_671b", {}, True),
    "jamba": ("jamba_v01_52b", {}, False),
    "xlstm": ("xlstm_350m", {}, False),
    "seamless": ("seamless_m4t_large_v2", {}, False),
    "internvl2": ("internvl2_26b", {}, False),
    "gqa_kv1": ("llama3_405b", {"n_kv_heads": 1}, False),
    "gqa_kv3": ("phi4_mini_3p8b", {"n_kv_heads": 3}, False),
}


@pytest.fixture(scope="module")
def gloo_archs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm22archs")
    spec = json.dumps(dict(B=4, L=16, P=6, N=4, max_len=16, out=str(tmp),
                           cases=ARCH_CASES))
    procs = spawn_ranks(ARCH_RANK, 4, [spec], tmp / "store")
    wait_all(procs, 600, [f"rank {r}" for r in range(4)])
    return tmp


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_gloo_arch_matches_unsharded(gloo_archs, case):
    """Each mesh path on a (2, 2) gloo job of 4 CPU ranks against the
    unsharded port on the same weights: the loss and every gradient of a
    train step, then a 6-token prefill into a 16-position cache (two
    blocks of 8 over ``model``) and 4 decode steps (positions 6-9, across
    the blocks), each step's logits. Each number within 1e-5 of its
    scale, or where float32 rounding alone moves it further, within what
    moving every embedding entry by one ulp moves it in the unsharded
    port (Jamba's Mamba gradients: up to 8e-5 of their scale)."""
    errs = sorted(gloo_archs.glob(f"{case}_*.err"))
    assert not errs, errs[0].read_text()
    got = dict(np.load(gloo_archs / f"{case}.npz"))
    keys = [k[len("ref/"):] for k in got if k.startswith("ref/")]
    assert {"loss", "logits/0", "logits/4"} <= set(keys)
    assert sum(k.startswith("grad/") for k in keys) > 10
    for k in keys:
        want, mesh = got["ref/" + k], got["mesh/" + k]
        assert mesh.shape == want.shape, k
        floor = float(np.abs(got["ulp/" + k] - want).max())
        bar = max(1e-5 * float(np.abs(want).max()), floor)
        assert float(np.abs(mesh - want).max()) <= bar, (k, bar)


@pytest.mark.parametrize("arch", ["olmo_1b", "deepseek_v3_671b"])
def test_mesh_cache_writes_raise(arch):
    """The mesh paths of attention and MLA raise where the plain cache
    write raises (a token past the cache's end), and for a prompt
    written after earlier positions, which they do not support (the
    plain path does)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models import model as M, sharded
    from repro_torch.sharding import rules as R
    cfg = _smoke_f32(arch)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        with FakeTensorMode(), R.set_mesh(mesh):
            model = M.Model(cfg, device="cpu")
            sharded.shard_params(model, mesh, fresh=True)

            def batch_of(*shape, dtype=torch.int32):
                return sharded.shard_tensor(
                    torch.zeros(shape, dtype=dtype), mesh,
                    R.to_placements((("data",),) + (None,) * (len(shape)
                                                             - 1), mesh),
                    fresh=True)

            caches = M.init_cache(cfg, 4, 8, device="cpu")
            for c in caches:
                c["idx"] = 8
            with pytest.raises(ValueError, match="runs past"):
                M.decode_step(model, caches, {"tokens": batch_of(4, 1)},
                              cfg)
            cache = dict(caches[0], idx=2)
            with pytest.raises(ValueError, match="position 0"):
                model.blocks[0].mixer(
                    batch_of(4, 3, cfg.d_model, dtype=torch.float32),
                    positions=torch.arange(2, 5), cache=cache)
            with pytest.raises(ValueError, match="runs past"):
                model.blocks[0].mixer(
                    batch_of(4, 9, cfg.d_model, dtype=torch.float32),
                    positions=torch.arange(9), cache=dict(cache, idx=0))


def test_trip_window_only_on_fake_tensors():
    """A trip window's skipped trips are stand-ins with no values, so it
    is refused outside ``FakeTensorMode``."""
    from repro_torch.models import ssm
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        with ssm.trip_window(lambda outs, n: outs, slstm=1):
            pass
    assert ssm._TRIPS.slstm is None


def test_lm_roofline_row(tmp_path):
    """An LM cell's record through the roofline: its three terms, the
    reference's ``model_flops`` for the same record, a table row and a
    suggestion."""
    from repro.launch import roofline as ref_roofline
    from repro_torch.launch import dryrun as D, roofline
    rec = D.run_cell("olmo_1b", "decode_32k", "single", str(tmp_path))
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    row = roofline.analyze_record(rec, hbm_cap=80 * 10**9)
    assert row["model_flops"] == ref_roofline.model_flops(rec)
    assert set(row["terms"]) == {"compute_s", "memory_s", "collective_s"}
    assert row["fits_hbm"] and 0 < row["useful_ratio"] < 2
    assert "olmo_1b | decode_32k | single" in roofline.markdown_table([row])
    assert roofline.suggestion(row) and "sweep" not in roofline.suggestion(
        row)
    assert roofline.load_all(str(tmp_path), 80 * 10**9)[0]["arch"] == \
        "olmo_1b"
