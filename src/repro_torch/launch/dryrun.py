"""LM dry run: every (architecture x input shape x mesh) cell of the JAX
package's ``launch/dryrun.py``, on H100s.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh both [--variant opt] [--out DIR] \\
        [--workers 8]
    PYTHONPATH=src python -m repro_torch.launch.roofline

A cell runs the step a user would run: the train step (loss, backward
with remat, the clip and AdamW, ``training.steps.make_train_step``), the
prefill (``make_prefill_step``) or one decode step (``make_serve_step``),
as rank 0 of a fake world of ranks, one per card of the production mesh:
``(16, 16)`` as ``("data", "model")`` (one pod, 256 ranks) or ``(2, 16,
16)`` as ``("pod", "data", "model")`` (two pods, 512). Every parameter,
moment, batch and cache is a DTensor over fake tensors
(``FakeTensorMode``: shapes, dtypes, no storage), placed by the sharding
rules (``sharding.rules``: ``models.model.model_specs`` /
``cache_specs``); the models run their mesh paths
(``models/sharded.py``). ``launch.fake_stats.OpCounter`` counts what the
rank's local ops move and compute and the collectives DTensor issues.

Trip counts come from windows: per scan group (``cfg.scan_groups()``;
the encoder of an encoder-decoder is one more group) the step runs with
every group at one repeat, then with that group at two, and the
difference is multiplied out to the group's depth. FLOPs, bytes,
collective counts and payloads are linear in the repeats, so the
extrapolation is exact. The peak of live bytes grows with the repeats
(the remat's saved block inputs, one per layer) and, once, with a
loop's trips (its state kept per trip, read from two deeper windows of
``DEEP_TRIPS`` trips); ``extrapolate`` says how.
Argument bytes are the full-depth model's local shards (and AdamW's
moments, the batch, the caches), from their shapes.

A record (``{arch}__{shape}__{mesh}{__opt}.json``) holds ``status`` (ok /
skipped / error), ``reason``, ``family``, ``variant``, ``memory``
(argument, temporary and output bytes per rank), ``collectives`` (payload
bytes per rank by kind and the calls), ``walk`` (the roofline inputs
``launch/roofline.py`` reads), ``windows`` and ``n_devices``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.fake_stats import OpCounter
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.specs import cache_len, input_specs
from repro_torch.models import model as M
from repro_torch.models import sharded, ssm
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.sharding import rules as R
from repro_torch.training import steps as S
from repro_torch.training.optimizer import AdamWState

__all__ = ["LM_ARCHS", "MESHES", "cut_config", "step_counts", "extrapolate",
           "argument_bytes", "lower_cell", "run_cell", "longest_first",
           "run_cells", "main", "deep_trips", "DEEP_TRIPS"]

LM_ARCHS = [a for a in ARCHS if a != "drone_graph"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
_NUMS = ("hbm_bytes", "dot_flops", "ops", "wire_bytes", "peak")
#: the trips of a loop's two deeper windows (``extrapolate``'s peak)
DEEP_TRIPS = (4, 6)


def _shape(shape) -> dict:
    """A cell's shape: a name of ``SHAPES`` or such a dict itself."""
    return shape if isinstance(shape, dict) else SHAPES[shape]


def _groups(cfg) -> list:
    """The cell's windows: ``(name, depth)`` per scan group, then the
    encoder's."""
    out = [(f"group{i}", n) for i, (_, n) in enumerate(cfg.scan_groups())]
    if cfg.n_enc_layers:
        out.append(("encoder", cfg.n_enc_layers))
    return out


def cut_config(cfg, reps: dict):
    """``cfg`` with each scan group at ``reps.get(name, 1)`` repeats (the
    encoder as ``"encoder"``), its layer order kept."""
    pattern = []
    for i, (pat, _) in enumerate(cfg.scan_groups()):
        pattern += list(pat) * reps.get(f"group{i}", 1)
    over = dict(n_layers=len(pattern), pattern=tuple(pattern))
    if cfg.n_enc_layers:
        over["n_enc_layers"] = reps.get("encoder", 1)
    return dataclasses.replace(cfg, **over)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local_bytes(shape, dtype, mesh, placements) -> int:
    n = math.prod(sharded.local_shape(shape, mesh, placements))
    return n * torch.empty((), dtype=dtype).element_size()


def argument_bytes(cfg, kind: str, shape_name: str, mesh) -> dict:
    """Per-rank bytes of the full-depth step's arguments, from the local
    shapes: ``params``, AdamW's ``opt`` moments (and step), the
    ``batch`` and the ``caches``."""
    with torch.device("meta"):
        model = M.Model(cfg, device="meta")
    named = dict(model.named_parameters())
    sh = R.param_shardings(mesh, M.model_specs(cfg), named)
    params = sum(_local_bytes(p.shape, p.dtype, mesh, sh[n].placements)
                 for n, p in named.items())
    opt = 0
    if kind == "train":
        opt = 2 * sum(_local_bytes(p.shape, torch.float32, mesh,
                                   sh[n].placements)
                      for n, p in named.items()) + 4
    caches = cache_bytes(cfg, shape_name, mesh) if kind == "decode" else 0
    return dict(params=params, opt=opt, caches=caches)


def cache_bytes(cfg, shape_name, mesh) -> int:
    """Per-rank bytes of the cell's full-depth decode cache (a decode
    step's argument, a prefill's output), from its local shapes."""
    sz = _shape(shape_name)
    layers = M.cache_layers(cfg, sz["global_batch"],
                            cache_len(cfg, sz["seq_len"]),
                            torch.device("meta"))
    csh = R.cache_shardings(mesh, M.cache_specs(cfg), layers)
    return sum(_local_bytes(t.shape, t.dtype, mesh, s[f].placements)
               for c, s in zip(layers, csh) for f, t in c.items()
               if isinstance(t, torch.Tensor))


def _stand_ins(outs: list, n: int) -> list:
    """``outs`` padded to ``n`` entries with uncounted empty tensors like
    its last (a trip window's skipped trips), made in one op."""
    with OpCounter.paused():
        last = outs[-1]
        return outs + list(last.new_empty((n - len(outs),) + last.shape)
                           .unbind(0))


def step_counts(cfg, shape_name: str, mesh, device, window=None) -> dict:
    """One rank's counts of the cell's step for ``cfg`` (any depth) under
    the trip ``window`` (``ssm.trip_window``'s loops; None: every trip):
    the counter's totals, ``peak`` (live bytes the step allocated) and
    the local ``batch`` and ``output`` bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sz = _shape(shape_name)
    with FakeTensorMode(), R.set_mesh(mesh), \
            ssm.trip_window(_stand_ins, **(window or {})):
        model = M.Model(cfg, device=device)
        sharded.shard_params(model, mesh, fresh=True)
        kind, batch, caches = input_specs(cfg, shape_name, device)
        batch_bytes = sum(_nbytes(t.to_local()) for t in batch.values())
        if kind == "train":
            named = dict(model.named_parameters())
            state = S.TrainState(params=model, opt=AdamWState(
                step=torch.zeros((), dtype=torch.int32, device=device),
                m={n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named.items()},
                v={n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named.items()}))
            step = S.make_train_step(cfg)
        elif kind == "prefill":
            step = S.make_prefill_step(cfg, cache_len(cfg, sz["seq_len"]))
        else:
            step = S.make_serve_step(cfg)
        counter = OpCounter()
        with counter:
            if kind == "train":
                out = step(state, batch)[1]
            elif kind == "prefill":
                out = step(model, batch)
            else:
                out = step(model, caches, batch)[0]
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        out_bytes = sum(_nbytes(t.to_local() if hasattr(t, "to_local")
                                else t) for t in outs)
    return dict(counter.counts(), peak=counter.peak, batch=batch_bytes,
                output=out_bytes if kind != "train" else 0)


def _combo(terms) -> dict:
    """``sum(coef x counts)`` over numbers and per-kind dicts, for
    ``terms`` a list of ``(coef, counts)`` (kinds that end at 0 left
    out)."""
    out = {}
    for coef, c in terms:
        for k, v in c.items():
            if isinstance(v, dict):
                d = out.setdefault(k, {})
                for kind, x in v.items():
                    d[kind] = d.get(kind, 0) + coef * x
            elif k in _NUMS:
                out[k] = out.get(k, 0) + coef * v
    return {k: ({kind: x for kind, x in v.items() if x} if
                isinstance(v, dict) else v) for k, v in out.items()}


def extrapolate(runs: dict, depths: dict, trips: dict,
                deep: dict = None) -> dict:
    """The full step's counts from its windows. ``runs[(group, loop)]`` is
    the run with every scan group at one repeat but ``group`` at two
    (None: none) and every windowed loop (``trips``: loop -> full trip
    count) at one trip but ``loop`` at two (None: none). The counts are
    ``a + sum_g b_g L_g + sum_l c_l k_l + sum_g sum_l d_gl L_g k_l`` in
    the repeats ``L_g`` and the trips ``k_l``, so with ``f`` the runs,
    ``n_g`` the depths and ``T_l`` the full trip counts

        full = f(0, 0) + sum_g (n_g - 1) (f(g, 0) - f(0, 0))
               + sum_l (T_l - 1) (f(0, l) - f(0, 0))
               + sum_gl (n_g - 1) (T_l - 1) (f(g, l) - f(g, 0) - f(0, l)
                                             + f(0, 0))

    exactly (only groups deeper than one and loops of more than one trip
    enter). Where every layer is in one scan group, no loop runs outside
    it (``c_l = 0``), and the runs ``f(g, l)`` are not needed: the last
    two lines become ``sum_l n_g (T_l - 1) (f(0, l) - f(0, 0))``.

    The peak of live bytes, a maximum over the step, is not linear. A
    repeat adds what it keeps for the rest of the step (a block's saved
    input: ``n_g - 1`` times its growth). A loop runs inside one layer at
    a time, so its growth counts once, from ``deep[l]``: runs with every
    loop at one trip but ``l`` at ``k`` trips, by ``k``. Where ``l`` runs
    at most ``DEEP_TRIPS[-1]`` trips, the run at ``T_l`` gives its growth
    outright; else what ``DEEP_TRIPS[0]`` trips add, plus ``T_l -
    DEEP_TRIPS[0]`` times the growth per trip between the two deep runs
    (the state kept per trip, such as the sLSTM's saved carries or a
    Mamba chunk's saved tensors; the first trips also set up transients,
    such as the sLSTM's gradient slices summed into one, which reach
    their steady form by the third). It is never below a window's own
    peak."""
    deep = deep or {}
    base = runs[(None, None)]
    gs = [g for g, n in depths.items() if n > 1]
    ls = [lp for lp, n in trips.items() if n > 1]
    terms = [(1, base)]
    for g in gs:
        terms += [(depths[g] - 1, runs[(g, None)]),
                  (-(depths[g] - 1), base)]
    for lp in ls:
        if all((g, lp) not in runs for g in gs):     # loops in one group
            n = depths[gs[0]] if gs else 1
            terms += [(n * (trips[lp] - 1), runs[(None, lp)]),
                      (-n * (trips[lp] - 1), base)]
            continue
        terms += [(trips[lp] - 1, runs[(None, lp)]),
                  (-(trips[lp] - 1), base)]
        for g in gs:
            c = (depths[g] - 1) * (trips[lp] - 1)
            terms += [(c, runs[(g, lp)]), (-c, runs[(g, None)]),
                      (-c, runs[(None, lp)]), (c, base)]
    full = _combo(terms)
    peak = base["peak"] + sum(
        (depths[g] - 1) * max(0, runs[(g, None)]["peak"] - base["peak"])
        for g in gs)
    for lp in ls:
        at = {2: runs[(None, lp)], **deep.get(lp, {})}
        if trips[lp] in at:
            peak += max(0, at[trips[lp]]["peak"] - base["peak"])
            continue
        a, b = DEEP_TRIPS
        slope = max(0, at[b]["peak"] - at[a]["peak"]) / (b - a)
        peak += max(0, at[a]["peak"] - base["peak"]) \
            + math.ceil((trips[lp] - a) * slope)
    full["peak"] = max([peak] + [r["peak"] for r in runs.values()]
                       + [r["peak"] for d in deep.values()
                          for r in d.values()])
    return full


def deep_trips(n: int) -> tuple:
    """The trip counts of a loop of ``n`` trips that ``extrapolate`` reads
    the peak from, besides one and two: ``n`` itself up to
    ``DEEP_TRIPS[-1]``, else ``DEEP_TRIPS``."""
    if n <= 2:
        return ()
    return (n,) if n <= DEEP_TRIPS[-1] else DEEP_TRIPS


def _trips(cfg, kind: str, seq_len: int) -> dict:
    """The windowed loops a cell's step runs, with their full trip counts:
    the sLSTM's steps and, past one chunk, the chunkwise mLSTM's and the
    Mamba scan's chunks (a decode step runs one token)."""
    if kind == "decode":
        return {}
    mixers = {s.mixer for s in cfg.layer_pattern()}
    out = {}
    if "slstm" in mixers:
        out["slstm"] = ssm.TRIP_LOOPS["slstm"](seq_len)
    if "mlstm" in mixers and seq_len > ssm._MLSTM_CHUNK:
        out["mlstm"] = ssm.TRIP_LOOPS["mlstm"](seq_len)
    if "mamba" in mixers and seq_len > ssm._MAMBA_CHUNK:
        out["mamba"] = ssm.TRIP_LOOPS["mamba"](seq_len)
    return out


def lower_cell(arch: str, shape_name: str, mesh_kind: str, *,
               variant: str = "base", cfg=None, mesh=None,
               device=None) -> dict:
    """The dry run of one cell (its fake world made here unless ``mesh``
    is given, over ranks already started): the windows' counts, their
    extrapolation to full depth (``walk``) and the per-rank memory. The
    fake tensors sit on ``device``, the CPU unless given, on every build:
    DTensor makes its buffers on the mesh's device type, and a CUDA
    tensor's backward runs on autograd's device thread, whose own
    sharding caches ``fake_world`` could not empty between cells."""
    cfg = cfg or get_config(arch)
    if variant == "opt":
        from repro_torch.configs.variants import optimized
        cfg = optimized(cfg)
    device = device or "cpu"
    if mesh is None:
        shape, axes = MESHES[mesh_kind]
        with fake_world(math.prod(shape)):
            return lower_cell(arch, shape_name, mesh_kind, variant="base",
                              cfg=cfg, mesh=make_mesh(shape, axes),
                              device=device)
    kind = _shape(shape_name)["kind"]
    depths = dict(_groups(cfg))
    trips = _trips(cfg, kind, _shape(shape_name)["seq_len"])
    runs = {}
    one_group = len(cfg.scan_groups()) == 1   # every layer in it
    for lp in [None] + [lp for lp, n in trips.items() if n > 1]:
        for g in [None] + [g for g, n in depths.items() if n > 1]:
            if g and lp and one_group:
                continue
            window = {name: 2 if name == lp else 1 for name in trips}
            runs[(g, lp)] = step_counts(
                cut_config(cfg, {g: 2} if g else {}), shape_name, mesh,
                device, window)
    # each loop at more trips, for the peak
    deep = {lp: {k: step_counts(cut_config(cfg, {}), shape_name, mesh,
                                device, {name: k if name == lp else 1
                                         for name in trips})
                 for k in deep_trips(n)} for lp, n in trips.items()}
    base = runs[(None, None)]
    full = extrapolate(runs, depths, trips, deep)
    windows = {f"{g or 'base'}{'' if lp is None else '@' + lp}": r
               for (g, lp), r in runs.items()}
    windows.update({f"base@{lp}x{k}": r for lp, d in deep.items()
                    for k, r in d.items()})
    args = argument_bytes(cfg, kind, shape_name, mesh)
    arg_bytes = args["params"] + args["opt"] + args["caches"] + base["batch"]
    out_bytes = base["output"]
    if kind == "prefill":
        out_bytes += cache_bytes(cfg, shape_name, mesh)
    by_kind = dict(full["collective_bytes"])
    walk = {"dot_flops_per_device": full["dot_flops"],
            "hbm_bytes_per_device": full["hbm_bytes"],
            "ops_per_device": full["ops"],
            "collective_bytes_per_device": sum(by_kind.values()),
            "collective_by_kind": by_kind,
            "collective_counts": dict(full["collective_counts"]),
            "collective_wire_bytes_per_device": full["wire_bytes"]}
    return dict(
        kind=kind, n_devices=mesh.size(), depths=depths, trips=trips,
        memory=dict(argument_size_in_bytes=arg_bytes,
                    temp_size_in_bytes=full["peak"],
                    output_size_in_bytes=out_bytes, **{
                        f"{k}_bytes": v for k, v in args.items()},
                    batch_bytes=base["batch"]),
        walk=walk, windows=windows)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, force=False, variant: str = "base") -> dict:
    suffix = "" if variant == "base" else f"__{variant}"
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            cached = json.load(f)
        if cached.get("status") != "error":   # errored cells always re-run
            return cached
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "family": cfg.family, "variant": variant}
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        t0 = time.time()
        try:
            dry = lower_cell(arch, shape_name, mesh_kind, variant=variant)
            walk = dry["walk"]
            rec.update(
                status="ok", run_s=round(time.time() - t0, 3),
                n_devices=dry["n_devices"], memory=dry["memory"],
                cost={"flops": walk["dot_flops_per_device"]},
                collectives={"bytes_per_device":
                             walk["collective_bytes_per_device"],
                             "by_kind": walk["collective_by_kind"],
                             "counts": walk["collective_counts"],
                             "wire_bytes_per_device":
                             walk["collective_wire_bytes_per_device"]},
                walk=walk, windows=dry["windows"], depths=dry["depths"])
        except Exception as e:
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-3000:])
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _cell_task(task):
    """One cell in a worker process (one thread: the fake ops are
    host-bound and the workers share the cores)."""
    torch.set_num_threads(1)
    arch, shape, mk, out, force, variant = task
    return run_cell(arch, shape, mk, out, force=force, variant=variant)


def longest_first(tasks: list) -> list:
    """``run_cell`` tasks with the recurrent archs' train and prefill
    cells first, so that no worker ends last on one of them."""
    return sorted(tasks, key=lambda t: (
        t[0] not in ("xlstm_350m", "jamba_v01_52b"),
        _shape(t[1])["kind"] == "decode"))


def run_cells(tasks, workers: int = 1):
    """``run_cell`` over ``tasks`` (tuples of its arguments), in ``workers``
    spawned processes when above 1 (each cell makes its own fake world),
    yielding the records in task order."""
    if workers <= 1:
        for t in tasks:
            yield _cell_task(t)
        return
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(workers,
                                mp_context=mp.get_context("spawn")) as ex:
        yield from ex.map(_cell_task, tasks)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    ap.add_argument("--workers", type=int, default=1,
                    help="cells run in this many processes at once")
    args = ap.parse_args(argv)

    archs = LM_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multipod"] if args.mesh == "both" else [args.mesh])
    tasks = longest_first([(arch, shape, mk, args.out, args.force,
                            args.variant) for arch in archs
                           for shape in shapes for mk in meshes])

    n_ok = n_skip = n_err = 0
    for rec in run_cells(tasks, args.workers):
        tag = rec["status"]
        n_ok += tag == "ok"
        n_skip += tag == "skipped"
        n_err += tag == "error"
        extra = ""
        if tag == "ok":
            f = rec["cost"]["flops"]
            mem = rec["memory"]
            extra = (f" flops={f:.3e}"
                     f" args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB"
                     f" temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB"
                     f" coll={rec['collectives']['bytes_per_device'] / 2**30:.3f}"
                     f"GiB t={rec.get('run_s')}s")
        elif tag == "error":
            extra = " " + rec["error"][:200]
        print(f"[{tag:7s}] {rec['arch']:24s} {rec['shape']:12s} "
              f"{rec['mesh']:8s}{extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} err={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
