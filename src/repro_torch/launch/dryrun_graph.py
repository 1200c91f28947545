"""Graph-engine capacity dry run: the paper's own workload on the production
mesh, up to the trillion-edge point (the paper's headline: one-trillion-
edge power-law graphs, orders of magnitude beyond earlier subgraph-centric
frameworks), on H100s.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_graph \\
        --scale all --algo all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.roofline

One rank's subgraph block is made of fake tensors (``FakeTensorMode``:
shapes, dtypes and a device, no storage; ``fake_device``) sized from (n_edges,
n_parts, replication-factor estimate) as ``GraphScale.meta`` says, and the
``shard_map`` BSP pieces the real runner runs (``engine.ShardStep``: the
initial state, supersteps of local sweeps, the SBS exchange and the count
all-reduce) run on it as that rank of a fake world of ranks, one per card
of the cell's mesh: ``(16, 16)`` (one pod), ``(2, 16, 16)`` (two) or,
for the trillion point, ``(8, 16, 16)`` = 2,048 ranks. Nothing is
allocated and no card is needed; the fake world is the counterpart of the
JAX package's run under
``DRYRUN_XLA_FLAGS=--xla_force_host_platform_device_count=2048``.
``launch.fake_stats.OpCounter`` counts what the ops move and hold. A
superstep runs its local sweeps a fixed number of times
(``max_local_iters``, 64) with no host read: one sweep and one superstep
are windowed and the superstep's sweeps multiplied out.

Per rank, the record holds the argument bytes (the ``DeviceSubgraph``
block), the peak of what the run allocates above them, the result block,
the collective payload bytes per superstep (``sbs.ShardExchange`` and
``EdgeCombine`` count them where they are issued) and the roofline inputs
``launch/roofline.py`` reads. The runner all-gathers the global result
to every rank at the end of a query by default; the cells run it with
``gather_results=False``, each rank keeping its own block as the
reference's sharded ``out_specs`` do, and record the gathered size apart
(``gathered_output_size_in_bytes``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.algos import ConnectedComponents, PageRank, SSSP
from repro_torch.core import sbs
from repro_torch.core.api import DeviceSubgraph
from repro_torch.core.engine import (EdgeCombine, EngineConfig, ShardStep,
                                     resolve_edge_backend)
from repro_torch.core.mesh import placement
from repro_torch.launch.fake_stats import OpCounter
from repro_torch.launch.mesh import fake_world, make_mesh

__all__ = ["GraphScale", "SCALES", "TRILLION_MESH", "INT32_LIMIT", "ALGOS",
           "fake_device", "fake_subgraph", "dry_run", "expected_step_bytes",
           "dry_graph_cell", "run_cell", "main"]


@dataclasses.dataclass
class GraphScale:
    name: str
    n_edges: int
    n_vertices: int
    rf: float = 4.0          # replication factor estimate (CDBH, power-law)
    frontier_frac: float = 0.5

    def meta(self, n_parts, edge_shards, pad=1.05):
        e_max = int(self.n_edges / n_parts * pad)
        e_max = -(-e_max // (128 * edge_shards)) * (128 * edge_shards)
        v_max = int(self.n_vertices * self.rf / n_parts * pad)
        v_max = -(-v_max // 128) * 128
        n_slots = min(int(self.n_vertices * self.frontier_frac),
                      v_max * n_parts)
        return dict(e_max=e_max, v_max=v_max, n_slots=n_slots)


SCALES = {
    "kron26": GraphScale("kron26", 2 ** 26 * 16 * 2, 2 ** 26),       # 2.1B
    "kron30": GraphScale("kron30", 2 ** 30 * 16 * 2, 2 ** 30),       # 34B
    "kron33-100B": GraphScale("kron33-100B", 2 ** 33 * 16, 2 ** 33),  # 137B
    # 1.1T edges (Kronecker scale-34, edge-factor 64) on an (8, 16, 16)
    # mesh of 2,048 ranks
    "trillion": GraphScale("trillion", 2 ** 40, 2 ** 34, rf=2.5,
                           frontier_frac=0.25),                      # 1.1T
}
TRILLION_MESH = (8, 16, 16)
INT32_LIMIT = 2 ** 31

ALGOS = {
    "cc": (ConnectedComponents, None),
    "sssp": (SSSP, {"source": 0}),
    "pagerank": (PageRank, {"n_vertices": 2.0 ** 30}),
}

# the DeviceSubgraph fields _device_subgraph uploads, with their dtypes;
# edge fields hold a rank's e_max / n_edge columns, vertex fields v_max
_EDGE_FIELDS = (("esrc", torch.int32), ("edst", torch.int32),
                ("ew", torch.float32), ("emask", torch.bool))
_VERTEX_FIELDS = (("slot", torch.int32), ("vmask", torch.bool),
                  ("vid32", torch.int32), ("is_frontier", torch.bool),
                  ("out_deg", torch.float32), ("in_deg", torch.float32),
                  ("is_master", torch.bool))


def fake_device() -> str:
    """Where the fake tensors sit: ``cuda`` on a build of PyTorch with
    CUDA (no card is touched), ``cpu`` on a CPU-only build, whose tensor
    indexing cannot guard a ``cuda`` device. Shapes, dtypes and bytes are
    the same on both."""
    return "cuda" if torch.version.cuda else "cpu"


def fake_subgraph(meta: dict, n_edge: int, device=None) -> DeviceSubgraph:
    """One rank's block as ``_device_subgraph(block=)`` shapes it: a stack
    of one partition's vertex tables and ``e_max / n_edge`` of its edge
    columns, no vertex labels, on ``device`` (``fake_device()``). Made
    inside ``FakeTensorMode``, nothing is allocated."""
    device = device or fake_device()
    se = meta["e_max"] // n_edge
    fields = {n: torch.empty((1, se), dtype=dt, device=device)
              for n, dt in _EDGE_FIELDS}
    fields.update({n: torch.empty((1, meta["v_max"]), dtype=dt,
                                  device=device)
                   for n, dt in _VERTEX_FIELDS})
    return DeviceSubgraph(vlabel=None, **fields)


class _SweepCount:
    """The local phase's continue test of a dry run: ``n`` sweeps in all
    (the first is unconditional), and no host read. It still issues the
    ``any`` the engine reads, so the op stream is the engine's."""

    def __init__(self, n: int):
        self.left = n - 1

    def __call__(self, live: torch.Tensor) -> bool:
        live.any()
        self.left -= 1
        return self.left >= 0


def _payloads(ex, ec) -> dict:
    """Payload bytes so far, per process group and kind."""
    return {"sub": dict(ex.bytes), "edge": dict(ec.bytes)}


def _diff(a: dict, b: dict) -> dict:
    """``a - b`` over nested dicts of numbers (a key ``b`` lacks is 0)."""
    return {k: _diff(v, b.get(k, {})) if isinstance(v, dict)
            else v - b.get(k, 0) for k, v in a.items()}


def _lin(base: dict, per: dict, n: int) -> dict:
    """``base + n * per`` over nested dicts of numbers."""
    keys = list(base) + [k for k in per if k not in base]
    return {k: _lin(base.get(k, {}), per.get(k, {}), n)
            if isinstance(base.get(k, per.get(k)), dict)
            else base.get(k, 0) + n * per.get(k, 0) for k in keys}


def _walk(win: dict, sizes: dict) -> dict:
    """A window's counts in the record's terms: payload bytes per kind,
    per process group (``sub``: the SBS exchange and the counts; ``edge``:
    the edge-group combines) and in all, the collectives issued by kind,
    the ring model's wire bytes per rank (all-reduce 2 (n - 1) / n of the
    payload, all-gather (n - 1) times it, n the group's ranks), all-op
    bytes and matmul FLOPs."""
    by_kind = {k: win["sub"][k] + win["edge"][k] for k in win["sub"]}
    wire = 0.0
    for g in ("sub", "edge"):
        n = sizes[g]
        wire += win[g]["all_reduce"] * 2 * (n - 1) / n \
            + win[g]["all_gather"] * (n - 1)
    return {"collective_bytes_per_device": sum(by_kind.values()),
            "collective_by_kind": by_kind,
            "collective_by_group": {g: sum(win[g].values())
                                    for g in ("sub", "edge")},
            "collective_counts": win["collective_counts"],
            "collective_wire_bytes_per_device": wire,
            "hbm_bytes_per_device": win["hbm_bytes"],
            "dot_flops_per_device": win["dot_flops"]}


def dry_run(meta: dict, mesh_shape, axes, cfg: EngineConfig, program,
            params=None, *, rank: int = 0,
            gather_results: bool = False) -> dict:
    """One rank's ``shard_map`` query pieces on fake tensors, as rank
    ``rank`` of a fake world of ``prod(mesh_shape)`` ranks on a mesh of
    ``mesh_shape`` named ``axes``, for the graph ``meta`` (``e_max``,
    ``v_max``, ``n_slots``) under ``cfg`` (the ``coo`` edge backend).

    Runs ``start``, a first superstep of one sweep, a superstep of one
    sweep and one of two (each continuing the last's state), and, with
    ``gather_results``, the runner's closing all-gathers. Returns
    ``memory`` (``argument_size_in_bytes``: the block;
    ``temp_size_in_bytes``: the peak the run allocated above it, outputs
    included while live; ``output_size_in_bytes``: the rank's result
    block and sweeps, or the gathered ones), ``per_sweep`` and the
    supersteps' counts without their sweeps (``superstep_base``,
    ``first_superstep_base``: a superstep of n sweeps counts base + n *
    per_sweep), each a ``_walk`` record, and the placement's sizes."""
    if resolve_edge_backend(program, cfg) != "coo":
        raise ValueError("the dry run runs the coo edge backend: a CUDA "
                         "kernel cannot launch on fake tensors")
    from torch._subclasses.fake_tensor import FakeTensorMode
    world = int(np.prod(mesh_shape))
    with fake_world(world, rank):
        t0 = time.perf_counter()
        mesh = make_mesh(mesh_shape, axes)
        pl = placement(mesh, cfg.subgraph_axes, cfg.edge_axes)
        mesh_s = time.perf_counter() - t0
        sizes = {"sub": pl.n_sub, "edge": pl.n_edge}
        with FakeTensorMode():
            sgs = fake_subgraph(meta, pl.n_edge)
            args = sum(t.numel() * t.element_size() for t in sgs
                       if t is not None)
            ex = sbs.ShardExchange(pl.sub_group)
            ec = EdgeCombine(pl.edge_group)
            counter = OpCounter()
            wins = {}
            with counter:
                rs = ShardStep(program, cfg, pl, meta["n_slots"], "coo",
                               sgs, None, params, ex, ec)
                state, merged_v, last_out = rs.start()
                tot_sweeps = torch.zeros(1, dtype=torch.int32,
                                         device=sgs.device)
                for name, first, n in (("first", True, 1), ("one", False, 1),
                                       ("two", False, 2)):
                    before = _payloads(ex, ec)
                    with counter.window(name):
                        state, merged_v, last_out, _, sweeps, _ = rs(
                            state, merged_v, last_out, first,
                            _SweepCount(n))
                        tot_sweeps += sweeps
                    wins[name] = dict(_diff(_payloads(ex, ec), before),
                                      **counter.windows[name])
                outs = rs.finish(state, tot_sweeps, gather_results)
            out_bytes = sum(t.numel() * t.element_size() for t in outs)
    per_sweep = _diff(wins["two"], wins["one"])
    return dict(
        memory=dict(argument_size_in_bytes=args,
                    temp_size_in_bytes=counter.peak,
                    output_size_in_bytes=out_bytes),
        per_sweep=_walk(per_sweep, sizes),
        superstep_base=_walk(_diff(wins["one"], per_sweep), sizes),
        first_superstep_base=_walk(_diff(wins["first"], per_sweep), sizes),
        n_parts=pl.n_sub, n_edge=pl.n_edge, n_devices=world,
        mesh_s=mesh_s)


def expected_step_bytes(dry: dict, sweeps_per_step) -> list:
    """The collective payload bytes each superstep of a real run moves, by
    ``dry_run``'s counts: its base (the first superstep's own) plus its
    sweeps (``sweeps_per_step``, the rank's, as trace mode records them)
    times the per-sweep bytes."""
    per = dry["per_sweep"]["collective_bytes_per_device"]
    return [dry["first_superstep_base" if i == 0 else "superstep_base"]
            ["collective_bytes_per_device"] + n * per
            for i, n in enumerate(sweeps_per_step)]


def _cell_mesh(scale_name: str, multi_pod: bool):
    """(mesh shape, axis names, subgraph axes) of a cell."""
    if scale_name == "trillion":
        return TRILLION_MESH, ("pod", "data", "model"), ("pod", "data")
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model"), ("pod", "data")
    return (16, 16), ("data", "model"), ("data",)


def dry_graph_cell(scale_name: str, algo: str, multi_pod: bool,
                   *, max_local_iters=64, dense_slots=False, lean=True):
    """The dry run of one cell: ``SCALES[scale_name]`` under ``algo`` on
    the one-pod or two-pod mesh (the trillion point on its own 2,048-rank
    mesh), with the JAX package's ``EngineConfig``: ``sc`` mode, the
    ``shard_map`` backend, edges sharded over ``model``, the SBS buffer
    sharded with them unless ``dense_slots``, ``lean_frontier`` as
    ``lean``. Returns ``(meta, n_parts, dry)``, ``dry`` as ``dry_run``'s
    plus ``walk``: a superstep at ``max_local_iters`` sweeps."""
    shape, axes, sub_axes = _cell_mesh(scale_name, multi_pod)
    edge_axes = ("model",)
    n_parts = int(np.prod([shape[axes.index(a)] for a in sub_axes]))
    sc = SCALES[scale_name]
    meta = sc.meta(n_parts, shape[axes.index("model")])
    if meta["v_max"] >= INT32_LIMIT:
        raise ValueError(
            f"per-partition vertex table v_max={meta['v_max']:.3e} exceeds "
            "int32 local indexing — scale out to more subgraphs "
            "(design constraint, DESIGN.md §7)")
    prog_cls, params = ALGOS[algo]
    prog = prog_cls()
    cfg = EngineConfig(mode="sc", backend="shard_map",
                       subgraph_axes=sub_axes, edge_axes=edge_axes,
                       max_local_iters=max_local_iters,
                       shard_slots=not dense_slots, lean_frontier=lean)
    dry = dry_run(meta, shape, axes, cfg, prog, params)
    L = cfg.local_bound
    walk = _lin(dry["superstep_base"], dry["per_sweep"], L)
    se = meta["e_max"] // dry["n_edge"]
    walk.update(sweeps_per_superstep=L,
                semiring_ops_per_device=2 * prog.payload * se * L)
    dry["walk"] = walk
    return meta, n_parts, dry


def run_cell(scale_name, algo, mesh_kind, out_dir, force=False,
             variant="opt"):
    suffix = "" if variant == "opt" else f"__{variant}"
    name = f"graph__{scale_name}__{algo}__{mesh_kind}{suffix}.json"
    path = os.path.join(out_dir, name)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rec = {"scale": scale_name, "algo": algo, "mesh": mesh_kind,
           "kind": "graph_engine", "variant": variant}
    t0 = time.time()
    try:
        meta, n_parts, dry = dry_graph_cell(
            scale_name, algo, mesh_kind == "multipod",
            dense_slots=(variant == "dense"), lean=(variant != "dense"))
        walk = dry["walk"]
        mem = dict(dry["memory"], gathered_output_size_in_bytes=(
            dry["memory"]["output_size_in_bytes"] * n_parts))
        rec.update(status="ok", run_s=round(time.time() - t0, 3),
                   mesh_s=dry["mesh_s"], meta=meta, n_parts=n_parts,
                   n_devices=dry["n_devices"], memory=mem,
                   collectives={"bytes_per_device":
                                walk["collective_bytes_per_device"],
                                "by_kind": walk["collective_by_kind"],
                                "counts": walk["collective_counts"]},
                   walk=walk,
                   per_sweep=dry["per_sweep"],
                   superstep_base=dry["superstep_base"],
                   first_superstep_base=dry["first_superstep_base"])
    except (RuntimeError, ValueError) as e:
        # capacity/topology constraints -> documented skip, not a bug
        rec.update(status="skipped", reason=str(e))
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="all")
    ap.add_argument("--algo", default="cc")
    ap.add_argument("--mesh", default="both")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="opt", choices=["opt", "dense"])
    args = ap.parse_args(argv)
    scales = list(SCALES) if args.scale == "all" else [args.scale]
    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]
    algos = list(ALGOS) if args.algo == "all" else [args.algo]
    bad = 0
    for s in scales:
        for a in algos:
            for mk in meshes:
                rec = run_cell(s, a, mk, args.out, args.force,
                               variant=args.variant)
                ok = rec["status"] == "ok"
                bad += not ok
                if ok:
                    mem = rec["memory"]["temp_size_in_bytes"]
                    arg = rec["memory"]["argument_size_in_bytes"]
                    coll = rec["walk"]["collective_bytes_per_device"]
                    print(f"[ok   ] graph {s:12s} {a:8s} {mk:8s} "
                          f"temp={mem/2**30:.2f}GiB args={arg/2**30:.3f}GiB "
                          f"coll/step~{coll/2**20:.1f}MiB", flush=True)
                else:
                    why = rec.get("reason") or rec.get("error", "")
                    print(f"[{rec['status']:5s}] graph {s} {a} {mk}: "
                          f"{why[:200]}", flush=True)
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
