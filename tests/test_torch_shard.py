"""The ``shard_map`` backend of the port against the JAX package's.

The port runs SPMD over ``torch.distributed``: one gloo process per mesh
position (``file://`` store under ``tmp_path``), each holding the same host
graph and uploading only its own block. The reference runs in two
subprocesses (a few meshes each) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (its Pallas
backends in interpret mode inside ``shard_map``). Both run the
same case table and write ``.npz`` files; the port writes one per rank, and
every rank's results are held to the reference's:

  - meshes (2,2,2) pod/data/model (edge axis ``model``), (4,) sub, (4,2)
    sub x edge, and a (2,2,2) mesh whose subgraph axes are neither leading
    nor in mesh order (``('data', 'pod')`` on ``('model', 'pod', 'data')``);
  - ``coo``, ``pallas_tiles``, ``pallas_windows`` and ``'auto'``; the dense
    exchange, ``shard_slots`` and ``lean_frontier``; warm starts;
  - results, supersteps, messages and per-partition sweeps bit for bit for
    SSSP and CC, PageRank results within rtol = atol = 1e-5 (float sums in
    another order; its ``tol`` test can flip, so its counts are not held);
  - the compacted sparse exchange at capacities 1, 4 and 32 on grid-12
    SSSP: the port reproduces the reference's drop of the changed slots
    beyond ``capacity`` (ROADMAP Queue 3), results and counts included,
    where both differ from the simulator;
  - ``lean_frontier`` with SSSP does not halt in either engine (a
    frontier vertex the merged view has not echoed sends again every other
    superstep): it runs to ``max_supersteps`` in both, with equal counts.

``total_bytes`` is held to the reference's ``_exchange_bytes_per_step``
for the dense, compacted and slot-sharded exchanges, as
``tests/test_shard_backend.py`` holds the reference's own.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (shape, dim names, subgraph axes, edge axes)
MESHES = {
    "222": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"),
            ("model",)),
    "4": ((4,), ("sub",), ("sub",), ()),
    "42": ((4, 2), ("sub", "edge"), ("sub",), ("edge",)),
    "x222": ((2, 2, 2), ("model", "pod", "data"), ("data", "pod"),
             ("model",)),
}

# (case id, mesh, graph, program, edge backend, EngineConfig extras)
CASES = [
    ("222-coo-sssp", "222", "pl", "sssp", "coo", {}),
    ("222-coo-pr", "222", "pl", "pr", "coo", {}),
    ("222-slots-cc", "222", "pl", "cc", "coo", {"shard_slots": True}),
    ("222-slots-pr", "222", "pl", "pr", "coo", {"shard_slots": True}),
    ("222-lean-sssp", "222", "pl", "sssp", "coo",
     {"lean_frontier": True, "max_supersteps": 12}),
    ("222-lean-cc", "222", "pl", "cc", "coo", {"lean_frontier": True}),
    ("222-windows-sssp", "222", "pl", "sssp", "pallas_windows", {}),
    ("222-tiles-cc", "222", "pl", "cc", "pallas_tiles", {}),
    ("4-coo-cc", "4", "pl", "cc", "coo", {}),
    ("4-tiles-sssp", "4", "pl", "sssp", "pallas_tiles", {}),
    ("4-tiles-pr", "4", "pl", "pr", "pallas_tiles", {}),
    ("4-windows-cc", "4", "pl", "cc", "pallas_windows", {}),
    ("4-windows-pr", "4", "pl", "pr", "pallas_windows", {}),
    ("4-auto-sssp", "4", "pl", "sssp", "auto", {}),
    ("4-sparse1-sssp", "4", "grid", "sssp", "coo",
     {"sparse_sync_capacity": 1}),
    ("4-sparse4-sssp", "4", "grid", "sssp", "coo",
     {"sparse_sync_capacity": 4}),
    ("4-sparse32-sssp", "4", "grid", "sssp", "coo",
     {"sparse_sync_capacity": 32}),
    ("4-dense-grid-sssp", "4", "grid", "sssp", "coo", {}),
    ("42-tiles-sssp", "42", "pl", "sssp", "pallas_tiles", {}),
    ("42-windows-cc", "42", "pl", "cc", "pallas_windows", {}),
    ("42-windows-pr", "42", "pl", "pr", "pallas_windows", {}),
    ("42-auto-cc", "42", "pl", "cc", "auto", {}),
    ("42-auto-pr", "42", "pl", "pr", "auto", {}),
    ("42-slots-windows-sssp", "42", "pl", "sssp", "pallas_windows",
     {"shard_slots": True}),
    ("42-sparse-cc", "42", "pl", "cc", "coo",
     {"sparse_sync_capacity": 24}),
    ("x222-coo-sssp", "x222", "pl", "sssp", "coo", {}),
    ("x222-windows-cc", "x222", "pl", "cc", "pallas_windows", {}),
]
# warm starts: cold, then warm from an upper bound of the cold distances
WARM = [("222-warm-sssp", "222", "coo"),
        ("42-warm-windows-sssp", "42", "pallas_windows")]

# graphs and programs, spelled the same in both packages
COMMON = r"""
import json, os, sys
import numpy as np

def graphs(G):
    pl = G.powerlaw_graph(400, seed=5, weighted=True).as_undirected()
    grid = G.grid_graph(12, weighted=True, seed=3)
    return {"pl": pl, "grid": grid}

def program(A, name, g):
    if name == "sssp":
        return A.SSSP(), {"source": 0}
    if name == "cc":
        return A.ConnectedComponents(), None
    return A.PageRank(), {"n_vertices": g.n_vertices}

def warm_init(pg, cold):
    # the converged distances, a third of them raised by one: an upper
    # bound, so a sound warm start that still has work to do
    prev = pg.collect(cold, fill=np.float32(np.inf)).astype(np.float32)
    prev[::3] += np.float32(1)
    return prev

spec = json.loads(sys.argv[1])
out = sys.argv[2]
part = sys.argv[3] if len(sys.argv) > 3 else ""
"""

REFERENCE = COMMON + r"""
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import repro.algos as A
import repro.graphgen as G
from repro.core import EngineConfig, partition_and_build, run_shard_map
from repro.core import engine as E

def mesh_of(key):
    shape, names, sub, edge = spec["meshes"][key]
    n = int(np.prod(shape))
    devs = np.array(jax.devices()[:n]).reshape(shape)
    return Mesh(devs, tuple(names)), tuple(sub), tuple(edge)

def ref_run(prog, pg, mesh, params, cfg, init_state=None):
    # run_shard_map's body, returning the per-partition sweeps too
    edge = cfg.edge_axes
    n_edge = int(np.prod([mesh.shape[a] for a in edge])) if edge else 1
    warm = init_state is not None and prog.monotone
    eb = E.resolve_edge_backend(prog, cfg)
    args, asg = (E._device_subgraph(pg),), None
    if eb == "auto":
        lay = pg.ensure_edge_layouts()
        asg = E.resolve_partition_backends(prog, cfg, pg, lay=lay)
        args += (E._auto_layout_blocks(lay, pg, prog, asg, mixed_shard=True,
                                       n_shards=n_edge),)
    elif eb != "coo":
        lay = pg.ensure_edge_layouts()
        args += (E._layout_block_from(lay, pg, prog, eb, n_shards=n_edge),)
    go = E.make_bsp_runner(prog, mesh, cfg, pg.n_slots, params=params,
                           has_vlabel=pg.vlabel is not None, warm_start=warm,
                           partition_backends=asg)
    with mesh:
        if warm:
            args += (jnp.asarray(E._warm_block(prog, pg, init_state)),)
        res, steps, msgs, sweeps = go(*args)
    nbytes = int(steps) * E._exchange_bytes_per_step(
        cfg, pg.n_slots, prog.payload, prog.dtype, pg.n_parts, n_edge)
    return (np.asarray(res), int(steps), int(msgs),
            np.asarray(sweeps, np.int64), nbytes, asg)

gs = graphs(G)
pgs = {k: partition_and_build(g, 4, "cdbh") for k, g in gs.items()}
rec = {}
def keep(cid, r):
    res, steps, msgs, sweeps, nbytes, asg = r
    rec[cid + "/res"] = res
    rec[cid + "/counts"] = np.array([steps, msgs, nbytes], np.int64)
    rec[cid + "/sweeps"] = sweeps
    if asg is not None:
        rec[cid + "/asg"] = np.array(asg)

mine = part.split(",")
for cid, mk, gk, pname, eb, extra in spec["cases"]:
    if mk not in mine:
        continue
    mesh, sub, edge = mesh_of(mk)
    prog, params = program(A, pname, gs[gk])
    cfg = EngineConfig(backend="shard_map", subgraph_axes=sub,
                       edge_axes=edge, edge_backend=eb, **extra)
    keep(cid, ref_run(prog, pgs[gk], mesh, params, cfg))
for cid, mk, eb in spec["warm"]:
    if mk not in mine:
        continue
    mesh, sub, edge = mesh_of(mk)
    prog, params = program(A, "sssp", gs["pl"])
    cfg = EngineConfig(backend="shard_map", subgraph_axes=sub,
                       edge_axes=edge, edge_backend=eb)
    cold = ref_run(prog, pgs["pl"], mesh, params, cfg)
    keep(cid + "/cold", cold)
    keep(cid, ref_run(prog, pgs["pl"], mesh, params, cfg,
                      init_state=warm_init(pgs["pl"], cold[0])))
for k, pg in pgs.items():
    rec["gvid/" + k] = pg.gvid
np.savez(os.path.join(out, f"reference_{part}.npz"), **rec)
print("REFERENCE_OK")
"""

PORT = COMMON + r"""
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["DRONE_INIT"],
                        rank=rank, world_size=world)
import repro_torch.algos as A
import repro_torch.graphgen as G
from repro_torch.core import EngineConfig, partition_and_build, run
from repro_torch.core import run_shard_map

meshes = {}
def mesh_of(key):
    shape, names, sub, edge = spec["meshes"][key]
    if key not in meshes:
        meshes[key] = init_device_mesh("cpu", tuple(shape),
                                       mesh_dim_names=tuple(names))
    return meshes[key], tuple(sub), tuple(edge)

def mine(mk):
    return int(np.prod(spec["meshes"][mk][0])) == world

gs = graphs(G)
pgs = {k: partition_and_build(g, 4, "cdbh") for k, g in gs.items()}
rec = {}
def keep(cid, r):
    res, st = r
    rec[cid + "/res"] = res
    rec[cid + "/counts"] = np.array([st.supersteps, st.total_messages,
                                     st.total_bytes], np.int64)
    rec[cid + "/sweeps"] = np.array(st.partition_sweeps, np.int64)
    if st.partition_edge_backends:
        rec[cid + "/asg"] = np.array(st.partition_edge_backends)

for cid, mk, gk, pname, eb, extra in spec["cases"]:
    if not mine(mk):
        continue
    mesh, sub, edge = mesh_of(mk)
    prog, params = program(A, pname, gs[gk])
    cfg = EngineConfig(backend="shard_map", subgraph_axes=sub,
                       edge_axes=edge, edge_backend=eb, **extra)
    keep(cid, run(prog, pgs[gk], params, cfg, mesh=mesh, device="cpu"))
for cid, mk, eb in spec["warm"]:
    if not mine(mk):
        continue
    mesh, sub, edge = mesh_of(mk)
    prog, params = program(A, "sssp", gs["pl"])
    cfg = EngineConfig(backend="shard_map", subgraph_axes=sub,
                       edge_axes=edge, edge_backend=eb)
    cold = run_shard_map(prog, pgs["pl"], mesh, params, cfg, device="cpu")
    keep(cid + "/cold", cold)
    keep(cid, run_shard_map(prog, pgs["pl"], mesh, params, cfg,
                            init_state=warm_init(pgs["pl"], cold[0]),
                            device="cpu"))
if world == 4:
    # the runner's result layout: gathered (the default) against each
    # rank's own block, on a (2, 2) mesh of subgraphs x edge shards
    from repro_torch.core.engine import _device_subgraph, make_bsp_runner
    from repro_torch.core.mesh import placement
    m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("sub", "edge"))
    pg2 = partition_and_build(gs["pl"], 2, "cdbh")
    cfg = EngineConfig(backend="shard_map", subgraph_axes=("sub",),
                       edge_axes=("edge",))
    pl = placement(m22, cfg.subgraph_axes, cfg.edge_axes)
    sgs = _device_subgraph(pg2, torch.device("cpu"),
                           block=(pl.part, pl.shard, pl.n_edge))
    rec["f2/part"] = np.array(pl.part)
    for pname in ("sssp", "cc"):
        prog, params = program(A, pname, gs["pl"])
        for gather in (True, False):
            go = make_bsp_runner(prog, m22, cfg, pg2.n_slots,
                                 gather_results=gather)
            res, steps, msgs, sweeps, _, calls, moved = go(sgs, None, params)
            key = f"f2/{pname}/{'gathered' if gather else 'block'}"
            rec[key + "/res"] = res.numpy()
            rec[key + "/sweeps"] = np.asarray(sweeps)
            rec[key + "/counts"] = np.array(
                [steps, msgs, calls, moved["all_gather"]], np.int64)
for k, pg in pgs.items():
    rec["gvid/" + k] = pg.gvid
np.savez(os.path.join(out, f"port_{world}_{rank}.npz"), **rec)
dist.destroy_process_group()
print("PORT_RANK_OK", rank)
"""


def spawn_ranks(script, world, args, store, env=None):
    """Start ``world`` processes of ``script`` as one gloo job through a
    ``file://`` store at ``store`` (one thread each)."""
    base = dict(os.environ, WORLD_SIZE=str(world),
                DRONE_INIT=f"file://{store}", OMP_NUM_THREADS="1",
                PYTHONPATH=str(ROOT / "src"), **(env or {}))
    procs = [subprocess.Popen([sys.executable, "-c", script, *args],
                              env=dict(base, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs


def wait_all(procs, timeout, names=None):
    """Wait for ``procs``, one job, under one deadline ``timeout`` seconds
    away, reading every process's output at the same time (a thread
    each, so no full pipe stalls a process); a process still running at
    the deadline is killed. Returns ``[(returncode, output), ...]`` in list
    order. If any process exited non-zero or was killed, raises
    ``AssertionError`` with every process's exit code (or that it was
    killed) and the tail of its output, the first to exit non-zero in time
    first: a rank that crashes leaves its peers waiting in a collective,
    so the one that failed first is the one to read."""
    names = names or [f"process {i}" for i in range(len(procs))]
    texts = [""] * len(procs)

    def drain(i):
        texts[i] = procs[i].stdout.read()

    readers = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in readers:
        t.start()
    t0 = time.monotonic()
    ended, killed = {}, []
    try:
        while len(ended) < len(procs) and time.monotonic() - t0 < timeout:
            for i, p in enumerate(procs):
                if i not in ended and p.poll() is not None:
                    ended[i] = time.monotonic() - t0
            time.sleep(0.05)
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                killed.append(i)
            p.wait()
        for t in readers:
            t.join(timeout=30)
    out = [(p.returncode, texts[i]) for i, p in enumerate(procs)]
    failed = sorted((i for i in ended if procs[i].returncode != 0),
                    key=ended.get)
    if not failed and not killed:
        return out
    lines = [f"{len(failed)} of {len(procs)} processes exited non-zero, "
             f"{len(killed)} killed at the {timeout} s deadline"]
    for n, i in enumerate(failed + killed
                          + [i for i in range(len(procs))
                             if i not in failed and i not in killed]):
        state = (f"killed at {timeout} s" if i in killed else
                 f"exit {procs[i].returncode} after {ended[i]:.1f} s")
        tail = 4000 if n == 0 else 1500
        lines.append(f"--- {names[i]}: {state} ---\n{texts[i][-tail:]}")
    raise AssertionError("\n".join(lines))


def test_wait_all_reports_every_process():
    """One deadline for the job: a process that hangs is killed at it, and
    the report names every process's exit code (or the kill) and output,
    the first to exit non-zero in time first."""
    code = ("import sys, time; print('out of', sys.argv[1], flush=True); "
            "time.sleep(float(sys.argv[2])); sys.exit(int(sys.argv[3]))")
    runs = [("late", 1.0, 5), ("early", 0.0, 3), ("hung", 60.0, 0),
            ("fine", 0.0, 0)]
    procs = [subprocess.Popen([sys.executable, "-c", code, n, str(t),
                               str(rc)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for n, t, rc in runs]
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as err:
        wait_all(procs, 6, [n for n, _, _ in runs])
    assert time.monotonic() - t0 < 30
    msg = str(err.value)
    assert msg.startswith("2 of 4 processes exited non-zero, 1 killed")
    heads = [line for line in msg.splitlines() if line.startswith("---")]
    assert [h.split(":")[0] for h in heads] == [
        "--- early", "--- late", "--- hung", "--- fine"]
    assert "exit 3 after" in heads[0] and "exit 5 after" in heads[1]
    assert "killed at 6 s" in heads[2] and "exit 0 after" in heads[3]
    for n, _, _ in runs:
        assert f"out of {n}" in msg
    ok = [subprocess.Popen([sys.executable, "-c", "print('hi')"],
                           stdout=subprocess.PIPE, text=True)
          for _ in range(2)]
    assert wait_all(ok, 60) == [(0, "hi\n"), (0, "hi\n")]


#: the reference runs in two processes at once, each over a few meshes
REFERENCE_PARTS = ("222,x222", "4,42")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference (two processes) and both port jobs (8 and 4
    ranks) at once; every process is killed at the time limit."""
    tmp = tmp_path_factory.mktemp("shard")
    spec = json.dumps(dict(meshes=MESHES, cases=CASES, warm=WARM))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", DRONE_AUTOTUNE_DIR=str(tmp / "ref_tune"))
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE, spec,
                              str(tmp), part], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for part in REFERENCE_PARTS]
    tune = dict(DRONE_AUTOTUNE_DIR=str(tmp / "port_tune"))
    jobs = [spawn_ranks(PORT, w, [spec, str(tmp)], tmp / f"store{w}", tune)
            for w in (8, 4)]
    names = ([f"port rank {r} of {w}" for w in (8, 4) for r in range(w)]
             + [f"reference {part}" for part in REFERENCE_PARTS])
    wait_all(jobs[0] + jobs[1] + refs, 600, names)
    ref = {}
    for part in REFERENCE_PARTS:
        ref.update(np.load(tmp / f"reference_{part}.npz"))
    port = {}
    for w in (8, 4):
        for r in range(w):
            port[(w, r)] = dict(np.load(tmp / f"port_{w}_{r}.npz"))
    return ref, port


def _ranks(mesh_key):
    w = int(np.prod(MESHES[mesh_key][0]))
    return [(w, r) for r in range(w)]


def _hold(ref, port, mk, cid, pname):
    for key in _ranks(mk):
        got = port[key]
        if pname == "pr":
            np.testing.assert_allclose(got[cid + "/res"], ref[cid + "/res"],
                                       err_msg=f"{cid} rank {key}", **TOL)
        else:
            np.testing.assert_array_equal(got[cid + "/res"],
                                          ref[cid + "/res"],
                                          err_msg=f"{cid} rank {key}")
            np.testing.assert_array_equal(got[cid + "/counts"],
                                          ref[cid + "/counts"],
                                          err_msg=f"{cid} rank {key}")
            np.testing.assert_array_equal(got[cid + "/sweeps"],
                                          ref[cid + "/sweeps"],
                                          err_msg=f"{cid} rank {key}")
        if cid + "/asg" in ref:
            assert list(got[cid + "/asg"]) == list(ref[cid + "/asg"])


def test_same_partitioned_graphs(runs):
    ref, port = runs
    for key, got in port.items():
        for g in ("pl", "grid"):
            np.testing.assert_array_equal(got["gvid/" + g], ref["gvid/" + g],
                                          err_msg=f"{g} rank {key}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_shard_map_matches_reference(runs, case):
    ref, port = runs
    cid, mk, _, pname, _, _ = case
    _hold(ref, port, mk, cid, pname)
    # total_bytes: the reference's per-step bytes times the supersteps
    for key in _ranks(mk):
        assert port[key][cid + "/counts"][2] == ref[cid + "/counts"][2]


#: grid-12 SSSP from 0, P = 4 (n_slots = 131), against the dense exchange
#: (22 supersteps, 2,075 messages): capacity -> (result entries that
#: differ, supersteps, messages), the table of ROADMAP Queue 3
SPARSE_DROP = {1: (326, 3, 8), 4: (278, 17, 344), 32: (4, 22, 1703)}


def test_sparse_exchange_drop_reproduced(runs):
    """The reference's compacted exchange drops changed slots beyond its
    capacity; the port drops the same ones, so it differs from the dense
    exchange exactly where the reference does."""
    ref, port = runs
    dense = ref["4-dense-grid-sssp/res"]
    assert list(ref["4-dense-grid-sssp/counts"][:2]) == [22, 2075]
    for cap, (differ, steps, msgs) in SPARSE_DROP.items():
        cid = f"4-sparse{cap}-sssp"
        for got in [ref] + [port[key] for key in _ranks("4")]:
            assert int((got[cid + "/res"] != dense).sum()) == differ, cap
            assert list(got[cid + "/counts"][:2]) == [steps, msgs], cap


def test_lean_frontier_runs_to_the_bound_in_both(runs):
    ref, port = runs
    assert ref["222-lean-sssp/counts"][0] == 12
    assert ref["222-lean-cc/counts"][0] < 12
    for key in _ranks("222"):
        assert port[key]["222-lean-sssp/counts"][0] == 12


@pytest.mark.parametrize("case", WARM, ids=[c[0] for c in WARM])
def test_warm_start_matches_reference(runs, case):
    ref, port = runs
    cid, mk, _ = case
    _hold(ref, port, mk, cid + "/cold", "sssp")
    _hold(ref, port, mk, cid, "sssp")
    for key in _ranks(mk):
        got = port[key]
        np.testing.assert_array_equal(got[cid + "/res"],
                                      got[cid + "/cold/res"])
        assert got[cid + "/counts"][0] < got[cid + "/cold/counts"][0]


def test_total_bytes_follow_the_exchange(runs):
    """Dense, compacted and slot-sharded bytes per superstep, as the
    reference's own test spells them out (float32 / int32, K = 1, P = 4)."""
    ref, _ = runs
    import repro.core as R
    import repro.graphgen as RG
    g = RG.powerlaw_graph(400, seed=5, weighted=True).as_undirected()
    ns = R.partition_and_build(g, 4, "cdbh").n_slots
    steps, _, nbytes = ref["4-coo-cc/counts"]
    assert nbytes == steps * (ns + 1) * 4 * 4
    steps, _, nbytes = ref["42-sparse-cc/counts"]
    assert nbytes == steps * 24 * (4 + 4) * 4
    n_loc = -(-(ns + 1) // 2)
    steps, _, nbytes = ref["222-slots-cc/counts"]
    assert nbytes == steps * (n_loc + 1) * 4 * 4 * 2


@pytest.mark.parametrize("pname", ["sssp", "cc"])
def test_ungathered_results_are_each_ranks_block(runs, pname):
    """``gather_results=False``: each rank of a (2, 2) gloo mesh returns
    its own [1, v_max] block and [1] sweeps, bit for bit its rows of the
    gathered default, with the same supersteps and messages and two
    all-gathers fewer."""
    _, port = runs
    for key in _ranks("4"):
        got = port[key]
        part = int(got["f2/part"])
        full = f"f2/{pname}/gathered"
        blk = f"f2/{pname}/block"
        assert got[full + "/res"].shape[0] == 2
        assert got[blk + "/res"].shape[0] == 1
        np.testing.assert_array_equal(got[blk + "/res"],
                                      got[full + "/res"][part:part + 1])
        np.testing.assert_array_equal(got[blk + "/sweeps"],
                                      got[full + "/sweeps"][part:part + 1])
        steps, msgs, calls, gathered = got[full + "/counts"]
        assert list(got[blk + "/counts"]) == [steps, msgs, calls - 2,
                                              gathered - got[blk + "/res"]
                                              .nbytes - 4]
