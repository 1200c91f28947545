"""The port's capacity dry run (``repro_torch.launch.dryrun_graph``,
``launch.mesh``, ``launch.fake_stats``, ``launch.roofline``) against the
JAX package's ``launch/dryrun_graph.py`` and ``launch/roofline.py``, and
against a real ``shard_map`` run.

The reference's ``dryrun_graph`` sets ``XLA_FLAGS`` when it is imported
(512 host devices), so it runs in a subprocess, as in
``tests/test_dryrun.py``; nothing of it is compiled. The port's fake world
of ranks is made and destroyed inside each call.

  - ``GraphScale.meta`` on the one-pod, two-pod and trillion meshes and
    the ``v_max`` skip equal the reference's; one rank's argument bytes
    for kron26 on the two-pod mesh equal the reference's per-device bytes
    (``shard_shape`` x itemsize of its stand-ins);
  - on a 400-vertex power-law graph, a 4-rank gloo job on a (2, 2) mesh
    records each rank's block bytes and each superstep's collective
    payload bytes and sweeps (trace mode); the dry run of the same meta
    and configuration gives the same block bytes and, per superstep,
    base + sweeps x per-sweep bytes, exactly;
  - the SBS part of a dry superstep equals ``_exchange_bytes_per_step``
    for the dense, compacted and slot-sharded exchanges;
  - ``roofline.param_counts`` equals the reference's for every LM arch,
    and ``analyze_record`` gives the expected terms on a fixed record.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.engine import EngineConfig, _exchange_bytes_per_step
from repro_torch.launch import dryrun_graph as D
from repro_torch.launch import fake_stats, mesh as LM, roofline as RL

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": (16, 16), "multipod": (32, 16), "trillion": (128, 16)}

REFERENCE = r"""
import json, sys
import numpy as np
from repro.launch import dryrun_graph as R
from repro.launch.mesh import make_production_mesh

parts = json.loads(sys.argv[1])
metas = {f"{s}/{m}": R.SCALES[s].meta(*parts[m]) for s in R.SCALES
         for m in parts}
try:
    R.lower_graph_cell("kron33-100B", "cc", False)
    skip = None
except ValueError as e:
    skip = str(e)
mesh = make_production_mesh(multi_pod=True)
meta = R.SCALES["kron26"].meta(32, mesh.shape["model"])
sgs = R._sds_subgraph(meta, 32, mesh, ("pod", "data"), ("model",))
nbytes = sum(int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
             for x in sgs if x is not None)
print("REF " + json.dumps(dict(metas=metas, skip=skip, kron26_bytes=nbytes)))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE,
                          json.dumps(MESHES)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("REF ")][-1]
    return json.loads(line[4:])


@pytest.mark.parametrize("scale", sorted(D.SCALES))
def test_meta_equals_reference(reference, scale):
    for mesh, parts in MESHES.items():
        assert D.SCALES[scale].meta(*parts) == \
            reference["metas"][f"{scale}/{mesh}"], (scale, mesh)


def test_vmax_guard_skips_with_reference_text(reference, tmp_path):
    with pytest.raises(ValueError) as err:
        D.dry_graph_cell("kron33-100B", "cc", False)
    assert str(err.value) == reference["skip"]
    rec = D.run_cell("kron33-100B", "cc", "single", str(tmp_path))
    assert rec["status"] == "skipped" and rec["reason"] == reference["skip"]
    assert (tmp_path / "graph__kron33-100B__cc__single.json").exists()


@pytest.mark.parametrize("algo", sorted(D.ALGOS))
def test_kron26_argument_bytes_equal_reference(reference, algo):
    meta, n_parts, dry = D.dry_graph_cell("kron26", algo, True)
    assert n_parts == 32
    assert dry["memory"]["argument_size_in_bytes"] == \
        reference["kron26_bytes"]
    # 13 B an edge slot of the rank's 1/16 of e_max, 19 B a vertex slot
    assert reference["kron26_bytes"] == \
        13 * meta["e_max"] // 16 + 19 * meta["v_max"]


def test_trillion_cell_on_its_2048_rank_world(tmp_path):
    rec = D.run_cell("trillion", "pagerank", "multipod", str(tmp_path))
    assert rec["status"] == "ok", rec
    assert rec["n_devices"] == 2048 and rec["n_parts"] == 128
    assert rec["meta"]["n_slots"] == 2 ** 32
    m = rec["memory"]
    assert m["argument_size_in_bytes"] == \
        13 * rec["meta"]["e_max"] // 16 + 19 * rec["meta"]["v_max"]
    assert m["output_size_in_bytes"] == 4 * rec["meta"]["v_max"] + 4
    assert m["gathered_output_size_in_bytes"] == \
        128 * m["output_size_in_bytes"]
    assert m["temp_size_in_bytes"] > m["output_size_in_bytes"]
    w = rec["walk"]
    assert w["sweeps_per_superstep"] == 64
    # every sweep all-reduces its [1, v_max] aggregate over the 16 edge
    # shards; the sharded SBS buffer is (n_slots + 1) / 16 rounded up,
    # plus its dump row, of float32
    n_loc = -(-(2 ** 32 + 1) // 16)
    assert rec["per_sweep"]["collective_by_group"] == \
        {"sub": 0, "edge": 4 * rec["meta"]["v_max"]}
    assert rec["superstep_base"]["collective_by_group"]["sub"] == \
        (n_loc + 1) * 4 + 8
    assert w["collective_bytes_per_device"] == \
        rec["superstep_base"]["collective_bytes_per_device"] \
        + 64 * rec["per_sweep"]["collective_bytes_per_device"]
    assert w["collective_counts"] == {"all_reduce": 4 + 64}
    assert w["dot_flops_per_device"] == 0
    assert w["semiring_ops_per_device"] == 2 * rec["meta"]["e_max"] // 16 * 64


@pytest.mark.parametrize("extra,ranks", [
    ({}, "sub"), ({"sparse_sync_capacity": 96}, "sub"),
    ({"shard_slots": True}, "all")])
def test_sbs_bytes_equal_exchange_bytes_per_step(extra, ranks):
    """The subgraph group's payload of a dry superstep, less the 8-byte
    count pair, is what ``_exchange_bytes_per_step`` charges one rank of
    the exchange."""
    meta = dict(e_max=4096, v_max=640, n_slots=1000)
    cfg = EngineConfig(backend="shard_map", subgraph_axes=("sub",),
                       edge_axes=("edge",), **extra)
    prog, params = D.ALGOS["sssp"]
    dry = D.dry_run(meta, (4, 2), ("sub", "edge"), cfg, prog(), params)
    n = 4 * (2 if ranks == "all" else 1)
    want = _exchange_bytes_per_step(cfg, meta["n_slots"], 1, np.float32,
                                    4, 2)
    for key in ("superstep_base", "first_superstep_base"):
        assert dry[key]["collective_by_group"]["sub"] - 8 == want // n


RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["DRONE_INIT"],
                        rank=rank, world_size=world)
import repro_torch.algos as A
import repro_torch.graphgen as G
from repro_torch.core import EngineConfig, partition_and_build, run
from repro_torch.core.engine import _device_subgraph
from repro_torch.core.mesh import placement
from repro_torch.launch.mesh import make_mesh

g = G.powerlaw_graph(400, seed=5, weighted=True).as_undirected()
pg = partition_and_build(g, 2, "cdbh")
mesh = make_mesh((2, 2), ("sub", "edge"))
pl = placement(mesh, ("sub",), ("edge",))
blk = _device_subgraph(pg, "cpu", block=(pl.part, pl.shard, pl.n_edge))
out = dict(meta=dict(e_max=pg.e_max, v_max=pg.v_max, n_slots=pg.n_slots),
           n_vertices=g.n_vertices,
           args=sum(t.numel() * t.element_size() for t in blk
                    if t is not None), runs={})
for name, extra in json.loads(sys.argv[1]):
    prog, params = {"sssp": (A.SSSP(), {"source": 0}),
                    "cc": (A.ConnectedComponents(), None),
                    "pagerank": (A.PageRank(),
                                 {"n_vertices": g.n_vertices})}[name]
    cfg = EngineConfig(backend="shard_map", subgraph_axes=("sub",),
                       edge_axes=("edge",), trace=True, **extra)
    _, st = run(prog, pg, params, cfg, mesh=mesh, device="cpu")
    out["runs"][name + json.dumps(extra)] = dict(
        steps=st.collective_bytes_per_step,
        sweeps=st.rank_sweeps_per_step, total=st.collective_bytes,
        supersteps=st.supersteps)
with open(os.path.join(sys.argv[2], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""

RUNS = [("sssp", {}), ("cc", {}), ("pagerank", {}),
        ("cc", {"shard_slots": True}), ("sssp", {"lean_frontier": True,
                                                 "max_supersteps": 6})]


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    from test_torch_shard import spawn_ranks, wait_all
    tmp = tmp_path_factory.mktemp("dry_ranks")
    procs = spawn_ranks(RANK, 4, [json.dumps(RUNS), str(tmp)], tmp / "store")
    wait_all(procs, 300, [f"rank {r}" for r in range(4)])
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("name,extra", RUNS,
                         ids=[n + "-" + "-".join(e) for n, e in RUNS])
def test_dry_run_equals_a_real_2x2_run(gloo_ranks, name, extra):
    """Block bytes and every superstep's payload bytes of a real 4-rank
    gloo run equal the dry run's, on every rank."""
    r0 = gloo_ranks[0]
    prog, params = D.ALGOS[name]
    if name == "pagerank":
        params = {"n_vertices": r0["n_vertices"]}
    cfg = EngineConfig(backend="shard_map", subgraph_axes=("sub",),
                       edge_axes=("edge",), **extra)
    key = name + json.dumps(extra)
    for rank, got in enumerate(gloo_ranks):
        assert got["meta"] == r0["meta"]
        dry = D.dry_run(r0["meta"], (2, 2), ("sub", "edge"), cfg, prog(),
                        params, rank=rank, gather_results=True)
        assert dry["memory"]["argument_size_in_bytes"] == got["args"]
        run = got["runs"][key]
        assert len(run["steps"]) == run["supersteps"] > 1
        assert run["steps"] == D.expected_step_bytes(dry, run["sweeps"])
        assert dry["per_sweep"]["collective_bytes_per_device"] == \
            4 * r0["meta"]["v_max"]
        # the whole run: its supersteps plus the closing all-gathers of
        # the results and the sweeps
        assert sum(run["total"].values()) == sum(run["steps"]) + \
            4 * r0["meta"]["v_max"] + 4


def test_roofline_param_counts_equal_reference():
    from repro.configs import ARCHS
    from repro.launch import roofline as R
    archs = [a for a in ARCHS if a != "drone_graph"]
    assert len(archs) == 10
    for arch in archs:
        assert RL.param_counts(arch) == R.param_counts(arch), arch


def test_analyze_record_terms():
    rec = {"scale": "kron26", "algo": "cc", "mesh": "multipod",
           "kind": "graph_engine", "variant": "opt", "status": "ok",
           "n_devices": 512,
           "memory": {"argument_size_in_bytes": 3 * 2 ** 30,
                      "temp_size_in_bytes": 5 * 2 ** 30},
           "walk": {"dot_flops_per_device": 989e9,
                    "semiring_ops_per_device": 67e9,
                    "hbm_bytes_per_device": 6.7e12,
                    "collective_wire_bytes_per_device": 100e9,
                    "collective_by_kind": {"all_reduce": 1.0}}}
    row = RL.analyze_record(rec, hbm_cap=8 * 2 ** 30)
    assert row["terms"] == pytest.approx(
        {"compute_s": 2e-3, "memory_s": 2.0, "collective_s": 2.0})
    assert row["fits_hbm"] and row["temp_gib"] == 5 and row["args_gib"] == 3
    assert not RL.analyze_record(rec, hbm_cap=8 * 2 ** 30 - 1)["fits_hbm"]
    small = dict(rec, n_devices=8)      # one NVLink node: 450 GB/s
    assert RL.analyze_record(small, 1)["terms"]["collective_s"] == \
        pytest.approx(100e9 / 450e9)
    skipped = RL.analyze_record(dict(status="skipped", mesh="single"))
    assert skipped["terms"] is None
    table = RL.markdown_table([row, dict(rec, status="skipped",
                                         reason="too big", terms=None)])
    assert "| graph:kron26 | cc | multipod | 2.000e-03 |" in table
    assert "| skipped |" in table


def test_cli_runs_every_cell_and_roofline(tmp_path):
    """``--scale all --algo all --mesh both`` writes every cell (the
    three kron33-100B one-pod cells skipped, so it exits 1, as the
    reference's does); the roofline reads them all."""
    out = tmp_path / "dry"
    with pytest.raises(SystemExit) as ex:
        D.main(["--scale", "all", "--algo", "all", "--mesh", "both",
                "--out", str(out)])
    assert ex.value.code == 1
    recs = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    assert len(recs) == 24
    bad = [(r["scale"], r["algo"], r["mesh"], r["status"]) for r in recs
           if r["status"] != ("skipped" if (r["scale"], r["mesh"]) ==
                              ("kron33-100B", "single") else "ok")]
    assert not bad, bad
    RL.main(["--dry", str(out), "--out", str(tmp_path / "roofline.md")])
    rows = json.loads((tmp_path / "roofline.json").read_text())
    assert sum(r["terms"] is not None for r in rows) == 21
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in \
        (tmp_path / "roofline.md").read_text()


def test_meshes_and_fake_world():
    with LM.fake_world(512, rank=37):
        for multi, shape, names in (
                (False, (16, 16), ("data", "model")),
                (True, (2, 16, 16), ("pod", "data", "model"))):
            m = LM.make_production_mesh(multi_pod=multi)
            assert tuple(m.mesh.shape) == shape
            assert m.mesh_dim_names == names
            assert LM.make_graph_mesh(multi_pod=multi).mesh_dim_names == names
        h = LM.make_host_mesh(4, "sub")
        assert h.mesh.tolist() == [0, 1, 2, 3]
        with pytest.raises(RuntimeError):
            with LM.fake_world(2):
                pass
        with pytest.raises(ValueError):
            LM.make_mesh((32, 32), ("a", "b"))
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError):
        LM.make_host_mesh(2)


def test_op_counter():
    """Bytes each op reads and writes, views free, matmul FLOPs, the peak
    of live bytes above tensors made before the counter."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(64, 32)                  # arguments: 8 KiB, 2 KiB
        w = torch.empty(32, 16)
        c = fake_stats.OpCounter()
        with c:
            with c.window("mm"):
                b = a @ w                        # 4 KiB out
            v = b[:, None]                       # a view: nothing
            d = b + 1                            # 4 KiB in, 4 KiB out
            del v, b
            e = d.sum()                          # 4 KiB in, 4 B out
    assert c.windows["mm"] == dict(dot_flops=2 * 64 * 16 * 32, ops=1,
                                   hbm_bytes=8192 + 2048 + 4096,
                                   collective_counts={})
    assert c.hbm_bytes == 14336 + 8192 + 4100
    assert c.peak == 8192 and c.live == 4100    # b and d were live at once
    assert e.shape == ()
