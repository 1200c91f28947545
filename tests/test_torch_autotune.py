"""``edge_backend='auto'`` of the port against the JAX package: the modeled
calibration table (byte-deterministic, on disk under its own file name,
the reference's unit costs scaled by the ratio of the two memory rates),
per-partition picks equal to the reference's on the mixed-density fixture
and a power-law graph, and 'auto' queries bit-identical to the reference's
'auto' and to ``coo`` — results, supersteps, messages, per-partition
sweeps, the per-partition backends and the billed flops (PageRank within
1e-5). The reference's Pallas kernels run in interpret mode, as its own
tests run them."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.algos as RA
import repro.graphgen as RG
import repro_torch.algos as TA
import repro_torch.graphgen as TG
from repro.core import EngineConfig as RCfg
from repro.core import autotune as RT
from repro.core import build_partitioned_graph as rbuild
from repro.core import partition_and_build as rpartition
from repro.core import run_sim as rrun
from repro.core.engine import resolve_partition_backends as rresolve
from repro.core.graph import Graph as RGraph
from repro.session import GraphSession as RSession
from repro_torch.algos.mssp import make_mssp
from repro_torch.core import EngineConfig as TCfg
from repro_torch.core import autotune as TT
from repro_torch.core import build_partitioned_graph as tbuild
from repro_torch.core import partition_and_build as tpartition
from repro_torch.core import run_sim as trun
from repro_torch.core.api import DeviceSubgraph
from repro_torch.core.engine import (_device_subgraph, _tile_product,
                                     _window_product, normalize_edge_backend)
from repro_torch.core.engine import resolve_partition_backends as tresolve
from repro_torch.core.graph import Graph as TGraph
from repro_torch.session import GraphSession as TSession

TOL = dict(rtol=1e-5, atol=1e-5)
AUTO = "auto"


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("DRONE_AUTOTUNE_DIR", str(tmp_path))


def _mixed_density_graphs():
    """``tests/test_autotune.py``'s fixture: three 256-vertex blocks —
    dense (~50%), mid (~6%), ultra-sparse (~100 edges) — one per
    partition, so the modeled costs pick tiles, windows and COO."""
    rng = np.random.default_rng(42)
    B = 256
    src, dst, part = [], [], []

    def block(lo, n_edges, pid):
        s = rng.integers(lo, lo + B, n_edges)
        d = rng.integers(lo, lo + B, n_edges)
        keep = s != d
        src.append(s[keep])
        dst.append(d[keep])
        part.append(np.full(int(keep.sum()), pid, np.int64))

    block(0, int(0.50 * B * B), 0)
    block(B, int(0.06 * B * B), 1)
    block(2 * B, 100, 2)
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    part = np.concatenate(part)
    w = rng.random(src.size).astype(np.float32) + 0.1
    rg, tg = RGraph(3 * B, src, dst, w), TGraph(3 * B, src, dst, w)
    return rg, tg, rbuild(rg, part, 3), tbuild(tg, part, 3)


def _powerlaw_pgs():
    rg = RG.powerlaw_graph(1500, seed=4, weighted=True).as_undirected()
    tg = TG.powerlaw_graph(1500, seed=4, weighted=True).as_undirected()
    return rpartition(rg, 4, "cdbh"), tpartition(tg, 4, "cdbh")


# --------------------------------------------------------------------------- #
# the calibration table
# --------------------------------------------------------------------------- #
def test_modeled_table_byte_deterministic():
    t1 = TT.calibrate(device="cpu")
    t2 = TT.calibrate("torch-cpu")
    assert t1.platform == "torch-cpu" and t1.source == "modeled"
    assert t1.to_json() == t2.to_json()
    _, _, _, tpg = _mixed_density_graphs()
    lay = tpg.ensure_edge_layouts()
    assert TT.pick_backends(t1, tpg, lay) == TT.pick_backends(t2, tpg, lay)


def test_table_disk_roundtrip(tmp_path):
    t1 = TT.get_table(force=True, device="cpu")
    path = TT.table_path("torch-cpu")
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.exists(path)
    t2 = TT.load_table("torch-cpu")
    assert t2 is not None and t2.to_json() == t1.to_json()
    # a second get_table serves the cached file, not a fresh sweep
    with open(path, "w", encoding="utf-8") as f:
        f.write(t1.to_json().replace('"modeled"', '"from-disk"'))
    assert TT.get_table(device="cpu").source == "from-disk"
    # a corrupt file is recalibrated, never trusted
    with open(path, "w", encoding="utf-8") as f:
        f.write("{not json")
    assert TT.get_table(device="cpu").to_json() == t1.to_json()


def test_concurrent_writers_and_readers_share_one_cache(tmp_path):
    """The ranks of a job share the cache directory and calibrate at once
    on first use. Writers racing on one directory must all succeed (a
    shared temporary name let one writer's move take another's file, whose
    own move then raised ``FileNotFoundError``: a rank that crashed and
    left its peers waiting in a collective), readers must only ever see a
    whole table, and no temporary file may be left behind. 16 threads, a
    short switch interval, 100 saves or loads each."""
    import sys
    import threading
    table = TT.calibrate("torch-cpu")
    want = table.to_json()
    TT.save_table(table)
    errors, seen = [], []

    def writer():
        for _ in range(100):
            try:
                TT.save_table(table)
            except Exception as e:      # a failed save is the fault
                errors.append(repr(e))

    def reader():
        for _ in range(100):
            got = TT.load_table("torch-cpu")
            seen.append(None if got is None else got.to_json())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer if i % 2 else reader)
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(seen) == 800 and all(j == want for j in seen)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(
        TT.table_path("torch-cpu"))]


def test_schema_mismatch_raises():
    raw = TT.calibrate("torch-cpu").to_json().replace(
        f'"version": {TT.SCHEMA_VERSION}', '"version": 999')
    with pytest.raises(ValueError, match="schema"):
        TT.CalibrationTable.from_json(raw)
    assert (TT.SCHEMA_VERSION, TT.BACKEND_ORDER) == (RT.SCHEMA_VERSION,
                                                     RT.BACKEND_ORDER)


def test_unit_costs_are_the_reference_at_the_h100_rate():
    """The modeled costs are the reference's bytes over the H100's rate in
    place of the reference's: every unit cost scales by one ratio."""
    port = TT.calibrate("torch-cpu")
    ref = RT.calibrate("cpu")
    scale = RT.HBM_BW / TT.HBM_BYTES_PER_S
    assert sorted(port.unit_costs) == sorted(ref.unit_costs)
    for k, v in ref.unit_costs.items():
        np.testing.assert_allclose(port.unit_costs[k], v * scale, rtol=1e-9,
                                   err_msg=k)
    assert len(port.points) == len(ref.points)
    for a, b in zip(port.points, ref.points):
        for k in ("n_vertices", "n_edges", "n_tiles", "n_blocks",
                  "n_windows", "density"):
            assert a[k] == b[k], k


@pytest.mark.parametrize("which", ["mixed", "powerlaw"])
def test_picks_equal_the_reference(which):
    if which == "mixed":
        _, _, rpg, tpg = _mixed_density_graphs()
    else:
        rpg, tpg = _powerlaw_pgs()
    want = rresolve(RA.SSSP(), RCfg(edge_backend=AUTO), rpg,
                    lay=rpg.ensure_edge_layouts())
    got = tresolve(TA.SSSP(), TCfg(edge_backend=AUTO), tpg,
                   lay=tpg.ensure_edge_layouts(), device="cpu")
    assert got == want
    if which == "mixed":
        assert got == ("pallas_tiles", "pallas_windows", "coo")


def test_reference_table_json_picks_identically():
    """A table the JAX package wrote, loaded by the port, picks what the
    reference picks with it."""
    ref = RT.calibrate("cpu")
    port = TT.CalibrationTable.from_json(ref.to_json())
    for rpg, tpg in (_mixed_density_graphs()[2:], _powerlaw_pgs()):
        assert TT.pick_backends(port, tpg, tpg.ensure_edge_layouts()) == \
            RT.pick_backends(ref, rpg, rpg.ensure_edge_layouts())


def test_cache_file_name_differs_from_the_reference():
    ours = {os.path.basename(TT.table_path("torch-cpu")),
            os.path.basename(TT.table_path(
                "torch-cuda-sm90-NVIDIA-H100-80GB-HBM3"))}
    theirs = {os.path.basename(RT.table_path(p)) for p in ("cpu", "tpu",
                                                           "gpu")}
    assert not ours & theirs, (ours, theirs)
    TT.get_table(device="cpu")
    assert not os.path.exists(RT.table_path("cpu"))


def test_auto_runner_needs_the_assignment():
    """An 'auto' runner is built for one per-partition assignment; without
    it the engine refuses, as the reference's does, on both backends."""
    from repro_torch.core.engine import make_bsp_runner, make_sim_runner
    with pytest.raises(ValueError, match="partition_backends"):
        make_sim_runner(TA.SSSP(), TCfg(edge_backend=AUTO), 8)
    with pytest.raises(ValueError, match="partition_backends"):
        make_bsp_runner(TA.SSSP(), None,
                        TCfg(backend="shard_map", edge_backend=AUTO), 8)


def test_non_sweep_program_normalizes_to_coo():
    prog, _ = make_mssp([0, 5])
    eb, cfg = normalize_edge_backend(prog, TCfg(edge_backend=AUTO))
    assert eb == "coo" and cfg.edge_backend == "coo"


# --------------------------------------------------------------------------- #
# 'auto' queries
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["sssp", "cc"])
def test_auto_bit_identical_to_reference_and_coo(name):
    rg, tg, rpg, tpg = _mixed_density_graphs()
    if name == "sssp":
        rp, tp, params = RA.SSSP(), TA.SSSP(), {"source": 0}
    else:
        rp, tp, params = RA.ConnectedComponents(), \
            TA.ConnectedComponents(), None
    r, rst = rrun(rp, rpg, params, RCfg(edge_backend=AUTO))
    t, tst = trun(tp, tpg, params, TCfg(edge_backend=AUTO), device="cpu")
    c, cst = trun(tp, tpg, params, TCfg(), device="cpu")
    np.testing.assert_array_equal(t, np.asarray(r))
    np.testing.assert_array_equal(t, c)
    assert t.dtype == np.asarray(r).dtype
    assert tst.edge_backend == rst.edge_backend == AUTO
    assert (tst.supersteps, tst.total_messages, tst.processed_edges) == \
        (rst.supersteps, rst.total_messages, rst.processed_edges) == \
        (cst.supersteps, cst.total_messages, cst.processed_edges)
    assert tst.partition_sweeps == cst.partition_sweeps
    assert tst.partition_edge_backends == list(rst.partition_edge_backends)
    assert set(tst.partition_edge_backends) == {"coo", "pallas_tiles",
                                                "pallas_windows"}
    assert tst.backend_flops == rst.backend_flops > 0


def test_auto_tile_density_equals_reference():
    """'auto' counts the tile density from the geometry; it equals the
    reference's, which realizes every partition's tiles."""
    _, _, rpg, tpg = _mixed_density_graphs()
    _, rst = rrun(RA.SSSP(), rpg, {"source": 0}, RCfg(edge_backend=AUTO))
    _, tst = trun(TA.SSSP(), tpg, {"source": 0}, TCfg(edge_backend=AUTO),
                  device="cpu")
    np.testing.assert_allclose(tst.partition_tile_density,
                               rst.partition_tile_density, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(tst.tile_density, rst.tile_density,
                               rtol=1e-12, atol=0)
    assert tst.partition_tile_density[0] > tst.partition_tile_density[2]
    # only the tile group's partition had its values realized
    lay = tpg.edge_layouts
    assert not lay._tiles and list(lay._part_tiles[
        ("min_plus", "weight", np.dtype(np.float32).str)]) == [0]


def test_auto_pagerank_within_tolerance():
    rg, tg, rpg, tpg = _mixed_density_graphs()
    r, _ = rrun(RA.PageRank(tol=1e-7), rpg, {"n_vertices": rg.n_vertices},
                RCfg(edge_backend=AUTO))
    t, tst = trun(TA.PageRank(tol=1e-7), tpg, {"n_vertices": tg.n_vertices},
                  TCfg(edge_backend=AUTO), device="cpu")
    c, _ = trun(TA.PageRank(tol=1e-7), tpg, {"n_vertices": tg.n_vertices},
                TCfg(), device="cpu")
    np.testing.assert_allclose(t, np.asarray(r), **TOL)
    np.testing.assert_allclose(t, c, **TOL)
    assert len(set(tst.partition_edge_backends)) == 3


def test_auto_trace_mode_matches_runner():
    """Trace mode (the per-superstep stats path) runs the same mixed
    sweep."""
    _, _, _, tpg = _mixed_density_graphs()
    cfg = TCfg(edge_backend=AUTO)
    a, ast = trun(TA.SSSP(), tpg, {"source": 0}, cfg, device="cpu")
    b, bst = trun(TA.SSSP(), tpg, {"source": 0},
                  dataclasses.replace(cfg, trace=True), device="cpu")
    np.testing.assert_array_equal(a, b)
    assert bst.messages_per_step and sum(bst.messages_per_step) == \
        ast.total_messages


def test_auto_session_inbucket_flush_keeps_pin_compact_reresolves():
    """An in-bucket flush keeps the pinned assignment and the runner (both
    sessions); ``compact()`` clears the pin and the next query resolves it
    again — query by query equal to the reference session."""
    rg = RG.powerlaw_graph(900, seed=5, weighted=True).as_undirected()
    tg = TG.powerlaw_graph(900, seed=5, weighted=True).as_undirected()
    rs = RSession.from_graph(rg, 4, "ebv", cfg=RCfg(edge_backend=AUTO))
    ts = TSession.from_graph(tg, 4, "ebv", cfg=TCfg(edge_backend=AUTO),
                             device="cpu")

    def both(where):
        r, rst = rs.query(RA.SSSP(), {"source": 0}, warm=False)
        t, tst = ts.query(TA.SSSP(), {"source": 0}, warm=False)
        np.testing.assert_array_equal(t, np.asarray(r), err_msg=where)
        assert tst.partition_edge_backends == \
            list(rst.partition_edge_backends), where
        assert (tst.supersteps, tst.total_messages) == \
            (rst.supersteps, rst.total_messages), where
        assert tst.partition_flops == rst.partition_flops, where
        np.testing.assert_allclose(tst.partition_tile_density,
                                   rst.partition_tile_density, rtol=1e-12)
        return tuple(tst.partition_edge_backends)

    asg0 = both("first query")
    lay = ts.pg.edge_layouts
    caps = (lay.t_max, lay.b_max)
    rng = np.random.default_rng(7)
    s = rng.integers(0, tg.n_vertices, 30)
    d = rng.integers(0, tg.n_vertices, 30)
    keep = s != d
    w = np.ones(int(keep.sum()), np.float32)
    rs.update(adds=(s[keep], d[keep], w))
    ts.update(adds=(s[keep], d[keep], w))
    rs.flush()
    ts.flush()
    assert (lay.t_max, lay.b_max) == caps, "in-bucket by design"
    assert both("after an in-bucket flush") == asg0
    assert ts.stats.runner_builds == rs.stats.cache_misses == 1
    rs.compact()
    ts.compact()
    assert not ts._auto_pin
    both("after compact")
    assert len(ts._auto_pin) == 1


@pytest.mark.parametrize("group", [(0,), (1, 2), (0, 2), (0, 1, 2)])
def test_group_lists_equal_full_list_rows(group):
    """A group-sliced device list (its own ids, its own chunk plan, values
    realized for its partitions alone) gives each of its partitions the
    rows the full list gives it, through both plain kernel versions."""
    _, _, _, tpg = _mixed_density_graphs()
    lay = tpg.ensure_edge_layouts()
    spec = TA.SSSP().sweep_spec
    sgs = _device_subgraph(tpg, "cpu")
    rng = np.random.default_rng(len(group))
    v = torch.from_numpy(rng.uniform(0, 9, (tpg.n_parts, tpg.v_max, 2))
                         .astype(np.float32))
    gi = torch.tensor(group)
    sub = DeviceSubgraph(*[None if x is None else x[gi] for x in sgs])
    t_grp = lay.device_tiles(tpg, spec.semiring, spec.edge_values,
                             np.float32, "cpu", parts=group)
    assert t_grp.plan.n_rows == len(group) * lay.n_dst_tiles
    assert not lay._tiles                 # realized for the group alone
    got_t = _tile_product(t_grp, v[gi], spec, tpg.v_max)
    got_w = _window_product(sub, lay.device_windows("cpu", parts=group),
                            v[gi], spec, tpg.v_max)
    full_t = _tile_product(lay.device_tiles(tpg, spec.semiring,
                                            spec.edge_values, np.float32,
                                            "cpu"), v, spec, tpg.v_max)
    full_w = _window_product(sgs, lay.device_windows("cpu"), v, spec,
                             tpg.v_max)
    assert torch.equal(got_t, full_t[gi])
    assert torch.equal(got_w, full_w[gi])
    with pytest.raises(ValueError, match="ascending"):
        lay.device_windows("cpu", parts=(2, 0))


@pytest.mark.parametrize("backend", ["coo", "pallas_tiles", "pallas_windows"])
def test_single_group_auto_runs_the_uniform_path(backend, monkeypatch):
    """An 'auto' assignment that gives every partition one backend sweeps
    on that backend's full device list, with no sub-stack and no
    write-back, and matches the uniform runner bit for bit."""
    import repro_torch.core.engine as E
    _, _, _, tpg = _mixed_density_graphs()
    lay = tpg.ensure_edge_layouts()
    prog = TA.SSSP()
    asg = (backend,) * tpg.n_parts
    blocks = E._auto_layout_blocks(lay, tpg, prog, asg, "cpu")
    if backend != "coo":
        full = E._layout_block_from(lay, tpg, prog, backend, "cpu")
        assert full is blocks[backend == "pallas_windows"]

    def no_mix(*a, **k):
        raise AssertionError("a one-group assignment took the mixed path")
    monkeypatch.setattr(E, "_mixed_inputs", no_mix)
    sgs = _device_subgraph(tpg, "cpu")
    got = E.make_sim_runner(prog, TCfg(edge_backend=AUTO), tpg.n_slots,
                            partition_backends=asg)(sgs, blocks,
                                                    {"source": 0})
    want = E.make_sim_runner(prog, TCfg(edge_backend=backend), tpg.n_slots)(
        sgs, None if backend == "coo" else full, {"source": 0})
    assert torch.equal(got[0], want[0])
    assert got[1:3] == want[1:3] and got[4] == want[4]
    np.testing.assert_array_equal(got[3], want[3])
