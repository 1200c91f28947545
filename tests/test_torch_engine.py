"""Engine parity: the port's simulator against ``repro.core`` on the SAME
partitioned graph (carried across by ``repro_torch.interop``). SSSP and CC
results are bit-identical, and so are supersteps, messages and the
per-partition sweep counts; PageRank results are allclose at
rtol = atol = 1e-5 (its tol test can flip on reordered float sums, so its
counts are not compared)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.algos as RA
import repro.core as R
import repro.graphgen as RG
import repro_torch.algos as TA
import repro_torch.core as T
from repro.core import engine as reng
from repro_torch.core import engine as teng
from repro.core.layouts import build_edge_layouts as rbuild
from repro.core.subgraph import ShapePolicy as RShapePolicy
from repro_torch.core.layouts import build_edge_layouts as tbuild
from repro_torch.core.subgraph import ShapePolicy as TShapePolicy
from repro_torch.interop import (partitioned_graph_from_arrays,
                                 warm_block_from_numpy)
from repro_torch.kernels.bsp_spmv import bsp_spmv_plain
from repro_torch.kernels.ref import combine_identity
from repro_torch.kernels.segment_combine import segment_combine_plain

BACKENDS = ("coo", "pallas_tiles", "pallas_windows")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def graphs():
    g = RG.powerlaw_graph(400, seed=5, weighted=True).as_undirected()
    rpg = R.partition_and_build(g, 4, "cdbh")
    tpg = partitioned_graph_from_arrays(
        {f.name: getattr(rpg, f.name) for f in dataclasses.fields(rpg)})
    return g, rpg, tpg


def _programs(n):
    return {"sssp": (RA.SSSP(), TA.SSSP(), {"source": 0}),
            "cc": (RA.ConnectedComponents(), TA.ConnectedComponents(), None),
            "pagerank": (RA.PageRank(), TA.PageRank(), {"n_vertices": n})}


def _reference_run(prog, rpg, params, cfg, warm=None):
    eb = reng.resolve_edge_backend(prog, cfg)
    runner = reng.make_sim_runner(prog, cfg, rpg.n_slots,
                                  warm_start=warm is not None)
    args = (reng._device_subgraph(rpg),)
    if eb != "coo":
        args += (reng._layout_block_from(rpg.ensure_edge_layouts(), rpg,
                                         prog, eb),)
    args += (params,)
    if warm is not None:
        args += (jnp.asarray(warm),)
    res, steps, msgs, sweeps = runner(*args)
    return (np.asarray(res), int(steps), int(msgs),
            np.asarray(sweeps, np.int64))


def _port_run(prog, tpg, params, cfg, warm=None):
    eb = teng.resolve_edge_backend(prog, cfg)
    runner = teng.make_sim_runner(prog, cfg, tpg.n_slots,
                                  warm_start=warm is not None)
    lay = None
    if eb != "coo":
        lay = teng._layout_block_from(tpg.ensure_edge_layouts(), tpg, prog,
                                      eb, "cpu")
    sgs = teng._device_subgraph(tpg, "cpu")
    w = None if warm is None else torch.from_numpy(warm)
    res, steps, msgs, sweeps, _ = runner(sgs, lay, params, w)
    return res.numpy(), steps, msgs, sweeps


@pytest.mark.parametrize("mode", ["sc", "vc"])
@pytest.mark.parametrize("eb", BACKENDS)
@pytest.mark.parametrize("algo", ["sssp", "cc", "pagerank"])
def test_runner_parity(graphs, algo, eb, mode):
    g, rpg, tpg = graphs
    rprog, tprog, params = _programs(g.n_vertices)[algo]
    want = _reference_run(rprog, rpg, params,
                          R.EngineConfig(edge_backend=eb, mode=mode))
    got = _port_run(tprog, tpg, params,
                    T.EngineConfig(edge_backend=eb, mode=mode))
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    if algo == "pagerank":
        np.testing.assert_allclose(got[0], want[0], **TOL)
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3], "supersteps / messages"
    np.testing.assert_array_equal(got[3], want[3], err_msg="sweeps per part")


@pytest.mark.parametrize("eb", BACKENDS)
def test_run_sim_stats_match(graphs, eb):
    g, rpg, tpg = graphs
    for algo, (rprog, tprog, params) in _programs(g.n_vertices).items():
        r, rs = R.run_sim(rprog, rpg, params, R.EngineConfig(edge_backend=eb))
        t, ts = T.run_sim(tprog, tpg, params, T.EngineConfig(edge_backend=eb),
                          device="cpu")
        assert ts.edge_backend == rs.edge_backend == eb
        if algo == "pagerank":
            np.testing.assert_allclose(t, r, **TOL)
            continue
        np.testing.assert_array_equal(t, r)
        for f in ("supersteps", "total_messages", "processed_edges",
                  "backend_flops", "total_bytes", "tile_density"):
            assert getattr(ts, f) == getattr(rs, f), (algo, f)
        assert ts.host_syncs >= ts.supersteps


@pytest.mark.parametrize("eb", BACKENDS)
def test_warm_init_state(graphs, eb):
    """A warm start from a converged result after growth: the reference's
    ``run_sim(init_state=...)`` and the port's agree, and the carried warm
    block is the reference's ``_warm_block`` bit for bit."""
    g, rpg, tpg = graphs
    prev_r, _ = R.run_sim(RA.SSSP(), rpg, {"source": 3})
    init = rpg.collect(prev_r, fill=np.float32(np.inf))
    init[::7] = np.inf            # loosen some values: the run tightens them
    cfg_r, cfg_t = R.EngineConfig(edge_backend=eb), \
        T.EngineConfig(edge_backend=eb)
    r, rs = R.run_sim(RA.SSSP(), rpg, {"source": 3}, cfg_r, init_state=init)
    t, ts = T.run_sim(TA.SSSP(), tpg, {"source": 3}, cfg_t, init_state=init,
                      device="cpu")
    np.testing.assert_array_equal(t, r)
    assert (ts.supersteps, ts.total_messages) == \
        (rs.supersteps, rs.total_messages)
    wr = reng._warm_block(RA.SSSP(), rpg, init)
    wt = teng._warm_block(TA.SSSP(), tpg, init)
    np.testing.assert_array_equal(wt, wr)
    blk = warm_block_from_numpy(TA.SSSP(), tpg, wr)
    got = _port_run(TA.SSSP(), tpg, {"source": 3}, cfg_t, warm=blk)
    want = _reference_run(RA.SSSP(), rpg, {"source": 3}, cfg_r, warm=wr)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("eb", ["coo", "pallas_windows"])
def test_trace_mode(graphs, eb):
    g, rpg, tpg = graphs
    cfg_r = R.EngineConfig(edge_backend=eb, trace=True)
    cfg_t = T.EngineConfig(edge_backend=eb, trace=True)
    r, rs = R.run_sim(RA.ConnectedComponents(), rpg, None, cfg_r)
    t, ts = T.run_sim(TA.ConnectedComponents(), tpg, None, cfg_t,
                      device="cpu")
    np.testing.assert_array_equal(t, r)
    assert ts.messages_per_step == rs.messages_per_step
    assert ts.active_parts_per_step == rs.active_parts_per_step
    assert (ts.supersteps, ts.processed_edges, ts.total_bytes) == \
        (rs.supersteps, rs.processed_edges, rs.total_bytes)


def test_engine_config_validation_matches():
    for kw in (dict(mode="x"), dict(backend="x"), dict(edge_backend="x"),
               dict(max_local_iters=0), dict(max_supersteps=0),
               dict(checkpoint_every=-1), dict(edge_axes="model")):
        with pytest.raises(ValueError):
            R.EngineConfig(**kw)
        with pytest.raises(ValueError):
            T.EngineConfig(**kw)
    assert [f.name for f in dataclasses.fields(T.EngineConfig)] == \
        [f.name for f in dataclasses.fields(R.EngineConfig)]
    assert T.EngineConfig(mode="vc").local_bound == 1
    assert T.EngineConfig(edge_axes=["a"]).edge_axes == ("a",)


def _padded_product(tl, tpg, prog, eb, vals):
    """The same product on the JAX package's padded stacked layout (every
    partition padded to t_max tiles / b_max blocks), through the plain
    versions: what the device lists were before they became compact."""
    spec = prog.sweep_spec
    P, v_max, K = vals.shape
    offs = np.arange(P)[:, None]
    if eb == "pallas_tiles":
        tiles = tl.tile_values(tpg, spec.semiring, spec.edge_values,
                               prog.dtype)
        td = (tl.tile_dst + offs * tl.n_dst_tiles).reshape(-1)
        ts = (tl.tile_src + offs * tl.n_src_tiles).reshape(-1)
        _, _, _, v, ndt, _ = teng._tile_inputs(
            tl.device_tiles(tpg, spec.semiring, spec.edge_values, prog.dtype,
                            "cpu"), vals, spec, v_max)
        out = bsp_spmv_plain(
            torch.from_numpy(tiles.reshape(-1, 128, 128)),
            torch.from_numpy(td.astype(np.int32)),
            torch.from_numpy(ts.astype(np.int32)), v, n_dst_tiles=ndt,
            semiring=spec.semiring)
        return out.reshape(P, -1, K)[:, :v_max]
    sg = teng._device_subgraph(tpg, "cpu")
    msgs = teng._edge_messages(sg, spec, vals, sg.esrc, sg.ew)
    n_buf = tl.ldst.shape[-1]
    slot = np.where(tl.eslot >= 0, tl.eslot + offs * n_buf, P * n_buf)
    ident = combine_identity(spec.combiner, prog.dtype).item()
    buf = torch.full((P * n_buf + 1, K), ident, dtype=vals.dtype)
    buf.index_copy_(0, torch.from_numpy(slot.reshape(-1).astype(np.int64)),
                    msgs.reshape(-1, K))
    bwin = (tl.bwin + offs * tl.n_windows).reshape(-1).astype(np.int32)
    out = segment_combine_plain(
        buf[:-1], torch.from_numpy(tl.ldst.reshape(-1)),
        torch.from_numpy(bwin), n_windows=P * tl.n_windows,
        combiner=spec.combiner)
    return out.reshape(P, -1, K)[:, :v_max]


@pytest.mark.parametrize("eb", ["pallas_tiles", "pallas_windows"])
@pytest.mark.parametrize("algo", ["sssp", "cc", "pagerank"])
def test_products_on_compact_lists(graphs, algo, eb):
    """``_tile_product`` / ``_window_product`` on the compact device lists
    equal the same product on the padded stacked layout and the JAX
    package's product on its own layout (Pallas in interpret mode)."""
    g, rpg, tpg = graphs
    rprog, tprog, _ = _programs(g.n_vertices)[algo]
    tl = tbuild(tpg, TShapePolicy(growth=2.0))
    rl = rbuild(rpg, RShapePolicy(growth=2.0))
    P, v_max, K = tpg.n_parts, tpg.v_max, 2
    assert tl.t_max * P > tl.n_tiles.sum() and \
        tl.b_max * P > tl.n_blocks.sum()
    rng = np.random.default_rng(3)
    if algo == "cc":
        vals = rng.integers(0, 1000, size=(P, v_max, K)).astype(np.int32)
    else:
        vals = rng.uniform(0, 3, size=(P, v_max, K)).astype(np.float32)
    tv = torch.from_numpy(vals)
    spec = tprog.sweep_spec
    blk = teng._layout_block_from(tl, tpg, tprog, eb, "cpu")
    if eb == "pallas_tiles":
        got = teng._tile_product(blk, tv, spec, v_max)
        want = reng._tile_product(
            reng._layout_block_from(rl, rpg, rprog, eb), jnp.asarray(vals),
            rprog.sweep_spec, v_max)
    else:
        sg = teng._device_subgraph(tpg, "cpu")
        got = teng._window_product(sg, blk, tv, spec, v_max)
        rsg = reng._device_subgraph(rpg)
        want = reng._window_product(
            reng._layout_block_from(rl, rpg, rprog, eb), jnp.asarray(vals),
            rprog.sweep_spec, v_max, rsg.esrc, rsg.ew)
    padded = _padded_product(tl, tpg, tprog, eb, tv)
    assert got.dtype == padded.dtype and got.shape == (P, v_max, K)
    np.testing.assert_array_equal(got.numpy(), padded.numpy())
    if algo == "pagerank":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
