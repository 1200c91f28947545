"""Algorithm-suite parity: each program of the port's suite (BFS, MSBFS,
triangles, MSSP, label propagation, k-core, SigmaCount, BrandesAccum, graph
simulation, and the staged betweenness function) against the JAX package's
on the SAME partitioned graph (carried across by ``repro_torch.interop``),
over the differential harness's power-law graphs and its pathological zoo.

Results, supersteps, messages and per-partition sweep counts are
bit-identical, except SigmaCount, BrandesAccum and betweenness ``bc``,
whose float sums are compared at rtol = atol = 1e-5 (tests/harness.py's
tolerance). BFS, MSBFS and triangles also run on both kernel backends
(the reference's Pallas kernels in interpret mode) and must give the COO
answer. Each result is also held against the harness's numpy oracle."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import repro.algos as RA
import repro.core as R
import repro_torch.algos as TA
import repro_torch.core as T
from harness import (brandes_oracle, build, harness_powerlaw,
                     kcore_peeled_oracle, lp_lanes_oracle, msbfs_oracle,
                     pathological_graphs, triangles_oracle,
                     bfs_levels_oracle, _pivots)
from repro.algos.gsim import make_gsim as r_make_gsim
from repro.algos.mssp import make_mssp as r_make_mssp
from repro.core import engine as reng
from repro_torch.algos.gsim import make_gsim as t_make_gsim
from repro_torch.algos.mssp import make_mssp as t_make_mssp
from repro_torch.core import engine as teng
from repro_torch.interop import partitioned_graph_from_arrays

TOL = dict(rtol=1e-5, atol=1e-5)
QADJ = np.array([[0, 1, 1], [0, 0, 1], [0, 0, 0]], np.int32)
QLABEL = np.array([0, 1, 2], np.int32)
KERNEL_PROGRAMS = ("bfs", "msbfs", "triangles")
FLOAT_SUMS = ("sigma", "accum")


def _graph_zoo():
    return [("powerlaw200", harness_powerlaw(200, 1)),
            ("powerlaw300", harness_powerlaw(300, 2))] + pathological_graphs()


GRAPHS = dict(_graph_zoo())


def _labels(n):
    return np.random.default_rng(4).integers(0, 3, n).astype(np.int32)


@pytest.fixture(scope="module")
def built():
    """name -> (graph, reference pg, port pg), vertex labels attached."""
    out = {}
    for name, g in GRAPHS.items():
        rpg = build(g, 4)
        rpg.set_vertex_labels(_labels(g.n_vertices))
        tpg = partitioned_graph_from_arrays(
            {f.name: getattr(rpg, f.name) for f in dataclasses.fields(rpg)})
        out[name] = (g, rpg, tpg)
    return out


def _jnp_params(params):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in (params or {}).items()}


def _case(name, g):
    """(reference program, port program, params as numpy, oracle values,
    collect fill)."""
    pv = _pivots(g)
    n = g.n_vertices
    if name == "bfs":
        return (RA.BFS(), TA.BFS(), {"source": 0}, bfs_levels_oracle(g, 0),
                np.inf)
    if name == "msbfs":
        return (RA.make_msbfs(pv)[0], TA.make_msbfs(pv)[0],
                TA.make_msbfs(pv)[1], msbfs_oracle(g, pv), np.inf)
    if name == "triangles":
        return (RA.make_triangles(pv)[0], TA.make_triangles(pv)[0],
                TA.make_triangles(pv)[1], triangles_oracle(g, pv), 0.0)
    if name == "mssp":
        return (r_make_mssp(pv)[0], t_make_mssp(pv)[0], t_make_mssp(pv)[1],
                msbfs_oracle(g, pv), np.inf)   # unit weights: hop counts
    if name == "lp":
        return (RA.LabelPropagation(hops=3), TA.make_lp(3)[0], {},
                lp_lanes_oracle(g, 3), 2**31 - 1)
    if name.startswith("kcore"):
        k = int(name[-1])
        return (RA.KCore(k=k), TA.make_kcore(k)[0], {},
                kcore_peeled_oracle(g, k), 0)
    if name == "gsim":
        return (r_make_gsim(QADJ, QLABEL)[0], t_make_gsim(QADJ, QLABEL)[0],
                t_make_gsim(QADJ, QLABEL)[1], _gsim_oracle(g, _labels(n)), 0)
    lev, sig, dl = brandes_oracle(g, pv)
    if name == "sigma":
        return (RA.SigmaCount(payload=len(pv)), TA.SigmaCount(payload=len(pv)),
                {"pivots": pv.astype(np.int32), "levels": lev}, sig, 0.0)
    assert name == "accum"
    return (RA.BrandesAccum(payload=len(pv)),
            TA.BrandesAccum(payload=len(pv)), {"levels": lev, "sigma": sig},
            dl, 0.0)


def _gsim_oracle(g, labels):
    """Naive simulation-pruning fixpoint: drop v from sim(u) while some
    pattern successor u' of u has no out-neighbour of v in sim(u')."""
    ref = labels[:, None] == QLABEL[None, :]
    adj = [[] for _ in range(g.n_vertices)]
    for s, d in zip(g.src.tolist(), g.dst.tolist()):
        adj[s].append(d)
    changed = True
    while changed:
        changed = False
        for u in range(QLABEL.shape[0]):
            for up in np.nonzero(QADJ[u])[0]:
                for v in np.nonzero(ref[:, u])[0]:
                    if not ref[adj[v], up].any():
                        ref[v, u] = False
                        changed = True
    return ref.astype(np.int32)


def _reference_run(prog, rpg, params, cfg):
    eb = reng.resolve_edge_backend(prog, cfg)
    runner = reng.make_sim_runner(prog, cfg, rpg.n_slots, warm_start=False)
    args = (reng._device_subgraph(rpg),)
    if eb != "coo":
        args += (reng._layout_block_from(rpg.ensure_edge_layouts(), rpg,
                                         prog, eb),)
    res, steps, msgs, sweeps = runner(*args, _jnp_params(params))
    return (np.asarray(res), int(steps), int(msgs),
            np.asarray(sweeps, np.int64))


def _port_run(prog, tpg, params, cfg):
    eb = teng.resolve_edge_backend(prog, cfg)
    runner = teng.make_sim_runner(prog, cfg, tpg.n_slots, warm_start=False)
    lay = None
    if eb != "coo":
        lay = teng._layout_block_from(tpg.ensure_edge_layouts(), tpg, prog,
                                      eb, "cpu")
    sgs = teng._device_subgraph(tpg, "cpu")
    res, steps, msgs, sweeps, _ = runner(sgs, lay, params, None)
    return res.numpy(), steps, msgs, sweeps


def _assert_parity(name, got, want):
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    if name in FLOAT_SUMS:
        np.testing.assert_allclose(got[0], want[0], **TOL)
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3], "supersteps / messages"
    np.testing.assert_array_equal(got[3], want[3], err_msg="sweeps per part")


def _assert_oracle(name, tpg, res, oracle, fill):
    got = tpg.collect(res, fill=fill)
    if name in FLOAT_SUMS:
        np.testing.assert_allclose(got, oracle, **TOL)
    else:
        np.testing.assert_array_equal(got, oracle)


PROGRAMS = ("bfs", "msbfs", "triangles", "mssp", "lp", "kcore2", "kcore3",
            "gsim", "sigma", "accum")


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name", PROGRAMS)
def test_program_parity_coo(built, name, graph):
    g, rpg, tpg = built[graph]
    rprog, tprog, params, oracle, fill = _case(name, g)
    want = _reference_run(rprog, rpg, params, R.EngineConfig())
    got = _port_run(tprog, tpg, params, T.EngineConfig())
    _assert_parity(name, got, want)
    _assert_oracle(name, tpg, got[0], oracle, fill)


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_parity_vc_mode(built, name):
    """One-hop local phases. BrandesAccum does not vote to halt in VC mode
    in either engine on this graph, so the bound on supersteps ends it: both
    engines stop at the same superstep with the same messages."""
    g, rpg, tpg = built["powerlaw300"]
    rprog, tprog, params, oracle, fill = _case(name, g)
    want = _reference_run(rprog, rpg, params,
                          R.EngineConfig(mode="vc", max_supersteps=300))
    got = _port_run(tprog, tpg, params,
                    T.EngineConfig(mode="vc", max_supersteps=300))
    _assert_parity(name, got, want)
    if got[1] < 300:
        _assert_oracle(name, tpg, got[0], oracle, fill)
    else:
        assert name == "accum"
        np.testing.assert_allclose(tpg.collect(got[0], fill=fill), oracle,
                                   **TOL)


@pytest.mark.parametrize("graph", ["powerlaw200", "chain", "clique"])
@pytest.mark.parametrize("eb", ["pallas_tiles", "pallas_windows"])
@pytest.mark.parametrize("name", KERNEL_PROGRAMS)
def test_kernel_backend_parity(built, name, eb, graph):
    """BFS, MSBFS and triangles through both kernel backends: the
    reference's Pallas kernel (interpret mode), the port's plain kernel
    version, and the port's COO run agree bit for bit."""
    g, rpg, tpg = built[graph]
    rprog, tprog, params, oracle, fill = _case(name, g)
    want = _reference_run(rprog, rpg, params, R.EngineConfig(edge_backend=eb))
    got = _port_run(tprog, tpg, params, T.EngineConfig(edge_backend=eb))
    _assert_parity(name, got, want)
    coo = _port_run(tprog, tpg, params, T.EngineConfig())
    np.testing.assert_array_equal(got[0], coo[0])
    assert got[1:3] == coo[1:3]
    np.testing.assert_array_equal(got[3], coo[3])
    _assert_oracle(name, tpg, got[0], oracle, fill)


@pytest.mark.parametrize("name", ["mssp", "lp", "kcore2", "gsim", "sigma",
                                  "accum"])
def test_custom_sweeps_resolve_to_coo(name):
    g = GRAPHS["clique"]
    rprog, tprog, _, _, _ = _case(name, g)
    for eb in ("coo", "pallas_tiles", "pallas_windows"):
        assert teng.resolve_edge_backend(tprog, T.EngineConfig(
            edge_backend=eb)) == reng.resolve_edge_backend(
            rprog, R.EngineConfig(edge_backend=eb)) == "coo"


@pytest.mark.parametrize("graph", ["powerlaw200", "star", "two_components"])
def test_brandes_betweenness_stages(built, graph):
    """The staged function over ``run_sim`` of each package: levels exact,
    sigma / delta / bc within 1e-5, and bc equal to textbook Brandes."""
    g, rpg, tpg = built[graph]
    pv = _pivots(g)

    def rquery(prog, params):
        return rpg.collect(R.run_sim(prog, rpg, _jnp_params(params))[0],
                           fill=prog.identity)

    def tquery(prog, params):
        return tpg.collect(T.run_sim(prog, tpg, params, device="cpu")[0],
                           fill=prog.identity)

    want = RA.brandes_betweenness(rquery, pv)
    got = TA.brandes_betweenness(tquery, pv)
    np.testing.assert_array_equal(got["levels"], want["levels"])
    for k in ("sigma", "delta", "bc"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    lev, sig, dl = brandes_oracle(g, pv)
    not_pivot = np.arange(g.n_vertices)[:, None] != pv[None, :]
    np.testing.assert_allclose(got["bc"], (dl * not_pivot).sum(1) / 2.0,
                               **TOL)


def test_triangles_from_result_and_decode_labels():
    g = GRAPHS["clique"]
    rpg = build(g, 2)
    tpg = partitioned_graph_from_arrays(
        {f.name: getattr(rpg, f.name) for f in dataclasses.fields(rpg)})
    prog, params = TA.make_triangles(np.arange(g.n_vertices))
    res, st = T.run_sim(prog, tpg, params, device="cpu")
    per_pivot = TA.triangles_from_result(tpg.collect(res))
    # K6: C(5, 2) = 10 triangles through each vertex, C(6, 3) = 20 in all
    np.testing.assert_array_equal(per_pivot, np.full(g.n_vertices, 10.0))
    assert per_pivot.sum() / 3 == 20 and st.supersteps == 3
    lanes, _ = T.run_sim(TA.make_lp(2)[0], tpg, {}, device="cpu")
    lab = TA.decode_labels(tpg.collect(lanes, fill=2**31 - 1))
    np.testing.assert_array_equal(
        lab, RA.decode_labels(lp_lanes_oracle(g, 2)))


def test_program_constructors_validate():
    for bad in (lambda: TA.make_lp(0), lambda: TA.make_kcore(0)):
        with pytest.raises(ValueError):
            bad()
    assert TA.make_lp(5)[0].payload == 6
    prog, params = TA.make_msbfs([3, 1, 2])
    assert prog.payload == 3 and params["sources"].dtype == np.int32
    g = GRAPHS["star"]
    pg = T.partition_and_build(T.Graph(g.n_vertices, g.src, g.dst), 2)
    prog, params = t_make_gsim(QADJ, QLABEL)
    with pytest.raises(ValueError, match="set_vertex_labels"):
        T.run_sim(prog, pg, params, device="cpu")
