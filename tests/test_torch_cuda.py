"""On-card checks of the CUDA kernels and the port's main path. They need
a CUDA GPU and ``nvcc`` and skip without them; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.algos import SSSP, ConnectedComponents, PageRank
from repro_torch.core import EngineConfig
from repro_torch.graphgen import kronecker_graph
from repro_torch.kernels import bsp_spmv as tb
from repro_torch.kernels import segment_combine as ts
from repro_torch.kernels.ops import WindowLayout
from repro_torch.kernels.ref import combine_identity, tile_pad_identity
from repro_torch.session import GraphSession

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.kernels import _build
    try:
        _build._nvcc()
    except RuntimeError:
        if not all(_build.library_path(n).exists() for n in _build.SOURCES):
            pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.parametrize("semiring,dtype", [("plus_times", np.float32),
                                            ("min_plus", np.float32),
                                            ("min_plus", np.int32)])
@pytest.mark.parametrize("T,n_dst,n_src,K", [(4, 2, 2, 1), (40, 8, 5, 3),
                                             (5, 5, 1, 128)])
def test_bsp_spmv_kernel_matches_plain(cuda, semiring, dtype, T, n_dst,
                                       n_src, K):
    rng = np.random.default_rng(T + K)
    tiles = np.full((T, 128, 128), tile_pad_identity(semiring, dtype), dtype)
    mask = rng.random(tiles.shape) < 0.2
    tiles[mask] = rng.integers(0, 50, size=int(mask.sum()))
    td = np.sort(np.concatenate([np.arange(n_dst), rng.integers(
        0, n_dst, size=T - n_dst)]).astype(np.int32))
    tsrc = rng.integers(0, n_src, size=T).astype(np.int32)
    vals = rng.integers(0, 1000, size=(n_src, 128, K)).astype(dtype)
    args = [torch.from_numpy(a).to(cuda) for a in (tiles, td, tsrc, vals)]
    before = tb.bsp_spmv.launches
    got = tb.bsp_spmv(*args, n_dst_tiles=n_dst, semiring=semiring)
    want = tb.bsp_spmv_plain(*args, n_dst_tiles=n_dst, semiring=semiring)
    torch.cuda.synchronize()
    assert tb.bsp_spmv.launches == before + 1
    if semiring == "min_plus":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combiner,dtype", [("sum", np.float32),
                                            ("min", np.float32),
                                            ("max", np.int32)])
@pytest.mark.parametrize("E,n_rows,K,Be", [(3000, 500, 8, 512),
                                           (50, 400, 1, 128),
                                           (5000, 300, 2, 1024)])
def test_segment_combine_kernel_matches_plain(cuda, combiner, dtype, E,
                                              n_rows, K, Be):
    rng = np.random.default_rng(E + K)
    dst = np.sort(rng.integers(0, n_rows, size=E))
    msgs = rng.integers(-50, 50, size=(E, K)).astype(dtype)
    lay = WindowLayout(dst, n_rows, block_edges=Be)
    buf = np.full((lay.n_blocks * Be, K), combine_identity(combiner, dtype),
                  dtype)
    buf[lay.edge_slot] = msgs[lay.order]
    args = [torch.from_numpy(a).to(cuda)
            for a in (buf, lay.local_dst, lay.block_window)]
    before = ts.segment_combine_windowed.launches
    got = ts.segment_combine_windowed(*args, n_windows=lay.n_windows,
                                      combiner=combiner)
    want = ts.segment_combine_plain(*args, n_windows=lay.n_windows,
                                    combiner=combiner)
    torch.cuda.synchronize()
    assert ts.segment_combine_windowed.launches == before + 1
    if combiner == "sum":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)


def _heavy_windows(rng, kind, combiner, dtype, K):
    """Inputs with one window far longer than the chunk cap: ``heavy``
    (2,100 blocks of window 0), ``padded`` (the JAX layout's 2,000 identity
    padding blocks on the last window), ``tail`` (windows of a few edges,
    whose block ends in identity slots with ldst 0), ``unsorted`` (rows in
    random order inside each block)."""
    Be = 128
    ident = combine_identity(combiner, dtype)
    if kind == "heavy":
        dst = np.sort(np.concatenate([rng.integers(0, 128, 2100 * Be - 7),
                                      rng.integers(128, 600, 900)]))
    elif kind == "tail":
        dst = np.sort(rng.choice([0, 3, 130, 131, 300], size=23))
    else:
        dst = np.sort(rng.integers(0, 700, size=20_000))
    lay = WindowLayout(dst, 700, block_edges=Be)
    msgs = rng.integers(-50, 50, size=(dst.shape[0], K)).astype(dtype)
    buf = np.full((lay.n_blocks * Be, K), ident, dtype)
    buf[lay.edge_slot] = msgs[lay.order]
    ldst, bwin = lay.local_dst, lay.block_window
    if kind == "padded":
        pad = 2000
        buf = np.concatenate([buf, np.full((pad * Be, K), ident, dtype)])
        ldst = np.concatenate([ldst, np.zeros(pad * Be, np.int32)])
        bwin = np.concatenate([bwin, np.full(pad, lay.n_windows - 1,
                                             np.int32)])
    if kind == "unsorted":
        ldst = ldst.reshape(-1, Be).copy()
        for row in ldst:
            rng.shuffle(row)
        ldst = ldst.reshape(-1)
    return buf, ldst, bwin, lay.n_windows


@pytest.mark.parametrize("kind", ["heavy", "padded", "tail", "unsorted"])
@pytest.mark.parametrize("combiner,dtype,K", [("sum", np.float32, 1),
                                              ("min", np.float32, 3),
                                              ("max", np.int32, 1)])
def test_segment_combine_heavy_windows(cuda, kind, combiner, dtype, K):
    rng = np.random.default_rng(11)
    buf, ldst, bwin, nw = _heavy_windows(rng, kind, combiner, dtype, K)
    args = [torch.from_numpy(a).to(cuda) for a in (buf, ldst, bwin)]
    got = ts.segment_combine_windowed(*args, n_windows=nw,
                                      combiner=combiner)
    want = ts.segment_combine_plain(*args, n_windows=nw, combiner=combiner)
    again = ts.segment_combine_windowed(*args, n_windows=nw,
                                        combiner=combiner)
    torch.cuda.synchronize()
    assert torch.equal(got, again)      # the same bits on every launch
    if combiner == "sum":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("semiring,dtype", [("plus_times", np.float32),
                                            ("min_plus", np.float32),
                                            ("min_plus", np.int32)])
@pytest.mark.parametrize("K", [1, 5])
def test_bsp_spmv_heavy_row(cuda, semiring, dtype, K):
    """One dst row of 1,100 tiles (as the JAX layout's padding tiles give
    a partition's last row) beside short rows."""
    rng = np.random.default_rng(K)
    T, n_dst, n_src = 1104, 3, 6
    tiles = np.full((T, 128, 128), tile_pad_identity(semiring, dtype), dtype)
    live = rng.random(tiles.shape) < 0.01
    tiles[live] = rng.integers(0, 50, size=int(live.sum()))
    td = np.array([0, 0, 1] + [2] * (T - 3), np.int32)
    tsrc = rng.integers(0, n_src, size=T).astype(np.int32)
    vals = rng.integers(0, 1000, size=(n_src, 128, K)).astype(dtype)
    args = [torch.from_numpy(a).to(cuda) for a in (tiles, td, tsrc, vals)]
    got = tb.bsp_spmv(*args, n_dst_tiles=n_dst, semiring=semiring)
    want = tb.bsp_spmv_plain(*args, n_dst_tiles=n_dst, semiring=semiring)
    again = tb.bsp_spmv(*args, n_dst_tiles=n_dst, semiring=semiring)
    torch.cuda.synchronize()
    assert torch.equal(got, again)      # the same bits on every launch
    if semiring == "min_plus":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_non_contiguous_input_raises(cuda):
    vals = torch.zeros((1, 128, 2), device=cuda)[..., :1]
    with pytest.raises(ValueError, match="contiguous"):
        tb.bsp_spmv(torch.zeros((1, 128, 128), device=cuda),
                    torch.zeros(1, dtype=torch.int32, device=cuda),
                    torch.zeros(1, dtype=torch.int32, device=cuda), vals,
                    n_dst_tiles=1)


@pytest.mark.parametrize("eb", ["coo", "pallas_tiles", "pallas_windows"])
def test_session_query_on_card_matches_cpu(cuda, eb):
    g = kronecker_graph(11, seed=7, weighted=True)
    on_card = GraphSession.from_graph(g, 8)
    on_cpu = GraphSession.from_graph(g, 8, device="cpu")
    counters = (tb.bsp_spmv.launches, ts.segment_combine_windowed.launches)
    for prog, params in ((SSSP(), {"source": 1}),
                         (ConnectedComponents(), None),
                         (PageRank(), {"n_vertices": g.n_vertices})):
        got, gst = on_card.query(prog, params,
                                 cfg=EngineConfig(edge_backend=eb))
        want, wst = on_cpu.query(prog, params, cfg=EngineConfig())
        if prog.delta_based:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        else:
            np.testing.assert_array_equal(got, want)
            assert gst.supersteps == wst.supersteps
    after = (tb.bsp_spmv.launches, ts.segment_combine_windowed.launches)
    assert (after[0] > counters[0]) == (eb == "pallas_tiles")
    assert (after[1] > counters[1]) == (eb == "pallas_windows")


@pytest.mark.parametrize("step", ["insert", "delete"])
def test_kernels_on_layouts_rebuilt_by_a_flush(cuda, step):
    """After an insert flush and after a delete flush, both kernels on the
    rebuilt compact device lists equal their plain versions, the cached
    lists are new objects (no stale geometry), and queries equal ``coo``."""
    from repro_torch.core.engine import (_layout_block_from, _tile_inputs,
                                         _window_inputs)
    g = kronecker_graph(11, seed=5, weighted=True)
    sess = GraphSession.from_graph(g, 8)
    sssp, pr = SSSP(), PageRank()
    for eb in ("pallas_tiles", "pallas_windows"):
        sess.query(sssp, {"source": 1}, cfg=EngineConfig(edge_backend=eb))
    lay = sess.pg.edge_layouts
    stale = {eb: _layout_block_from(lay, sess.pg, sssp, eb, cuda)
             for eb in ("pallas_tiles", "pallas_windows")}
    rng = np.random.default_rng(3)
    if step == "insert":
        n = g.n_vertices + 64              # new ids too
        sess.update(adds=(rng.integers(0, n, 3000), rng.integers(0, n, 3000),
                          rng.uniform(1, 9, 3000).astype(np.float32)))
    else:
        pick = rng.random(g.n_edges) < 0.2
        sess.update(deletes=(g.src[pick], g.dst[pick]))
    sess.flush()
    sgs = sess.device_graph()
    for prog, params in ((sssp, {"source": 1}),
                         (pr, {"n_vertices": sess.pg.n_vertices})):
        vals, _ = sess.query(prog, params, cfg=EngineConfig(
            edge_backend="pallas_windows"))
        want, _ = sess.query(prog, params, warm=False, cfg=EngineConfig())
        if prog.delta_based:
            assert np.abs(vals - want).max() <= 1e-5 * np.abs(want).max()
        else:
            np.testing.assert_array_equal(vals, want)
        v = torch.from_numpy(vals).to(cuda)[..., None]
        lay = sess.pg.edge_layouts
        for eb in ("pallas_tiles", "pallas_windows"):
            blk = _layout_block_from(lay, sess.pg, prog, eb, cuda)
            if prog is sssp:
                assert blk is not stale[eb]
            if eb == "pallas_tiles":
                tl, td, tsrc, vv, ndt, plan = _tile_inputs(
                    blk, v, prog.sweep_spec, sess.pg.v_max)
                kw = dict(n_dst_tiles=ndt, semiring=prog.sweep_spec.semiring)
                got = tb.bsp_spmv(tl, td, tsrc, vv, plan=plan, **kw)
                ref = tb.bsp_spmv_plain(tl, td, tsrc, vv, **kw)
            else:
                msgs, ldst, bwin, nw, plan = _window_inputs(
                    sgs, blk, v, prog.sweep_spec, sess.pg.v_max)
                kw = dict(n_windows=nw, combiner=prog.sweep_spec.combiner)
                got = ts.segment_combine_windowed(msgs, ldst, bwin,
                                                  plan=plan, **kw)
                ref = ts.segment_combine_plain(msgs, ldst, bwin, **kw)
            torch.cuda.synchronize()
            if prog.delta_based:
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(got, ref)


@pytest.mark.parametrize("eb", ["pallas_tiles", "pallas_windows"])
@pytest.mark.parametrize("algo", ["msbfs", "triangles"])
def test_k16_programs_on_kernels_match_coo(cuda, algo, eb):
    """MSBFS and triangles with K = 16 roots / pivots through each kernel
    backend on the card: results equal ``coo``'s on the card bit for bit
    (triangle sums are integers below 2**24), as do supersteps, messages
    and per-partition sweeps, and the kernel was launched."""
    from repro_torch.algos import make_msbfs, make_triangles
    g = kronecker_graph(11, seed=7)
    sess = GraphSession.from_graph(g, 8)
    roots = np.random.default_rng(5).choice(g.n_vertices, 16, replace=False)
    make = make_msbfs if algo == "msbfs" else make_triangles
    prog, params = make(roots)
    counter = tb.bsp_spmv if eb == "pallas_tiles" \
        else ts.segment_combine_windowed
    before = counter.launches
    got, gst = sess.query(prog, params, warm=False,
                          cfg=EngineConfig(edge_backend=eb))
    assert counter.launches > before
    want, wst = sess.query(prog, params, warm=False, cfg=EngineConfig())
    assert got.shape == (8, sess.pg.v_max, 16)
    np.testing.assert_array_equal(got, want)
    assert (gst.supersteps, gst.total_messages, gst.partition_sweeps) == \
        (wst.supersteps, wst.total_messages, wst.partition_sweeps)


def test_betweenness_halts_on_card(cuda):
    """SigmaCount and BrandesAccum halt only when a recomputed partial sum
    equals the one synced, bit for bit: on the card their float scatter
    sums must be deterministic. ``brandes_betweenness`` on the card halts
    well inside its bound and matches the same stages on the CPU within
    1e-5."""
    from repro_torch.algos import brandes_betweenness
    g = kronecker_graph(11, seed=7)
    pivots = np.random.default_rng(2).choice(g.n_vertices, 8, replace=False)
    out, steps = {}, {}
    for dev in ("cuda", "cpu"):
        sess = GraphSession.from_graph(g, 8, device=dev)
        cfg = EngineConfig(max_supersteps=100, max_local_iters=1000)
        steps[dev] = []

        def query(prog, params, sess=sess, cfg=cfg, dev=dev):
            res, st = sess.query(prog, params, cfg=cfg)
            steps[dev].append(st.supersteps)
            return sess.pg.collect(res, fill=prog.identity)
        out[dev] = brandes_betweenness(query, pivots)
    assert max(steps["cuda"]) < 100 and len(steps["cuda"]) == 3
    np.testing.assert_array_equal(out["cuda"]["levels"], out["cpu"]["levels"])
    for k in ("sigma", "delta", "bc"):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("group", [(0,), (1, 4, 7), (0, 2, 3, 5, 6)])
def test_group_lists_on_kernels_equal_full_list_rows(cuda, group):
    """'auto' group-sliced device lists on the card: each kernel on the
    group's list equals its plain version there, and gives the group's
    partitions the rows the full list gives them."""
    from repro_torch.core.api import DeviceSubgraph
    from repro_torch.core.engine import (_tile_inputs, _tile_product,
                                         _window_inputs, _window_product)
    g = kronecker_graph(11, seed=7, weighted=True)
    sess = GraphSession.from_graph(g, 8)
    pg, spec = sess.pg, SSSP().sweep_spec
    lay = pg.ensure_edge_layouts(shape_policy=sess.shape_policy)
    sgs = sess.device_graph()
    v = torch.rand((pg.n_parts, pg.v_max, 3), generator=torch.Generator(
        ).manual_seed(len(group))).mul_(9).to(cuda)
    gi = torch.tensor(group, device=cuda)
    sub = DeviceSubgraph(*[None if x is None else x[gi] for x in sgs])
    t_grp = lay.device_tiles(pg, spec.semiring, spec.edge_values, np.float32,
                             cuda, parts=group)
    w_grp = lay.device_windows(cuda, parts=group)
    tl, td, tsrc, vv, ndt, plan = _tile_inputs(t_grp, v[gi], spec, pg.v_max)
    kw = dict(n_dst_tiles=ndt, semiring=spec.semiring)
    assert torch.equal(tb.bsp_spmv(tl, td, tsrc, vv, plan=plan, **kw),
                       tb.bsp_spmv_plain(tl, td, tsrc, vv, **kw))
    msgs, ldst, bwin, nw, plan = _window_inputs(sub, w_grp, v[gi], spec,
                                                pg.v_max)
    kw = dict(n_windows=nw, combiner=spec.combiner)
    assert torch.equal(
        ts.segment_combine_windowed(msgs, ldst, bwin, plan=plan, **kw),
        ts.segment_combine_plain(msgs, ldst, bwin, **kw))
    full_t = _tile_product(lay.device_tiles(pg, spec.semiring,
                                            spec.edge_values, np.float32,
                                            cuda), v, spec, pg.v_max)
    full_w = _window_product(sgs, lay.device_windows(cuda), v, spec, pg.v_max)
    assert torch.equal(_tile_product(t_grp, v[gi], spec, pg.v_max),
                       full_t[gi])
    assert torch.equal(_window_product(sub, w_grp, v[gi], spec, pg.v_max),
                       full_w[gi])


def test_measured_calibration_and_auto_on_card(cuda, tmp_path, monkeypatch):
    """The calibration sweep timed on the card: a measured table named for
    the card, the same JSON after a reload, finite non-negative unit
    costs; a forced three-way mix launches both kernels and equals
    ``coo``, and a calibrated 'auto' query equals ``coo`` too."""
    from repro_torch.core import autotune
    from repro_torch.core.engine import _auto_layout_blocks, make_sim_runner
    monkeypatch.setenv("DRONE_AUTOTUNE_DIR", str(tmp_path))
    table = autotune.get_table(force=True)
    assert table.source == "measured"
    assert table.platform.startswith("torch-cuda-sm")
    assert autotune.load_table(table.platform).to_json() == table.to_json()
    assert all(np.isfinite(c) and c >= 0 for c in table.unit_costs.values())
    g = kronecker_graph(11, seed=7, weighted=True)
    sess = GraphSession.from_graph(g, 8)
    pg = sess.pg
    want, wst = sess.query(SSSP(), {"source": 1}, warm=False)
    asg = tuple(("coo", "pallas_tiles", "pallas_windows")[p % 3]
                for p in range(pg.n_parts))
    cfg = EngineConfig(edge_backend="auto")
    lay = pg.ensure_edge_layouts(shape_policy=sess.shape_policy)
    before = (tb.bsp_spmv.launches, ts.segment_combine_windowed.launches)
    runner = make_sim_runner(SSSP(), cfg, sess.slot_capacity,
                             partition_backends=asg)
    res, steps, msgs, sweeps, _ = runner(
        sess.device_graph(), _auto_layout_blocks(lay, pg, SSSP(), asg, cuda),
        {"source": 1})
    assert tb.bsp_spmv.launches > before[0]
    assert ts.segment_combine_windowed.launches > before[1]
    np.testing.assert_array_equal(res.cpu().numpy(), want)
    assert (steps, msgs, list(sweeps)) == (wst.supersteps,
                                           wst.total_messages,
                                           wst.partition_sweeps)
    got, gst = sess.query(SSSP(), {"source": 1}, warm=False, cfg=cfg)
    np.testing.assert_array_equal(got, want)
    assert len(gst.partition_edge_backends) == pg.n_parts


@pytest.mark.parametrize("eb", ["pallas_tiles", "pallas_windows"])
def test_query_batch_on_kernels_equals_singletons(cuda, eb):
    """Each lane of a batch on a kernel backend equals its singleton query
    bit for bit (PageRank within 1e-5), and the batch launches the kernel
    exactly as often as its singletons together; a result-cache all-hit
    batch launches nothing."""
    from repro_torch.serving import ResultCache
    g = kronecker_graph(11, seed=7, weighted=True)
    sess = GraphSession.from_graph(g, 8, cfg=EngineConfig(edge_backend=eb))
    counter = tb.bsp_spmv if eb == "pallas_tiles" \
        else ts.segment_combine_windowed
    plist = [{"source": s} for s in (1, 5, 40)]
    before = counter.launches
    singles = [sess.query(SSSP(), p, warm=False) for p in plist]
    alone = counter.launches - before
    before = counter.launches
    out = sess.query_batch(SSSP(), plist, warm=False)
    assert counter.launches - before == alone > 0
    for (a, ast), (b, bst) in zip(singles, out):
        np.testing.assert_array_equal(b, a)
        assert (bst.supersteps, bst.total_messages, bst.partition_sweeps) \
            == (ast.supersteps, ast.total_messages, ast.partition_sweeps)
        assert bst.batch_size == 3
    pr = {"n_vertices": g.n_vertices}
    want, _ = sess.query(PageRank(), pr)
    for got, _ in sess.query_batch(PageRank(), [pr, pr]):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    sess.result_cache = ResultCache()
    sess.query_batch(SSSP(), plist, warm=False)
    before = counter.launches
    hits = sess.query_batch(SSSP(), plist, warm=False)
    assert counter.launches == before
    assert all(st.result_cache_tier == "l1" for _, st in hits)


@pytest.mark.parametrize("semiring", ["min_plus", "plus_times"])
def test_kernels_on_shard_lists_with_an_empty_shard(cuda, semiring):
    """``shard_map`` edge-shard device lists on the card, on a skewed
    placement whose small partitions have shards with no edge (coverage
    fillers only): each kernel equals its plain version on every
    (partition, shard) list, and the shards' products reduced (min, or
    summed) equal the partition's unsharded product."""
    from repro_torch.core import build_partitioned_graph
    from repro_torch.core.engine import (_device_subgraph, _tile_inputs,
                                         _tile_product, _window_inputs,
                                         _window_product)
    from repro_torch.core.api import SemiringSweep
    from repro_torch.graphgen import powerlaw_graph
    g = powerlaw_graph(3000, seed=4, weighted=True).as_undirected()
    idx = np.arange(g.n_edges)
    part = np.where(idx % 10 < 7, 0, idx % 3 + 1).astype(np.int32)
    pg = build_partitioned_graph(g, part, 4)
    lay = pg.ensure_edge_layouts()
    S, spec = 4, SemiringSweep(semiring, "weight")
    Se = pg.e_max // S
    assert any(not pg.emask[p, s * Se:(s + 1) * Se].any()
               for p in range(4) for s in range(S))
    gen = torch.Generator().manual_seed(5)
    for p in range(4):
        v = torch.rand((1, pg.v_max, 3), generator=gen).mul_(9).to(cuda)
        sg = _device_subgraph(pg, cuda, block=(p, 0, 1))
        want_t = _tile_product(lay.device_tiles(
            pg, semiring, "weight", np.float32, cuda, parts=[p]), v, spec,
            pg.v_max)
        want_w = _window_product(sg, lay.device_windows(cuda, parts=[p]), v,
                                 spec, pg.v_max)
        tiles = []
        wins = []
        for s in range(S):
            sgs = _device_subgraph(pg, cuda, block=(p, s, S))
            tbk = lay.device_tiles_sharded(pg, semiring, "weight",
                                           np.float32, S, cuda, p, s)
            wbk = lay.device_windows_sharded(pg, S, cuda, p, s)
            tl, td, tsrc, vv, ndt, plan = _tile_inputs(tbk, v, spec,
                                                       pg.v_max)
            kw = dict(n_dst_tiles=ndt, semiring=semiring)
            got = tb.bsp_spmv(tl, td, tsrc, vv, plan=plan, **kw)
            plain = tb.bsp_spmv_plain(tl, td, tsrc, vv, **kw)
            msgs, ldst, bwin, nw, wplan = _window_inputs(sgs, wbk, v, spec,
                                                         pg.v_max)
            kw = dict(n_windows=nw, combiner=spec.combiner)
            gw = ts.segment_combine_windowed(msgs, ldst, bwin, plan=wplan,
                                             **kw)
            pw = ts.segment_combine_plain(msgs, ldst, bwin, **kw)
            if semiring == "min_plus":
                assert torch.equal(got, plain) and torch.equal(gw, pw)
            else:
                torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
                torch.testing.assert_close(gw, pw, rtol=1e-5, atol=1e-5)
            tiles.append(_tile_product(tbk, v, spec, pg.v_max))
            wins.append(_window_product(sgs, wbk, v, spec, pg.v_max))
        if semiring == "min_plus":
            assert torch.equal(torch.stack(tiles).amin(0), want_t)
            assert torch.equal(torch.stack(wins).amin(0), want_w)
        else:
            torch.testing.assert_close(torch.stack(tiles).sum(0), want_t,
                                       rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(torch.stack(wins).sum(0), want_w,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["olmo_1b", "phi4_mini_3p8b",
                                  "stablelm_3b", "phi35_moe_42b",
                                  "deepseek_v3_671b"])
def test_lm_serving_on_card_matches_cpu(cuda, arch):
    """The LM serving path at a smoke config, float32 with TF32 off: the
    card's forward logits against the same weights on the CPU within 1e-4
    (and the MoE layers' dropped share equal), and equal greedy tokens of
    a prefill and a decode loop."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.training import steps as S

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    card = M.init_model(cfg, seed=3, device=cuda)
    cpu = M.Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        lc, ac = M.forward(card, {"tokens": toks.to(cuda)}, cfg)
        lh, ah = M.forward(cpu, {"tokens": toks}, cfg)
    torch.testing.assert_close(lc.cpu(), lh, rtol=0, atol=1e-4)
    assert float(ac["moe_dropped"]) == float(ah["moe_dropped"])
    out = []
    for model, dev in ((card, cuda), (cpu, "cpu")):
        nxt, caches = S.make_prefill_step(cfg, 20)(
            model, {"tokens": toks[:, :8].to(dev)})
        got = [nxt.cpu()]
        for _ in range(7):
            nxt, caches = S.make_serve_step(cfg)(model, caches,
                                                 {"tokens": nxt[:, None]})
            got.append(nxt.cpu())
        out.append(torch.stack(got, dim=1))
    assert torch.equal(out[0], out[1])
