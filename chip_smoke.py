#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (the run exits non-zero if any of them fails):

  1. GPU identity and the kernels' build: ``nvcc`` compiles every source of
     ``src/repro_torch/csrc`` in parallel; ptxas' register and spill report
     is printed.
  2. Each kernel against its plain PyTorch version on the card, on the case
     grid of the kernel tests and on heavy rows (a window of 2,100 blocks,
     2,000 identity padding blocks on one window, windows whose block ends
     in identity slots with ldst 0, unsorted rows, a dst row of 1,100
     tiles): bit-exact for min/max; for sums, each output within 1e-5 of
     the same sum taken over the inputs' absolute values (the scale of a
     reordered float sum's rounding), and two launches give the same bits.
  3. The windows path at full size: ``GraphSession.from_graph(
     kronecker_graph(20, seed=7), 16, "cdbh")``; SSSP from two sources and
     a warm repeat, CC and PageRank on ``pallas_windows``, each held against
     the same query on ``coo``.
  4. The tiles path: ``grid_graph(1024, weighted=True, seed=9)`` with the
     ``range`` vertex-cut (P=16), SSSP, CC and PageRank on ``pallas_tiles``
     against ``coo``; then the quickstart graph (``kronecker_graph(14)``,
     ``cdbh``, P=16) on ``pallas_tiles``. SSSP and CC must also take the
     supersteps and host syncs of ``coo``; the peak device memory of each
     path is printed.
  5. Kernel confirmation: both kernels' launch counters, reset just before
     phase 3 and read just after phase 4, must be positive. Each kernel is
     then checked and timed against its plain version at the
     shapes phases 3 and 4 gave it (the compact device lists), beside its
     bound on the card and, where one PyTorch call computes the same
     function, that call's time; and timed again on the padded JAX-layout
     input, where every padding block / tile sits on a partition's last
     window / dst row. ``bsp_spmv`` plus_times is also timed at the grid
     PageRank shape beside ``torch.sparse.mm`` of a BSR matrix.
  6. Streaming, on phase 3's kron-20 session (``pallas_windows``, its
     buffer bound above a batch) and phase 4's kron-14 session
     (``pallas_tiles``), with both launch counters reset before it: two
     symmetric insert batches of 0.5% of the edges (weights in [5, 10);
     the second brings 1,024 new vertex ids), each flushed and followed by
     SSSP warm-auto and cold (bit-identical, warm in fewer supersteps),
     the same query on ``coo`` and scipy's Dijkstra on the mutated edge
     list; a delete batch of 5% of the resident edges (warm results
     dropped), CC and PageRank against ``coo``; ``compact()`` and SSSP
     again. On kron-14: one batch through many small ``update`` calls
     (auto-flushes), one batch that moves the ``e_max`` bucket (the
     fullest partition's resident pairs again, so the tiles keep their
     shape), and a compaction, each followed by SSSP, CC and PageRank on tiles against
     ``coo``; then a trace run with ``checkpoint_every=2`` resumed from its
     second checkpoint. Both counters must be positive after it, and each
     kernel is checked against its plain version on the post-compact
     device lists. Per step it prints the host time of the flush (the
     layout refresh apart), the re-upload of the device graph and of the
     kernels' device list, and the query wall times.

A small-graph check holds the three programs against independent numpy
oracles on all three backends. The line before the last is the card's name
and power limit from ``nvidia-smi``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM float32 rate outside tensor cores
PR_RTOL = 1e-5                # PageRank: max |a - b| <= PR_RTOL * max |b|
DEVICE = "cuda"
GRID_SIDE = 1024              # the tiles path's grid graph (1,048,576 vertices)
SUM_RTOL = 1e-5               # float sums: |got - want| <= SUM_RTOL * sum |terms|
STREAM_BUFFER_EDGES = 1 << 22  # kron-20 session's buffer bound: above a batch


class Smoke:
    def __init__(self):
        self.failures = []
        self.t0 = time.perf_counter()

    def check(self, ok: bool, what: str) -> bool:
        status = "ok" if ok else "FAIL"
        print(f"[{time.perf_counter() - self.t0:7.1f}s] {status}: {what}",
              flush=True)
        if not ok:
            self.failures.append(what)
        return ok

    def note(self, what: str) -> None:
        print(f"[{time.perf_counter() - self.t0:7.1f}s] {what}", flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def time_ms(fn, target_s: float = 0.25, max_iters: int = 50) -> float:
    """Mean milliseconds of ``fn`` on the card, timed with CUDA events after
    a warm-up, over enough launches to fill about ``target_s``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t, 1e-6)
    iters = int(min(max_iters, max(3, target_s / one)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, magnitude=None):
    """(ok, max_abs_err) of two tensors on the card. With no ``magnitude``
    the two must be equal; otherwise each element may differ by
    ``SUM_RTOL`` times its ``magnitude``, the same sum taken over the
    absolute values of its terms, so that a zeroed or partial row fails
    however small its values are."""
    import torch
    got, want = got.float(), want.float()
    both_inf = torch.isinf(got) & torch.isinf(want) & (got == want)
    diff = torch.where(both_inf, torch.zeros_like(got), (got - want).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    if magnitude is None:
        return bool(torch.equal(got, want)), err
    return bool((diff <= SUM_RTOL * magnitude.float()).all()), err


def spmv_magnitude(tiles, td, ts, vals, ndt, semiring):
    """Per-output scale of a plus_times product (None for min_plus)."""
    from repro_torch.kernels.bsp_spmv import bsp_spmv_plain
    if semiring != "plus_times":
        return None
    return bsp_spmv_plain(tiles.abs(), td, ts, vals.abs(), n_dst_tiles=ndt,
                          semiring=semiring)


def segment_magnitude(msgs, ldst, bwin, nw, combiner):
    """Per-output scale of a windowed sum (None for min/max)."""
    from repro_torch.kernels.segment_combine import segment_combine_plain
    if combiner != "sum":
        return None
    return segment_combine_plain(msgs.abs(), ldst, bwin, n_windows=nw,
                                 combiner=combiner)


# --------------------------------------------------------------------------- #
# phase 2: kernel against plain version on the test case grid
# --------------------------------------------------------------------------- #
def kernel_case_grid(sm: Smoke, errs: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels.ops import WindowLayout
    from repro_torch.kernels.ref import combine_identity, tile_pad_identity

    dev = torch.device(DEVICE)

    def rand_tiles(rng, T, ndt, nst, semiring, dtype):
        ident = tile_pad_identity(semiring, dtype)
        tiles = np.full((T, 128, 128), ident, dtype)
        mask = rng.random((T, 128, 128)) < 0.3
        if np.dtype(dtype) == np.int32:
            tiles[mask] = rng.integers(0, 50, size=int(mask.sum()))
        else:
            tiles[mask] = rng.uniform(0.1, 5.0, size=int(mask.sum()))
        td = np.sort(rng.integers(0, ndt, size=T).astype(np.int32))
        td[:ndt] = np.arange(ndt)
        td = np.sort(td)
        ts = rng.integers(0, nst, size=T).astype(np.int32)
        return tiles, td, ts

    cases = [(4, 2, 2, 1), (9, 3, 2, 4), (16, 4, 4, 8), (5, 5, 1, 128)]
    for semiring, dtype in (("plus_times", np.float32),
                            ("min_plus", np.float32),
                            ("min_plus", np.int32)):
        for T, ndt, nst, K in cases:
            rng = np.random.default_rng(T * 100 + K)
            tiles, td, ts = rand_tiles(rng, T, ndt, nst, semiring, dtype)
            if np.dtype(dtype) == np.int32:
                vals = rng.integers(0, 1000, size=(nst, 128, K)).astype(dtype)
            else:
                vals = rng.uniform(0, 3, size=(nst, 128, K)).astype(dtype)
            args = [torch.from_numpy(a).to(dev) for a in (tiles, td, ts, vals)]
            check_spmv(sm, errs, args, ndt, semiring,
                       f"T={T} K={K}")

    seg_cases = [(100, 64, 1, 128), (1000, 300, 4, 256), (3000, 500, 8, 512),
                 (50, 400, 1, 128)]
    for combiner, dtype in (("sum", np.float32), ("min", np.float32),
                            ("max", np.float32), ("min", np.int32),
                            ("max", np.int32)):
        for E, n_rows, K, Be in seg_cases:
            rng = np.random.default_rng(E + K)
            dst = np.sort(rng.integers(0, n_rows, size=E).astype(np.int64))
            if np.dtype(dtype) == np.int32:
                msgs = rng.integers(-50, 50, size=(E, K)).astype(dtype)
            else:
                msgs = rng.uniform(-2, 2, size=(E, K)).astype(dtype)
            lay = WindowLayout(dst, n_rows, block_edges=Be)
            buf = np.full((lay.n_blocks * Be, K),
                          combine_identity(combiner, dtype), dtype)
            buf[lay.edge_slot] = msgs[lay.order]
            args = [torch.from_numpy(a).to(dev)
                    for a in (buf, lay.local_dst, lay.block_window)]
            check_segment(sm, errs, args, lay.n_windows, combiner,
                          f"E={E} K={K} Be={Be}")
    heavy_case_grid(sm, errs)


def check_spmv(sm: Smoke, errs: dict, args, ndt: int, semiring: str,
               what: str) -> None:
    """bsp_spmv against its plain version on the card; a plus_times sum
    must also give the same bits on a second launch."""
    import torch
    from repro_torch.kernels import bsp_spmv as bk
    got = bk.bsp_spmv(*args, n_dst_tiles=ndt, semiring=semiring)
    want = bk.bsp_spmv_plain(*args, n_dst_tiles=ndt, semiring=semiring)
    again = bk.bsp_spmv(*args, n_dst_tiles=ndt, semiring=semiring)
    torch.cuda.synchronize()
    ok, err = compare(got, want, spmv_magnitude(*args, ndt, semiring))
    errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
    dt = str(args[0].dtype).replace("torch.", "")
    sm.check(ok, f"bsp_spmv {semiring} {dt} {what} vs plain (max err "
                 f"{err:.3g})")
    if semiring == "plus_times":
        sm.check(torch.equal(got, again), f"bsp_spmv {semiring} {dt} "
                                          f"{what}: two launches, same bits")


def check_segment(sm: Smoke, errs: dict, args, nw: int, combiner: str,
                  what: str) -> None:
    """segment_combine against its plain version on the card; a sum must
    also give the same bits on a second launch."""
    import torch
    from repro_torch.kernels import segment_combine as sk
    got = sk.segment_combine_windowed(*args, n_windows=nw, combiner=combiner)
    want = sk.segment_combine_plain(*args, n_windows=nw, combiner=combiner)
    again = sk.segment_combine_windowed(*args, n_windows=nw,
                                        combiner=combiner)
    torch.cuda.synchronize()
    ok, err = compare(got, want, segment_magnitude(*args, nw, combiner))
    errs["segment_combine"] = max(errs["segment_combine"], err)
    dt = str(args[0].dtype).replace("torch.", "")
    sm.check(ok, f"segment_combine {combiner} {dt} {what} vs plain (max err "
                 f"{err:.3g})")
    if combiner == "sum":
        sm.check(torch.equal(got, again), f"segment_combine {combiner} {dt} "
                                          f"{what}: two launches, same bits")


def heavy_case_grid(sm: Smoke, errs: dict) -> None:
    """Rows far longer than a chunk: a window of 2,100 blocks, the JAX
    layout's 2,000 identity padding blocks on the last window, windows of a
    few edges whose block ends in identity slots with ldst 0, rows in random
    order inside each block; a dst row of 1,100 tiles."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import WindowLayout
    from repro_torch.kernels.ref import combine_identity, tile_pad_identity

    dev = torch.device(DEVICE)
    Be = 128
    for combiner, dtype in (("sum", np.float32), ("min", np.float32),
                            ("max", np.float32), ("min", np.int32),
                            ("max", np.int32)):
        ident = combine_identity(combiner, dtype)
        for kind in ("heavy", "padded", "tail", "unsorted"):
            rng = np.random.default_rng(11)
            if kind == "heavy":
                dst = np.sort(np.concatenate([
                    rng.integers(0, 128, 2100 * Be - 7),
                    rng.integers(128, 600, 900)]))
            elif kind == "tail":
                dst = np.sort(rng.choice([0, 3, 130, 131, 300], size=23))
            else:
                dst = np.sort(rng.integers(0, 700, size=20_000))
            lay = WindowLayout(dst, 700, block_edges=Be)
            K = 3 if kind == "unsorted" else 1
            if np.dtype(dtype) == np.int32:
                msgs = rng.integers(-50, 50, size=(dst.shape[0], K))
            else:
                msgs = rng.uniform(-2, 2, size=(dst.shape[0], K))
            buf = np.full((lay.n_blocks * Be, K), ident, dtype)
            buf[lay.edge_slot] = msgs[lay.order].astype(dtype)
            ldst, bwin = lay.local_dst, lay.block_window
            if kind == "padded":
                buf = np.concatenate([buf, np.full((2000 * Be, K), ident,
                                                   dtype)])
                ldst = np.concatenate([ldst, np.zeros(2000 * Be, np.int32)])
                bwin = np.concatenate([bwin, np.full(
                    2000, lay.n_windows - 1, np.int32)])
            if kind == "unsorted":
                ldst = ldst.reshape(-1, Be).copy()
                for row in ldst:
                    rng.shuffle(row)
                ldst = ldst.reshape(-1)
            args = [torch.from_numpy(a).to(dev) for a in (buf, ldst, bwin)]
            check_segment(sm, errs, args, lay.n_windows, combiner,
                          f"{kind} ({bwin.shape[0]} blocks, longest window "
                          f"{int(np.bincount(bwin).max())}) K={K}")

    for semiring, dtype in (("plus_times", np.float32),
                            ("min_plus", np.float32),
                            ("min_plus", np.int32)):
        for K in (1, 5):
            rng = np.random.default_rng(K)
            T, ndt, nst = 1104, 3, 6
            tiles = np.full((T, 128, 128), tile_pad_identity(semiring, dtype),
                            dtype)
            live = rng.random(tiles.shape) < 0.01
            tiles[live] = rng.integers(0, 50, size=int(live.sum()))
            td = np.array([0, 0, 1] + [2] * (T - 3), np.int32)
            ts = rng.integers(0, nst, size=T).astype(np.int32)
            if np.dtype(dtype) == np.int32:
                vals = rng.integers(0, 1000, size=(nst, 128, K))
            else:
                vals = rng.uniform(0, 3, size=(nst, 128, K))
            args = [torch.from_numpy(a).to(dev)
                    for a in (tiles, td, ts, vals.astype(dtype))]
            check_spmv(sm, errs, args, ndt, semiring,
                       f"heavy row ({T - 3} tiles) K={K}")


# --------------------------------------------------------------------------- #
# small-graph oracles (independent numpy/scipy implementations)
# --------------------------------------------------------------------------- #
def oracle_sssp(g, source):
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    m = csr_matrix((g.weights.astype(np.float64), (g.src, g.dst)),
                   shape=(g.n_vertices, g.n_vertices))
    return dijkstra(m, directed=True, indices=source)


def oracle_cc(g):
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    m = csr_matrix((np.ones(g.n_edges), (g.src, g.dst)),
                   shape=(g.n_vertices, g.n_vertices))
    _, comp = connected_components(m, directed=False)
    low = np.full(comp.max() + 1, g.n_vertices, np.int64)
    np.minimum.at(low, comp, np.arange(g.n_vertices))
    return low[comp]


def oracle_pagerank(g, alpha=0.85, iters=200):
    import numpy as np
    n = g.n_vertices
    out_deg = np.bincount(g.src, minlength=n).astype(np.float64)
    x = np.full(n, (1 - alpha) / n)
    r = x.copy()
    for _ in range(iters):
        push = alpha * x / np.maximum(out_deg, 1)
        y = np.zeros(n)
        np.add.at(y, g.dst, push[g.src])
        x = r + y
    return x


def small_graph_check(sm: Smoke) -> None:
    import numpy as np
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core import EngineConfig
    from repro_torch.graphgen import kronecker_graph
    from repro_torch.session import GraphSession

    g = kronecker_graph(10, seed=3, weighted=True)
    sess = GraphSession.from_graph(g, 8, "cdbh", device=DEVICE)
    src = int(np.argmax(g.out_degrees()))
    want_d = oracle_sssp(g, src)
    want_c = oracle_cc(g)
    want_p = oracle_pagerank(g)
    for eb in ("coo", "pallas_tiles", "pallas_windows"):
        cfg = EngineConfig(edge_backend=eb)
        d, _ = sess.query(SSSP(), {"source": src}, warm=False, cfg=cfg)
        d = sess.pg.collect(d, fill=np.float32(np.inf)).astype(np.float64)
        fin = np.isfinite(want_d)
        sm.check(bool(np.array_equal(np.isfinite(d), fin)
                      and np.allclose(d[fin], want_d[fin], rtol=1e-5)),
                 f"small graph SSSP on {eb} agrees with Dijkstra")
        c, _ = sess.query(ConnectedComponents(), warm=False, cfg=cfg)
        c = sess.pg.collect(c, fill=-1)
        sm.check(bool(np.array_equal(c, want_c)),
                 f"small graph CC on {eb} agrees with scipy components")
        # a tight significance threshold, so that the mass the program
        # leaves unpushed below it stays far under the check's tolerance
        p, _ = sess.query(PageRank(tol=1e-10), {"n_vertices": g.n_vertices},
                          cfg=cfg)
        p = sess.pg.collect(p).astype(np.float64)
        err = float(np.abs(p - want_p).sum() / want_p.sum())
        sm.check(bool(np.isfinite(p).all() and err < 1e-4),
                 f"small graph PageRank on {eb} agrees with power iteration "
                 f"(L1 error {err:.3g} of the total rank)")


# --------------------------------------------------------------------------- #
# phases 3 and 4: the main path
# --------------------------------------------------------------------------- #
def run_queries(sm: Smoke, sess, label: str, kernel_eb: str, queries,
                log: list) -> dict:
    """Run every query on ``kernel_eb`` and on ``coo``; hold each kernel
    result against its COO twin. Returns the kernel-backend results."""
    import numpy as np
    from repro_torch.core import EngineConfig
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    def launches():
        return bk.bsp_spmv.launches + sk.segment_combine_windowed.launches

    results, counts = {}, {}
    for eb in (kernel_eb, "coo"):
        cfg = EngineConfig(edge_backend=eb)
        for name, prog, params, warm in queries:
            before = launches()
            res, st = sess.query(prog, params, warm=warm, cfg=cfg)
            results[(eb, name)] = res
            counts[(eb, name)] = (st.supersteps, st.host_syncs)
            rec = dict(graph=label, query=name, edge_backend=eb,
                       wall_s=round(st.wall_time, 4),
                       build_s=round(st.compile_time, 6),
                       supersteps=st.supersteps,
                       messages=st.total_messages, host_syncs=st.host_syncs,
                       processed_edges=st.processed_edges,
                       kernel_launches=launches() - before)
            log.append(rec)
            print("query " + json.dumps(rec), flush=True)
    for name, prog, _, _ in queries:
        got, want = results[(kernel_eb, name)], results[("coo", name)]
        finite = np.isfinite(got.astype(np.float64)).any()
        if prog.delta_based:
            err = float(np.abs(got - want).max())
            scale = float(np.abs(want).max())
            ok = err <= PR_RTOL * scale and np.isfinite(got).all()
            sm.check(ok, f"{label} {name}: {kernel_eb} == coo within "
                         f"{PR_RTOL:g} of max |rank| (max err {err:.3g}, "
                         f"max rank {scale:.3g})")
        else:
            sm.check(bool(np.array_equal(got, want) and finite),
                     f"{label} {name}: {kernel_eb} bit-identical to coo "
                     f"{got.shape} {got.dtype}")
            sm.check(counts[(kernel_eb, name)] == counts[("coo", name)],
                     f"{label} {name}: {kernel_eb} supersteps and host "
                     f"syncs {counts[(kernel_eb, name)]} equal coo's")
    return results


def windows_path(sm: Smoke, log: list):
    import numpy as np
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.graphgen import kronecker_graph
    from repro_torch.session import GraphSession

    t = time.perf_counter()
    g = kronecker_graph(20, seed=7)
    sm.note(f"kron-20: {g.n_vertices} vertices, {g.n_edges} edges, "
            f"generated in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    sess = GraphSession.from_graph(g, 16, "cdbh", device=DEVICE,
                                   max_buffer_edges=STREAM_BUFFER_EDGES)
    lay = sess.pg.ensure_edge_layouts(shape_policy=sess.shape_policy)
    sm.note(f"kron-20 cdbh P=16: v_max={sess.pg.v_max} e_max={sess.pg.e_max}"
            f" b_max={lay.b_max}; built in {time.perf_counter() - t:.1f}s")
    deg = g.out_degrees()
    rng = np.random.default_rng(7)
    s0 = int(np.argmax(deg))
    s1 = int(rng.choice(np.nonzero(deg)[0]))
    queries = [("sssp_a", SSSP(), {"source": s0}, False),
               ("sssp_b", SSSP(), {"source": s1}, False),
               ("sssp_a_warm", SSSP(), {"source": s0}, True),
               ("cc", ConnectedComponents(), None, False),
               ("pagerank", PageRank(), {"n_vertices": g.n_vertices}, False)]
    res = run_queries(sm, sess, "kron-20", "pallas_windows", queries, log)
    return sess, res, g, s0


def tiles_path(sm: Smoke, log: list):
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.graphgen import grid_graph, kronecker_graph
    from repro_torch.session import GraphSession

    t = time.perf_counter()
    g = grid_graph(GRID_SIDE, weighted=True, seed=9)
    sess = GraphSession.from_graph(g, 16, "range", device=DEVICE)
    lay = sess.pg.ensure_edge_layouts(shape_policy=sess.shape_policy)
    sm.note(f"grid-{GRID_SIDE} range P=16: {g.n_vertices} vertices, {g.n_edges} "
            f"edges, v_max={sess.pg.v_max} t_max={lay.t_max} real tiles="
            f"{int(lay.n_tiles.sum())}; built in "
            f"{time.perf_counter() - t:.1f}s")
    queries = [("sssp", SSSP(), {"source": 0}, False),
               ("cc", ConnectedComponents(), None, False),
               ("pagerank", PageRank(), {"n_vertices": g.n_vertices}, False)]
    res = run_queries(sm, sess, f"grid-{GRID_SIDE}", "pallas_tiles", queries, log)

    gq = kronecker_graph(14, seed=7)
    sq = GraphSession.from_graph(gq, 16, "cdbh", device=DEVICE)
    qq = [("sssp", SSSP(), {"source": 0}, False),
          ("cc", ConnectedComponents(), None, False),
          ("pagerank", PageRank(), {"n_vertices": gq.n_vertices}, False)]
    run_queries(sm, sq, "kron-14", "pallas_tiles", qq, log)
    return sess, res, sq


# --------------------------------------------------------------------------- #
# phase 5: kernels at the main path's shapes
# --------------------------------------------------------------------------- #
def padded_window_inputs(sess, sgs, prog, vals):
    """The same messages in the JAX package's padded stacked layout: every
    partition padded to b_max blocks, its padding blocks on its last
    window (the input the engine fed the kernel before the layouts became
    compact). Returns ``(msgs, ldst, bwin, n_windows)``."""
    import numpy as np
    import torch
    from repro_torch.core.engine import _edge_messages
    from repro_torch.kernels.ref import combine_identity, numpy_dtype
    lay, spec, dev = sess.pg.edge_layouts, prog.sweep_spec, vals.device
    P, K = lay.n_parts, vals.shape[-1]
    n_buf = lay.ldst.shape[-1]
    offs = np.arange(P)[:, None]
    slot = np.where(lay.eslot >= 0, lay.eslot + offs * n_buf, P * n_buf)
    msgs = _edge_messages(sgs, spec, vals, sgs.esrc, sgs.ew)
    ident = combine_identity(spec.combiner, numpy_dtype(vals.dtype)).item()
    buf = torch.full((P * n_buf + 1, K), ident, dtype=vals.dtype, device=dev)
    buf.index_copy_(0, torch.from_numpy(slot.reshape(-1).astype(np.int64))
                    .to(dev), msgs.reshape(-1, K))
    bwin = (lay.bwin + offs * lay.n_windows).reshape(-1).astype(np.int32)
    return (buf[:-1], torch.from_numpy(lay.ldst.reshape(-1)).to(dev),
            torch.from_numpy(bwin).to(dev), P * lay.n_windows)


def padded_tile_inputs(sess, prog, dev):
    """The tile list in the JAX package's padded stacked layout: every
    partition padded to t_max identity tiles on its last dst row. Returns
    ``(tiles, tile_dst, tile_src)``."""
    import numpy as np
    import torch
    lay, spec = sess.pg.edge_layouts, prog.sweep_spec
    offs = np.arange(lay.n_parts)[:, None]
    tiles = lay.tile_values(sess.pg, spec.semiring, spec.edge_values,
                            prog.dtype)
    td = (lay.tile_dst + offs * lay.n_dst_tiles).reshape(-1)
    ts = (lay.tile_src + offs * lay.n_src_tiles).reshape(-1)
    return (torch.from_numpy(tiles.reshape(-1, 128, 128)).to(dev),
            torch.from_numpy(td.astype(np.int32)).to(dev),
            torch.from_numpy(ts.astype(np.int32)).to(dev))


def bsr_yardstick(tiles, td, ts, v, ndt):
    """One PyTorch call for the plus_times product: ``torch.sparse.mm`` of
    a block-sparse (BSR, 128x128 fp32 blocks) matrix and the values.
    Returns ``(fn, None)`` or ``(None, the error)`` if the card refuses."""
    import torch
    try:
        crow = torch.searchsorted(
            td, torch.arange(ndt + 1, dtype=torch.int32, device=td.device),
            out_int32=True)
        A = torch.sparse_bsr_tensor(crow, ts, tiles,
                                    size=(ndt * 128, v.shape[0] * 128))
        x = v.reshape(-1, v.shape[-1])

        def fn():
            return torch.sparse.mm(A, x)
        fn()
        torch.cuda.synchronize()
        return fn, None
    except Exception as e:      # the yardstick is optional: report why
        return None, f"{type(e).__name__}: {e}"


def main_path_kernels(sm: Smoke, errs: dict, win, tile) -> list:
    """Each kernel at the shapes the main path gave it: held against its
    plain version for all three programs, then timed for SSSP on the
    compact device lists the engine feeds it and on the padded JAX-layout
    input (the same work plus the padding), beside its bound and a library
    call."""
    import torch
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core.engine import (_layout_block_from, _tile_inputs,
                                         _window_inputs)
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    dev = torch.device(DEVICE)
    out = []
    programs = (("sssp", SSSP()), ("cc", ConnectedComponents()),
                ("pagerank", PageRank()))

    # windows kernel on kron-20
    sess, res = win[:2]
    sgs = sess.device_graph()
    lay = sess.pg.edge_layouts
    timing = None
    for name, prog in programs:
        key = ("pallas_windows", "sssp_a" if name == "sssp" else name)
        vals = torch.from_numpy(res[key]).to(dev)[..., None]
        blk = _layout_block_from(lay, sess.pg, prog, "pallas_windows", dev)
        msgs, ldst, bwin, nw, plan = _window_inputs(
            sgs, blk, vals, prog.sweep_spec, sgs.v_max)
        comb = prog.sweep_spec.combiner
        got = sk.segment_combine_windowed(msgs, ldst, bwin, n_windows=nw,
                                          combiner=comb, plan=plan)
        want = sk.segment_combine_plain(msgs, ldst, bwin, n_windows=nw,
                                        combiner=comb)
        torch.cuda.synchronize()
        ok, err = compare(got, want, segment_magnitude(
            msgs, ldst, bwin, nw, comb))
        errs["segment_combine"] = max(errs["segment_combine"], err)
        sm.check(ok, f"segment_combine {comb} {msgs.dtype} at kron-20 "
                     f"shape {tuple(msgs.shape)} vs plain (max err {err:.3g})")
        if name == "sssp":
            timing = (msgs, ldst, bwin, nw, comb, plan, got)
            pad = padded_window_inputs(sess, sgs, prog, vals)
    msgs, ldst, bwin, nw, comb, plan, got = timing
    pm, pl, pb, pnw = pad
    pplan = sk.plan_windows(pb, pnw)
    got_p = sk.segment_combine_windowed(pm, pl, pb, n_windows=pnw,
                                        combiner=comb, plan=pplan)
    want_p = sk.segment_combine_plain(pm, pl, pb, n_windows=pnw,
                                      combiner=comb)
    torch.cuda.synchronize()
    sm.check(torch.equal(got_p, want_p) and torch.equal(got_p, got),
             f"segment_combine on the padded kron-20 input {tuple(pm.shape)}"
             f" (longest window {int(torch.bincount(pb).max())} blocks) "
             f"equals its plain version and the compact result")
    Be = lay.block_edges
    K = msgs.shape[1]
    real_edges = int(lay.n_blocks.sum()) * Be
    nbytes = real_edges * (K + 1) * 4 + int(lay.n_blocks.sum()) * 4 \
        + nw * 128 * K * 4
    ops = real_edges * K
    row = (bwin.long().repeat_interleave(Be) * 128 + ldst.long())[:, None]
    row = row.expand(-1, K).contiguous()
    lib_out = torch.full((nw * 128, K), float("inf"), device=dev)
    rec = dict(
        name="segment_combine_windowed", route="cuda",
        source="src/repro_torch/csrc/segment_combine.cu",
        replaces="src/repro/kernels/segment_combine.py:79",
        ms=time_ms(lambda: sk.segment_combine_windowed(
            msgs, ldst, bwin, n_windows=nw, combiner=comb, plan=plan)),
        padded_ms=time_ms(lambda: sk.segment_combine_windowed(
            pm, pl, pb, n_windows=pnw, combiner=comb, plan=pplan)),
        plain_ms=time_ms(lambda: sk.segment_combine_plain(
            msgs, ldst, bwin, n_windows=nw, combiner=comb)),
        library_ms=time_ms(lambda: lib_out.scatter_reduce_(
            0, row, msgs, "amin", include_self=True)),
        bytes=nbytes, ops=ops, shape=f"msgs {tuple(msgs.shape)} f32 min, "
        f"{nw} windows, {plan.n_chunks} chunks (kron-20 SSSP); padded "
        f"input {tuple(pm.shape)}")
    out.append(rec)
    del pad, pm, pl, pb, got_p, want_p, row, lib_out

    # tile kernel on the grid graph
    sess, res = tile[:2]
    lay = sess.pg.edge_layouts
    timing = pr = None
    for name, prog in programs:
        vals = torch.from_numpy(res[("pallas_tiles", name)]).to(dev)[..., None]
        blk = _layout_block_from(lay, sess.pg, prog, "pallas_tiles", dev)
        tiles, td, ts, v, ndt, plan = _tile_inputs(
            blk, vals, prog.sweep_spec, sess.pg.v_max)
        semi = prog.sweep_spec.semiring
        got = bk.bsp_spmv(tiles, td, ts, v, n_dst_tiles=ndt, semiring=semi,
                          plan=plan)
        want = bk.bsp_spmv_plain(tiles, td, ts, v, n_dst_tiles=ndt,
                                 semiring=semi)
        torch.cuda.synchronize()
        ok, err = compare(got, want, spmv_magnitude(
            tiles, td, ts, v, ndt, semi))
        errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
        sm.check(ok, f"bsp_spmv {semi} {v.dtype} at grid shape "
                     f"T={tiles.shape[0]} vs plain (max err {err:.3g})")
        if name == "sssp":
            timing = (tiles, td, ts, v, ndt, semi, plan, got, prog)
        if name == "pagerank":
            pr = (tiles, td, ts, v, ndt, semi, plan, got)
    tiles, td, ts, v, ndt, semi, plan, got, prog = timing
    ptiles, ptd, pts = padded_tile_inputs(sess, prog, dev)
    pplan = bk.plan_tiles(ptd, ndt)
    got_p = bk.bsp_spmv(ptiles, ptd, pts, v, n_dst_tiles=ndt, semiring=semi,
                        plan=pplan)
    want_p = bk.bsp_spmv_plain(ptiles, ptd, pts, v, n_dst_tiles=ndt,
                               semiring=semi)
    torch.cuda.synchronize()
    sm.check(torch.equal(got_p, want_p) and torch.equal(got_p, got),
             f"bsp_spmv on the padded grid input ({ptiles.shape[0]} tiles, "
             f"longest dst row {int(torch.bincount(ptd).max())} tiles) "
             f"equals its plain version and the compact result")
    padded_ms = time_ms(lambda: bk.bsp_spmv(
        ptiles, ptd, pts, v, n_dst_tiles=ndt, semiring=semi, plan=pplan))
    del ptiles, ptd, pts, got_p, want_p
    T_real = int(lay.n_tiles.sum())
    K = v.shape[-1]
    nbytes = T_real * 128 * 128 * 4 + 2 * T_real * 4 + v.numel() * 4 \
        + ndt * 128 * K * 4
    ops = 2 * T_real * 128 * 128 * K

    # plus_times (grid PageRank) beside one PyTorch call
    t2, td2, ts2, v2, ndt2, semi2, plan2, got2 = pr
    pt_ms = time_ms(lambda: bk.bsp_spmv(t2, td2, ts2, v2, n_dst_tiles=ndt2,
                                        semiring=semi2, plan=plan2))
    lib_fn, lib_err = bsr_yardstick(t2, td2, ts2, v2, ndt2)
    pt_lib_ms = None
    if lib_fn is not None:
        y = lib_fn().reshape(got2.shape)
        torch.cuda.synchronize()
        ok, err = compare(got2, y, spmv_magnitude(t2, td2, ts2, v2, ndt2,
                                                  semi2))
        sm.note(f"torch.sparse.mm (BSR) agrees with bsp_spmv plus_times: "
                f"{ok} (max err {err:.3g})")
        pt_lib_ms = time_ms(lib_fn)
    else:
        sm.note(f"torch.sparse.mm (BSR) refused on the card: {lib_err}")
    rec = dict(
        name="bsp_spmv", route="cuda",
        source="src/repro_torch/csrc/bsp_spmv.cu",
        replaces="src/repro/kernels/bsp_spmv.py:82",
        ms=time_ms(lambda: bk.bsp_spmv(tiles, td, ts, v, n_dst_tiles=ndt,
                                       semiring=semi, plan=plan)),
        padded_ms=padded_ms,
        plain_ms=time_ms(lambda: bk.bsp_spmv_plain(
            tiles, td, ts, v, n_dst_tiles=ndt, semiring=semi), max_iters=5),
        library_ms=None, plus_times_ms=pt_ms,
        plus_times_library_ms=pt_lib_ms, plus_times_library_error=lib_err,
        bytes=nbytes, ops=ops,
        shape=f"tiles [{tiles.shape[0]}, 128, 128] f32 min_plus, K={K}, "
        f"{plan.n_chunks} chunks (grid SSSP); padded input "
        f"{lay.n_parts * lay.t_max} tiles; plus_times at the grid PageRank "
        f"shape")
    out.append(rec)
    return out



# --------------------------------------------------------------------------- #
# phase 6: the streaming lifecycle
# --------------------------------------------------------------------------- #
class LayoutTimer:
    """Host seconds the edge layouts' refresh takes (the incremental
    rebuild, the column growth and a full rebuild), gathered by wrapping
    those three entry points for the duration of phase 6."""

    def __init__(self):
        from repro_torch.core import layouts as L
        self.seconds = 0.0
        self._orig = [(owner, name, getattr(owner, name))
                      for owner, name in ((L.EdgeLayouts, "rebuild_partitions"),
                                          (L.EdgeLayouts, "sync_capacity"),
                                          (L, "build_edge_layouts"))]
        for owner, name, fn in self._orig:
            setattr(owner, name, self._timed(fn))

    def _timed(self, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t
        return run

    def take(self) -> float:
        s, self.seconds = self.seconds, 0.0
        return s

    def close(self) -> None:
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def oracle_sssp_edges(n, src, dst, w, source):
    """Dijkstra over an edge list whose parallel copies keep the lightest
    weight (the session relaxes every resident copy)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    key = src.astype(np.int64) * n + dst
    order = np.argsort(key, kind="stable")
    key, w = key[order], w[order].astype(np.float64)
    first = np.concatenate([[True], key[1:] != key[:-1]])
    starts = np.nonzero(first)[0]
    wmin = np.minimum.reduceat(w, starts)
    k = key[starts]
    m = csr_matrix((wmin, (k // n, k % n)), shape=(n, n))
    return dijkstra(m, directed=True, indices=source)


def sym_batch(rng, n_pairs, n, new_ids=()):
    """``n_pairs`` distinct unordered pairs u != v of ids below ``n``, plus
    one pair from each of ``new_ids`` to a random id below ``n``; both
    directions, weights uniform in [5, 10)."""
    import numpy as np
    u = rng.integers(0, n, 2 * n_pairs)
    v = rng.integers(0, n, 2 * n_pairs)
    keep = u != v
    u, v = u[keep], v[keep]
    _, idx = np.unique(np.minimum(u, v) * n + np.maximum(u, v),
                       return_index=True)
    idx = np.sort(idx)[:n_pairs]
    new_ids = np.asarray(new_ids, np.int64)
    u = np.concatenate([u[idx], new_ids])
    v = np.concatenate([v[idx], rng.integers(0, n, new_ids.shape[0])])
    w = rng.uniform(5.0, 10.0, u.shape[0]).astype(np.float32)
    return (np.concatenate([u, v]), np.concatenate([v, u]),
            np.concatenate([w, w]))


def streaming_path(sm: Smoke, log: list, win, tile, ident: str) -> dict:
    """Phase 6 (see the module docstring). Returns the state the kernel
    checks after it need and the per-step records."""
    import numpy as np
    import torch
    from repro_torch.algos import SSSP, ConnectedComponents, PageRank
    from repro_torch.core import EngineConfig

    sess, _, g, s0 = win
    sq = tile[2]
    timer = LayoutTimer()
    steps = []
    rng = np.random.default_rng(13)
    win_cfg = EngineConfig(edge_backend="pallas_windows")
    coo_cfg = EngineConfig(edge_backend="coo")
    # the mutated kron-20 edge list, kept on the host for the oracle
    es, ed, ew = [g.src], [g.dst], [g.weights]

    def refresh(label, s, mutate):
        """Mutate (then flush) ``s``; time the host work and the re-upload
        of the device graph and of the kernels' device list."""
        t = time.perf_counter()
        st = mutate()
        host = time.perf_counter() - t
        layout = timer.take()
        t = time.perf_counter()
        s.device_graph()
        torch.cuda.synchronize()
        upload = time.perf_counter() - t
        eb = "pallas_windows" if s is sess else "pallas_tiles"
        t = time.perf_counter()
        s._layout_arg(SSSP(), eb)
        torch.cuda.synchronize()
        dev_list = time.perf_counter() - t
        rec = dict(graph="kron-20" if s is sess else "kron-14", step=label,
                   host_s=host - layout, layout_refresh_s=layout,
                   graph_upload_s=upload, device_list_s=dev_list,
                   shape_key=list(s.shape_key), n_edges=s.pg.n_edges,
                   n_vertices=s.pg.n_vertices, gpu=ident)
        steps.append(rec)
        sm.note(f"stream {rec['graph']} {label}: host {rec['host_s']:.3f}s "
                f"(mutation + flush), layout refresh {layout:.3f}s, graph "
                f"upload {upload:.3f}s, {eb} device list {dev_list:.3f}s; "
                f"shape key {s.shape_key} [{ident}]")
        return st, rec

    def q(s, prog, params, warm, cfg, rec, name):
        res, st = s.query(prog, params, warm=warm, cfg=cfg)
        rec.setdefault("queries", []).append(dict(
            query=name, edge_backend=cfg.edge_backend, wall_s=st.wall_time,
            supersteps=st.supersteps, messages=st.total_messages))
        return res, st

    def sssp_three_ways(rec, label, oracle):
        wres, wst = q(sess, SSSP(), {"source": s0}, "auto", win_cfg, rec,
                      "sssp_warm")
        cres, cst = q(sess, SSSP(), {"source": s0}, False, win_cfg, rec,
                      "sssp_cold")
        ores, _ = q(sess, SSSP(), {"source": s0}, False, coo_cfg, rec,
                    "sssp_coo")
        sm.check(bool(np.array_equal(wres, cres)),
                 f"kron-20 {label}: SSSP warm-auto bit-identical to cold")
        sm.check(wst.supersteps < cst.supersteps,
                 f"kron-20 {label}: warm took {wst.supersteps} supersteps, "
                 f"cold {cst.supersteps}")
        sm.check(bool(np.array_equal(cres, ores)),
                 f"kron-20 {label}: SSSP on pallas_windows bit-identical to "
                 f"coo")
        if oracle:
            t = time.perf_counter()
            want = oracle_sssp_edges(sess.pg.n_vertices, np.concatenate(es),
                                     np.concatenate(ed), np.concatenate(ew),
                                     s0)
            d = sess.pg.collect(cres, fill=np.float32(np.inf)).astype(
                np.float64)
            fin = np.isfinite(want)
            sm.check(bool(np.array_equal(np.isfinite(d), fin) and np.allclose(
                d[fin], want[fin], rtol=1e-5)),
                f"kron-20 {label}: SSSP agrees with scipy Dijkstra on the "
                f"mutated edge list (rtol 1e-5; {int(fin.sum())} reachable; "
                f"oracle {time.perf_counter() - t:.1f}s)")
        return cres

    # ---- kron-20 (windows) ---------------------------------------------- #
    n0, E0 = g.n_vertices, g.n_edges
    for label, new in (("insert 1", ()),
                       ("insert 2 (+1024 ids)", np.arange(n0, n0 + 1024))):
        src, dst, w = sym_batch(rng, E0 // 400, n0, new)
        es.append(src)
        ed.append(dst)
        ew.append(w)

        def mutate(src=src, dst=dst, w=w):
            sess.update(adds=(src, dst, w))
            return sess.flush()
        st, rec = refresh(label, sess, mutate)
        sm.check(st.n_added == src.shape[0] and st.warm_start_safe
                 and sess.pg.n_vertices == n0 + len(new),
                 f"kron-20 {label}: {st.n_added} edges added in one flush, "
                 f"{sess.pg.n_vertices} vertices")
        sssp_three_ways(rec, label, oracle=True)

    src_all, dst_all = np.concatenate(es), np.concatenate(ed)
    pick = rng.random(src_all.shape[0]) < 0.05

    def delete():
        sess.update(deletes=(src_all[pick], dst_all[pick]))
        return sess.flush()
    st, rec = refresh("delete 5%", sess, delete)
    sm.check(st.n_deleted > 0 and not st.warm_start_safe
             and len(sess._warm) == 0,
             f"kron-20 delete: {st.n_deleted} resident edges removed, warm "
             f"results dropped")
    for name, prog, params in (
            ("cc", ConnectedComponents(), None),
            ("pagerank", PageRank(), {"n_vertices": sess.pg.n_vertices})):
        got, _ = q(sess, prog, params, False, win_cfg, rec, name)
        want, _ = q(sess, prog, params, False, coo_cfg, rec, name + "_coo")
        if prog.delta_based:
            err = float(np.abs(got - want).max())
            scale = float(np.abs(want).max())
            sm.check(err <= PR_RTOL * scale and bool(np.isfinite(got).all()),
                     f"kron-20 delete: PageRank windows == coo within "
                     f"{PR_RTOL:g} of max rank (max err {err:.3g})")
        else:
            sm.check(bool(np.array_equal(got, want)),
                     "kron-20 delete: CC windows bit-identical to coo")
    q(sess, SSSP(), {"source": s0}, False, win_cfg, rec, "sssp_seed")

    cs, rec = refresh("compact", sess, sess.compact)
    sm.check(cs.n_evicted >= 0 and cs.remap is not None,
             f"kron-20 compact: {cs.n_evicted} rows evicted, v_max "
             f"{cs.v_max_before} -> {cs.v_max_after}, e_max "
             f"{cs.e_max_before} -> {cs.e_max_after}")
    win_vals = sssp_three_ways(rec, "compact", oracle=False)

    # ---- kron-14 (tiles) ------------------------------------------------ #
    from repro_torch.stream import EdgeDelta

    def tiles_queries(label, rec):
        qs = [("sssp", SSSP(), {"source": 0}, False),
              ("cc", ConnectedComponents(), None, False),
              ("pagerank", PageRank(), {"n_vertices": sq.pg.n_vertices},
               False)]
        before = len(log)
        res = run_queries(sm, sq, f"kron-14 {label}", "pallas_tiles", qs,
                          log)
        rec["queries"] = log[before:]
        return res

    nq = sq.pg.n_vertices
    src, dst, w = sym_batch(rng, sq.pg.n_edges // 100, nq)

    def small_updates():
        for lo in range(0, src.shape[0], 200):
            sq.update(adds=(src[lo:lo + 200], dst[lo:lo + 200],
                            w[lo:lo + 200]))
        return sq.flush()
    auto0 = sq.buffer.stats.auto_flushes
    _, rec = refresh("small updates", sq, small_updates)
    sm.check(sq.buffer.stats.auto_flushes - auto0 > 0,
             f"kron-14: {src.shape[0]} edges through "
             f"{-(-src.shape[0] // 200)} update calls, "
             f"{sq.buffer.stats.auto_flushes - auto0} auto-flushes")
    tiles_queries("small updates", rec)

    # the fullest partition's own resident pairs once more (parallel
    # copies, weights in [5, 10)): just enough to move the e_max bucket
    # with the members, and so v_max and the tiles, unchanged
    key0, pg = sq.shape_key, sq.pg
    p = int(np.argmax(pg.edges_per_part))
    m = pg.emask[p]
    gs, gd = pg.gvid[p][pg.esrc[p][m]], pg.gvid[p][pg.edst[p][m]]
    _, first = np.unique(gs * nq + gd, return_index=True)
    n_big = pg.e_max - int(m.sum()) + 1
    pick = np.sort(first)[:n_big]
    big = EdgeDelta(add_src=gs[pick], add_dst=gd[pick],
                    add_w=rng.uniform(5, 10, pick.shape[0]).astype(
                        np.float32))

    def push_big():
        sq.push(big)
        return sq.flush()
    _, rec = refresh("e_max batch", sq, push_big)
    sm.note(f"kron-14 shape key {key0} -> {sq.shape_key}")
    sm.check(pick.shape[0] == n_big and sq.shape_key[2] > key0[2],
             f"kron-14: the batch of {n_big} edges into partition {p} moved "
             f"the e_max bucket ({key0[2]} -> {sq.shape_key[2]})")
    tiles_queries("e_max batch", rec)
    _, rec = refresh("compact", sq, sq.compact)
    tile_res = tiles_queries("compact", rec)

    # ---- checkpoint / resume (trace mode, kron-14 on tiles) ------------- #
    import shutil
    import tempfile
    from repro_torch.core import run_sim
    ckdir = tempfile.mkdtemp(prefix="bsp_ckpt_")
    try:
        for name, prog, params in (
                ("sssp", SSSP(), {"source": 0}),
                ("pagerank", PageRank(), {"n_vertices": sq.pg.n_vertices})):
            d = f"{ckdir}/{name}"
            cfg = EngineConfig(edge_backend="pallas_tiles", trace=True,
                               checkpoint_every=2, checkpoint_dir=d)
            full, fst = run_sim(prog, sq.pg, params, cfg, device=DEVICE)
            second = f"{d}/bsp_000004.npz"
            res, rst = run_sim(prog, sq.pg, params,
                               EngineConfig(edge_backend="pallas_tiles",
                                            trace=True),
                               resume_from=second, device=DEVICE)
            same = (np.allclose(res, full, rtol=PR_RTOL, atol=PR_RTOL)
                    if prog.delta_based else np.array_equal(res, full))
            # a checkpoint of the halting superstep resumes into one more,
            # empty, superstep (the JAX engine does the same)
            want = fst.supersteps + (fst.supersteps <= 4)
            sm.check(bool(same) and rst.supersteps == want,
                     f"kron-14 {name}: resumed from the second checkpoint "
                     f"(step 4 of {fst.supersteps}): {rst.supersteps} "
                     f"supersteps, the uninterrupted run's results")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    timer.close()
    return dict(steps=steps, win_vals=win_vals, tile_res=tile_res)


def stream_kernel_checks(sm: Smoke, errs: dict, win, tile, out) -> None:
    """Each kernel against its plain version once on the post-compact
    device lists of phase 6 (min exact; sums within SUM_RTOL)."""
    import torch
    from repro_torch.algos import SSSP, PageRank
    from repro_torch.core.engine import (_layout_block_from, _tile_inputs,
                                         _window_inputs)
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    dev = torch.device(DEVICE)
    sess, sq = win[0], tile[2]
    sgs = sess.device_graph()
    dist = torch.from_numpy(out["win_vals"]).to(dev)[..., None]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for prog in (SSSP(), PageRank()):
        blk = _layout_block_from(sess.pg.edge_layouts, sess.pg, prog,
                                 "pallas_windows", dev)
        vals = torch.rand(dist.shape, generator=gen, device=dev) \
            if prog.delta_based else dist
        msgs, ldst, bwin, nw, plan = _window_inputs(
            sgs, blk, vals, prog.sweep_spec, sgs.v_max)
        comb = prog.sweep_spec.combiner
        got = sk.segment_combine_windowed(msgs, ldst, bwin, n_windows=nw,
                                          combiner=comb, plan=plan)
        want = sk.segment_combine_plain(msgs, ldst, bwin, n_windows=nw,
                                        combiner=comb)
        torch.cuda.synchronize()
        ok, err = compare(got, want, segment_magnitude(msgs, ldst, bwin, nw,
                                                       comb))
        errs["segment_combine"] = max(errs["segment_combine"], err)
        sm.check(ok, f"segment_combine {comb} on the post-compact kron-20 "
                     f"list ({bwin.shape[0]} blocks) vs plain (max err "
                     f"{err:.3g})")
    for name, prog in (("sssp", SSSP()), ("pagerank", PageRank())):
        v = torch.from_numpy(out["tile_res"][("pallas_tiles", name)]).to(
            dev)[..., None]
        blk = _layout_block_from(sq.pg.edge_layouts, sq.pg, prog,
                                 "pallas_tiles", dev)
        tiles, td, ts, vv, ndt, plan = _tile_inputs(blk, v, prog.sweep_spec,
                                                    sq.pg.v_max)
        semi = prog.sweep_spec.semiring
        got = bk.bsp_spmv(tiles, td, ts, vv, n_dst_tiles=ndt, semiring=semi,
                          plan=plan)
        want = bk.bsp_spmv_plain(tiles, td, ts, vv, n_dst_tiles=ndt,
                                 semiring=semi)
        torch.cuda.synchronize()
        ok, err = compare(got, want, spmv_magnitude(tiles, td, ts, vv, ndt,
                                                    semi))
        errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
        sm.check(ok, f"bsp_spmv {semi} on the post-compact kron-14 list "
                     f"({tiles.shape[0]} tiles) vs plain (max err {err:.3g})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk

    sm = Smoke()
    ident = gpu_identity()
    sm.note(f"gpu: {ident}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    took = _build.build()
    sm.note(f"kernels built in {time.perf_counter() - t:.1f}s (parallel "
            f"nvcc): " + ", ".join(f"{k} {v:.1f}s" for k, v in took.items()))
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                sm.note(f"ptxas {name}: {line.strip()}")

    errs = {"bsp_spmv": 0.0, "segment_combine": 0.0}
    kernel_case_grid(sm, errs)
    small_graph_check(sm)

    log: list = []
    bk.bsp_spmv.launches = 0
    sk.segment_combine_windowed.launches = 0
    peak = {}
    torch.cuda.reset_peak_memory_stats()
    win = windows_path(sm, log)
    peak["windows path"] = torch.cuda.max_memory_allocated()
    w_launch = (bk.bsp_spmv.launches, sk.segment_combine_windowed.launches)
    torch.cuda.reset_peak_memory_stats()
    tile = tiles_path(sm, log)
    peak["tiles path"] = torch.cuda.max_memory_allocated()
    for path, nbytes in peak.items():
        sm.note(f"peak device memory, {path}: {nbytes} bytes "
                f"({nbytes / 2**30:.2f} GiB; torch.cuda.max_memory_allocated)")
    launches = {"bsp_spmv": bk.bsp_spmv.launches,
                "segment_combine_windowed":
                    sk.segment_combine_windowed.launches}
    sm.note(f"launches: windows path {w_launch[1]} segment_combine, "
            f"{w_launch[0]} bsp_spmv; after tiles path {launches}")
    sm.check(w_launch[1] > 0, "windows path launched segment_combine")
    sm.check(launches["bsp_spmv"] - w_launch[0] > 0,
             "tiles path launched bsp_spmv")
    syncs = sum(r["host_syncs"] for r in log)
    sm.note(f"host syncs over {len(log)} main-path queries: {syncs}")

    recs = main_path_kernels(sm, errs, win, tile)

    bk.bsp_spmv.launches = 0
    sk.segment_combine_windowed.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stream = streaming_path(sm, log, win, tile, ident)
    peak["streaming"] = torch.cuda.max_memory_allocated()
    stream_launches = {"bsp_spmv": bk.bsp_spmv.launches,
                       "segment_combine_windowed":
                           sk.segment_combine_windowed.launches}
    sm.note(f"launches in the streaming phase: {stream_launches}")
    sm.check(all(v > 0 for v in stream_launches.values()),
             "the streaming phase launched both kernels")
    stream_kernel_checks(sm, errs, win, tile, stream)
    kernels = []
    for r in recs:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_OPS_PER_S * 1e3
        err_key = "bsp_spmv" if r["name"] == "bsp_spmv" else "segment_combine"
        sm.note(f"{r['name']}: {r['shape']}; {r['bytes']} bytes, {r['ops']} "
                f"ops")
        extra = {k: r[k] for k in ("padded_ms", "plus_times_ms",
                                   "plus_times_library_ms") if k in r}
        kernels.append(dict(
            name=r["name"], route=r["route"], source=r["source"],
            replaces=r["replaces"], launches=launches[r["name"]],
            max_abs_err=errs[err_key], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"],
            launches_streaming=stream_launches[r["name"]], **extra))
    Path(ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke_queries.json").write_text(
        json.dumps(dict(gpu=ident, queries=log, kernels=kernels,
                        stream_steps=stream["steps"],
                        peak_memory_bytes=peak,
                        kernel_shapes={r["name"]: r["shape"] for r in recs},
                        plus_times_library_error=recs[-1].get(
                            "plus_times_library_error")), indent=1))
    sm.note(f"total {time.perf_counter() - sm.t0:.1f}s")
    if sm.failures:
        print(f"chip_smoke: {len(sm.failures)} check(s) failed:",
              file=sys.stderr)
        for f in sm.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(ident)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
