#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (the run exits non-zero if any of them fails):

  1. GPU identity and the kernels' build: ``nvcc`` compiles every source of
     ``src/repro_torch/csrc`` in parallel; ptxas' register and spill report
     is printed.
  2. Each kernel against its plain PyTorch version on the card, on the case
     grid of the kernel tests: bit-exact for min/max; for sums, each
     output within 1e-5 of the same sum taken over the inputs' absolute
     values (the scale of a reordered float sum's rounding).
  3. The windows path at full size: ``GraphSession.from_graph(
     kronecker_graph(20, seed=7), 16, "cdbh")``; SSSP from two sources and
     a warm repeat, CC and PageRank on ``pallas_windows``, each held against
     the same query on ``coo``.
  4. The tiles path: ``grid_graph(1024, weighted=True, seed=9)`` with the
     ``range`` vertex-cut (P=16), SSSP, CC and PageRank on ``pallas_tiles``
     against ``coo``; then the quickstart graph (``kronecker_graph(14)``,
     ``cdbh``, P=16) on ``pallas_tiles``.
  5. Kernel confirmation: both kernels' launch counters, reset just before
     phase 3 and read just after phase 4, must be positive. Each kernel is
     then checked and timed against its plain version at the
     shapes phases 3 and 4 gave it, beside its bound on the card and, where
     one PyTorch call computes the same function, that call's time.

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
    from repro_torch.kernels import bsp_spmv as bk
    from repro_torch.kernels import segment_combine as sk
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
            got = bk.bsp_spmv(*args, n_dst_tiles=ndt, semiring=semiring)
            want = bk.bsp_spmv_plain(*args, n_dst_tiles=ndt,
                                     semiring=semiring)
            torch.cuda.synchronize()
            ok, err = compare(got, want, spmv_magnitude(
                *args, ndt, semiring))
            errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
            sm.check(ok, f"bsp_spmv {semiring} {np.dtype(dtype).name} "
                         f"T={T} K={K} vs plain (max err {err:.3g})")

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
            got = sk.segment_combine_windowed(*args, n_windows=lay.n_windows,
                                              combiner=combiner)
            want = sk.segment_combine_plain(*args, n_windows=lay.n_windows,
                                            combiner=combiner)
            torch.cuda.synchronize()
            ok, err = compare(got, want, segment_magnitude(
                *args, lay.n_windows, combiner))
            errs["segment_combine"] = max(errs["segment_combine"], err)
            sm.check(ok, f"segment_combine {combiner} {np.dtype(dtype).name} "
                         f"E={E} K={K} Be={Be} vs plain (max err {err:.3g})")


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

    results = {}
    for eb in (kernel_eb, "coo"):
        cfg = EngineConfig(edge_backend=eb)
        for name, prog, params, warm in queries:
            before = launches()
            res, st = sess.query(prog, params, warm=warm, cfg=cfg)
            results[(eb, name)] = res
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
    sess = GraphSession.from_graph(g, 16, "cdbh", device=DEVICE)
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
    return sess, res


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
    return sess, res


# --------------------------------------------------------------------------- #
# phase 5: kernels at the main path's shapes
# --------------------------------------------------------------------------- #
def main_path_kernels(sm: Smoke, errs: dict, win, tile) -> list:
    import numpy as np
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
    sess, res = win
    sgs = sess.device_graph()
    lay = sess.pg.edge_layouts
    timing = None
    for name, prog in programs:
        key = ("pallas_windows", "sssp_a" if name == "sssp" else name)
        vals = torch.from_numpy(res[key]).to(dev)[..., None]
        blk = _layout_block_from(lay, sess.pg, prog, "pallas_windows", dev)
        msgs, ldst, bwin, nw = _window_inputs(sgs, blk, vals,
                                              prog.sweep_spec, sgs.v_max)
        comb = prog.sweep_spec.combiner
        got = sk.segment_combine_windowed(msgs, ldst, bwin, n_windows=nw,
                                          combiner=comb)
        want = sk.segment_combine_plain(msgs, ldst, bwin, n_windows=nw,
                                        combiner=comb)
        torch.cuda.synchronize()
        ok, err = compare(got, want, segment_magnitude(
            msgs, ldst, bwin, nw, comb))
        errs["segment_combine"] = max(errs["segment_combine"], err)
        sm.check(ok, f"segment_combine {comb} {msgs.dtype} at kron-20 "
                     f"shape {tuple(msgs.shape)} vs plain (max err {err:.3g})")
        if name == "sssp":
            timing = (msgs, ldst, bwin, nw, comb)
    msgs, ldst, bwin, nw, comb = timing
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
            msgs, ldst, bwin, n_windows=nw, combiner=comb)),
        plain_ms=time_ms(lambda: sk.segment_combine_plain(
            msgs, ldst, bwin, n_windows=nw, combiner=comb)),
        library_ms=time_ms(lambda: lib_out.scatter_reduce_(
            0, row, msgs, "amin", include_self=True)),
        bytes=nbytes, ops=ops, shape=f"msgs {tuple(msgs.shape)} f32 min, "
        f"{nw} windows (kron-20 SSSP)")
    out.append(rec)

    # tile kernel on the grid graph
    sess, res = tile
    lay = sess.pg.edge_layouts
    timing = None
    for name, prog in programs:
        vals = torch.from_numpy(res[("pallas_tiles", name)]).to(dev)[..., None]
        blk = _layout_block_from(lay, sess.pg, prog, "pallas_tiles", dev)
        tiles, td, ts, v, ndt = _tile_inputs(blk, vals, prog.sweep_spec,
                                             sess.pg.v_max)
        semi = prog.sweep_spec.semiring
        got = bk.bsp_spmv(tiles, td, ts, v, n_dst_tiles=ndt, semiring=semi)
        want = bk.bsp_spmv_plain(tiles, td, ts, v, n_dst_tiles=ndt,
                                 semiring=semi)
        torch.cuda.synchronize()
        ok, err = compare(got, want, spmv_magnitude(
            tiles, td, ts, v, ndt, semi))
        errs["bsp_spmv"] = max(errs["bsp_spmv"], err)
        sm.check(ok, f"bsp_spmv {semi} {v.dtype} at grid shape "
                     f"T={tiles.shape[0]} vs plain (max err {err:.3g})")
        if name == "sssp":
            timing = (tiles, td, ts, v, ndt, semi)
    tiles, td, ts, v, ndt, semi = timing
    T_real = int(lay.n_tiles.sum())
    K = v.shape[-1]
    nbytes = T_real * 128 * 128 * 4 + 2 * T_real * 4 + v.numel() * 4 \
        + ndt * 128 * K * 4
    ops = 2 * T_real * 128 * 128 * K
    rec = dict(
        name="bsp_spmv", route="cuda",
        source="src/repro_torch/csrc/bsp_spmv.cu",
        replaces="src/repro/kernels/bsp_spmv.py:82",
        ms=time_ms(lambda: bk.bsp_spmv(tiles, td, ts, v, n_dst_tiles=ndt,
                                       semiring=semi)),
        plain_ms=time_ms(lambda: bk.bsp_spmv_plain(
            tiles, td, ts, v, n_dst_tiles=ndt, semiring=semi), max_iters=5),
        library_ms=None, bytes=nbytes, ops=ops,
        shape=f"tiles [{tiles.shape[0]}, 128, 128] f32 min_plus "
        f"({T_real} real), K={K} (grid SSSP)")
    out.append(rec)
    return out


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
    win = windows_path(sm, log)
    w_launch = (bk.bsp_spmv.launches, sk.segment_combine_windowed.launches)
    tile = tiles_path(sm, log)
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
    kernels = []
    for r in recs:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_OPS_PER_S * 1e3
        err_key = "bsp_spmv" if r["name"] == "bsp_spmv" else "segment_combine"
        sm.note(f"{r['name']}: {r['shape']}; {r['bytes']} bytes, {r['ops']} "
                f"ops")
        kernels.append(dict(
            name=r["name"], route=r["route"], source=r["source"],
            replaces=r["replaces"], launches=launches[r["name"]],
            max_abs_err=errs[err_key], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"]))
    Path(ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke_queries.json").write_text(
        json.dumps(dict(gpu=ident, queries=log, kernels=kernels),
                   indent=1))
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
