"""One run of one cell: set-up, the measured window, the readers, the check.

Set-up makes the cell's graph on the device from the seed (the
configuration's generator; a configuration that names a ``graph_seed`` is
one fixed graph, as a data set's file is, and the run's seed then draws only
the keys), draws the keys (the traffic mix), hands the
graph to the program (``GraphSession.from_graph`` with the configuration's
partitioner, partition count and edge backend) and serves one warm-up call
on keys the window never reaches. The window is a closed loop of one
client: each call is timed on the host from the call to
``GraphSession.query`` until its numpy result is in hand, the next call
starts when it returns, and the window closes at the end of the first call
that ends ``seconds`` or more after the first began. Then the peak device
memory is read, the program is freed, and a sample of the window's calls
(drawn from the seed, plus the slowest) is compared with the plain
reference, which works from the benchmark's own edge list.

The device memory counted is the program's, its set-up included: the
benchmark's own inputs are moved off the device and the peak statistics
reset before ``GraphSession.from_graph`` runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from gbench.harness import manifest as mf
from gbench.harness.graphs import EdgeList, subseed
from gbench.harness.trace import WINDOW_SPAN, TraceSummary, profiled
from gbench.harness.traffic import calls, key_sequence

__all__ = ["FORBIDDEN", "CallRecord", "Run", "Port", "Control", "measure",
           "is_correct", "forbidden_modules"]

#: top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
MAX_FAILED = 3
#: a traced run measures at most this long: the profiler keeps every host op
#: and kernel of the window (up to about a million in 10 s)
TRACE_SECONDS = 10.0


@dataclasses.dataclass
class CallRecord:
    latency_s: float
    lanes: int
    host_syncs: Optional[int]
    sweeps: Optional[List[int]]          # per partition
    edges: Optional[List[int]]           # real directed edges per partition
    supersteps: Optional[int]            # exchange rounds


@dataclasses.dataclass
class Run:
    """What the metric readers read (``gbench/metrics/<name>.py``)."""
    workload: dict
    config: dict
    traffic: dict
    lanes: int
    weighted: bool
    n_vertices: int
    n_touched: int                      # vertices with at least one edge
    n_undirected: int
    calls: List[CallRecord]
    window_s: float
    setup: dict
    vertices_per_part: Optional[List[int]]
    memory_peak_bytes: int
    device_kind: str
    peak: Optional[dict]
    trace: Optional[TraceSummary]


class Port:
    """The program under test: a ``GraphSession`` over the cell's graph."""

    def __init__(self, edges: EdgeList, cfg: dict, query, lanes: int,
                 device):
        """``edges`` on the host: the session moves what it keeps."""
        from repro_torch.core.engine import EngineConfig
        from repro_torch.core.graph import Graph
        from repro_torch.session import GraphSession
        src, dst, w = edges.to_host()
        g = Graph(edges.n_vertices, src, dst, w, directed=False)
        del src, dst, w
        t = time.perf_counter()
        self.session = GraphSession.from_graph(
            g, int(cfg["n_parts"]), cfg["partitioner"],
            cfg=EngineConfig(edge_backend=cfg["edge_backend"]),
            device=device)
        self.partition_s = time.perf_counter() - t
        self.query = query
        self.program = query.program(lanes)
        self.n_vertices = edges.n_vertices

    def call(self, keys):
        return self.session.query(self.program, self.query.params(keys))

    @staticmethod
    def counters(st):
        return (int(st.host_syncs), [int(x) for x in st.partition_sweeps],
                [int(x) for x in st.partition_edge_counts],
                int(st.supersteps))

    def answer(self, res) -> np.ndarray:
        out = self.session.pg.collect(res, fill=np.inf)
        return out.reshape(self.n_vertices, -1)

    def vertices_per_part(self) -> List[int]:
        return [int(x) for x in self.session.pg.vertices_per_part]

    def close(self):
        self.session.close()
        self.session = None


class Control:
    """The reference put in the program's place, short of the guarantee
    (``queries/<q>.py`` ``control``): what the check has to refuse."""

    partition_s = None

    def __init__(self, edges: EdgeList, query, name: str):
        self.edges, self.query, self.name = edges, query, name

    def call(self, keys):
        return self.query.control(self.edges, keys, self.name).cpu(), None

    @staticmethod
    def counters(st):
        return None, None, None, None

    def answer(self, res) -> np.ndarray:
        return res.numpy()

    def vertices_per_part(self):
        return None

    def close(self):
        self.edges = None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _window(system, it, seconds, traffic, seed, span):
    """The closed loop; returns the call records, the sample to check
    ``[(keys, raw result)]``, the calls attempted and failed, and the
    window's seconds."""
    k = int(traffic["check_calls"])
    rng = np.random.default_rng(subseed(seed, "check-sample"))
    recs: List[CallRecord] = []
    sample, slowest = [], None
    attempted = failed = 0
    t_start = t_end = time.perf_counter()
    for keys in it:
        if attempted and t_end - t_start >= seconds:
            break
        attempted += 1
        t0 = time.perf_counter()
        try:
            with span("gbench.call"):
                out, st = system.call(keys)
        except Exception:            # a failed call is counted, not fatal
            t_end = time.perf_counter()
            failed += 1
            traceback.print_exc()
            if failed >= MAX_FAILED:
                break
            continue
        t_end = time.perf_counter()
        lat = t_end - t0
        recs.append(CallRecord(lat, len(keys), *system.counters(st)))
        item = (keys, out)
        if len(sample) < k:
            sample.append(item)
        else:
            j = int(rng.integers(0, len(recs)))
            if j < k:
                sample[j] = item
        if slowest is None or lat > slowest[0]:
            slowest = (lat, item)
    if slowest is not None and all(s is not slowest[1] for s in sample):
        sample.append(slowest[1])
    return recs, sample, attempted, failed, t_end - t_start


def _check(query, edges: EdgeList, answers) -> dict:
    """Each compared number beside its limit (``query.LIMITS``)."""
    mism = 0
    if answers:
        keys = np.concatenate([k for k, _ in answers])
        ref = query.reference(edges, keys).cpu().numpy()
        col = 0
        for k, ans in answers:
            mism += int(np.count_nonzero(ans != ref[:, col:col + len(k)]))
            col += len(k)
    return {"mismatched_values": {"value": mism,
                                  "limit": query.LIMITS["mismatched_values"]}}


def is_correct(checks: dict, failed: int, compared: int) -> bool:
    """Every call returned, some were compared, every number within its
    limit."""
    return bool(failed == 0 and compared > 0
                and all(c["value"] <= c["limit"] for c in checks.values()))


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def measure(workload: str, seed: int, seconds: float, trace: bool, *,
            device="cuda", t0: Optional[float] = None,
            control: Optional[str] = None, cfg_override: Optional[dict] = None,
            man: Optional[dict] = None):
    """One run of ``workload``. Returns ``(run, checks, attempted,
    failed, compared_calls)``. ``control`` puts that control in the
    program's place; ``cfg_override`` replaces configuration keys (the
    tests' small sizes)."""
    t0 = time.perf_counter() if t0 is None else t0
    start_s = time.perf_counter() - t0
    man = mf.load_manifest() if man is None else man
    cell = mf.cell(man, workload)
    cfg = dict(mf.config(man, cell["config"]), **(cfg_override or {}))
    tr = mf.traffic(cell["traffic"])
    query = mf.query(tr["query"])
    lanes = int(tr["lanes_per_call"])
    cuda = torch.device(device).type == "cuda"

    t = time.perf_counter()
    edges = mf.generator(cfg["generator"]).generate(
        cfg, int(cfg.get("graph_seed", seed)), device)
    keys = key_sequence(edges, tr, seed)
    n_touched = int((edges.degrees() > 0).sum())
    warm, it = calls(keys, tr)
    _sync(device)
    graph_s = time.perf_counter() - t
    t = time.perf_counter()
    if control is None:
        host_edges = EdgeList(edges.n_vertices, *(x.cpu() for x in
                                                  (edges.src, edges.dst,
                                                   edges.w)))
        edges = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        system = Port(host_edges, cfg, query, lanes, device)
    else:
        system = Control(edges, query, control)
    handoff_s = time.perf_counter() - t - (system.partition_s or 0.0)
    t = time.perf_counter()
    system.call(warm)
    _sync(device)
    warmup_s = time.perf_counter() - t
    setup = dict(setup_s=time.perf_counter() - t0, start_s=start_s,
                 graph_s=graph_s, handoff_s=handoff_s,
                 partition_s=system.partition_s, warmup_s=warmup_s,
                 setup_cpu_s=time.process_time())

    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    span = torch.profiler.record_function if trace \
        else (lambda name: contextlib.nullcontext())
    with profiled(trace) as read_trace:
        with span(WINDOW_SPAN):
            recs, sample, attempted, failed, window_s = _window(
                system, it, seconds, tr, seed, span)
        _sync(device)
    t = time.perf_counter()
    summary = read_trace()
    setup["trace_read_s"] = time.perf_counter() - t if trace else None
    peak_bytes = int(torch.cuda.max_memory_allocated()) if cuda else 0

    answers = [(k, system.answer(out)) for k, out in sample]
    vpp = system.vertices_per_part()
    system.close()
    del system, sample
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if edges is None:
        edges = EdgeList(host_edges.n_vertices,
                         *(x.to(device) for x in (host_edges.src,
                                                  host_edges.dst,
                                                  host_edges.w)))
    t = time.perf_counter()
    checks = _check(query, edges, answers)
    setup["check_s"] = time.perf_counter() - t
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = Run(workload=cell, config=cfg, traffic=tr, lanes=lanes,
              weighted=bool(query.WEIGHTED), n_vertices=edges.n_vertices,
              n_touched=n_touched,
              n_undirected=edges.n_undirected, calls=recs,
              window_s=window_s, setup=setup, vertices_per_part=vpp,
              memory_peak_bytes=peak_bytes, device_kind=kind,
              peak=mf.peaks().get(kind), trace=summary)
    return run, checks, attempted, failed, len(answers)
