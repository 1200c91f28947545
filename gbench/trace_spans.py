"""Run one cell once, traced, and read the program's own spans.

    python3 gbench/trace_spans.py --workload <name> --seed <n> \
        [--seconds <s>]

from the root of a checkout, on a machine with the card the cell asks
for. The run is ``run.py --trace 1``'s (``cell.measure``, its window capped
at ``cell.TRACE_SECONDS``), with the trace read through ``harness/spans.py``
and the session's set-up clocks (``SessionStats.setup_seconds``) copied
into the run's set-up as ``<key>_s``. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's per-layer metrics and ``SPAN_METRICS``), ``device``, ``setup``,
``spans`` (each span's count and seconds), ``idle_by_span`` (idle seconds
by the innermost span over them) and ``breakdown`` (as ``run.py`` gives
it). Exit codes: 0 with a result; 2 without the card; 1 on any other
failure.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: per-layer metrics that read the program's spans or set-up clocks
SPAN_METRICS = {
    "session.host_ms": "ms/query", "session.fetch_ms": "ms/query",
    "engine.sync_wait_ms": "ms/query", "sweep.host_us": "us/sweep",
    "device_idle.session_pct": "%", "device_idle.engine_pct": "%",
    "setup.route_s": "s", "setup.layouts_s": "s",
}


def traced_run(workload, seed, seconds, *, device="cuda", t0=None,
               cfg_override=None):
    """``cell.measure(..., trace=True)`` with the spans read; returns what
    ``measure`` does."""
    from gbench.harness import cell, spans

    clocks = {}

    class Port(cell.Port):
        def close(self):
            clocks.update(self.session.stats.setup_seconds)
            super().close()

    saved = cell.Port, cell.profiled
    cell.Port, cell.profiled = Port, spans.profiled
    try:
        out = cell.measure(workload, seed, seconds, True, device=device,
                           t0=t0, cfg_override=cfg_override)
    finally:
        cell.Port, cell.profiled = saved
    out[0].setup.update({f"{k}_s": v for k, v in clocks.items()})
    return out


def result_line(run, checks, attempted, failed, compared) -> dict:
    from gbench.harness import manifest as mf
    from gbench.harness import spans
    from gbench.harness.cell import is_correct
    man = mf.load_manifest()
    units = {m["name"]: m["unit"]
             for m in mf.metrics_of(man, run.workload["name"], "per_layer")}
    units.update(SPAN_METRICS)
    metrics = {}
    for name, unit in units.items():
        value = mf.metric_reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    t = run.trace
    names = sorted({n for n, _, _ in t.program_spans})
    return {
        "correct": is_correct(checks, failed, compared),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"kind": run.device_kind, "busy_s": t.busy_s,
                   "window_s": t.window_s},
        "setup": run.setup,
        "spans": {n: [spans.count(t, n), spans.total_s(t, n)]
                  for n in names},
        "idle_by_span": spans.idle_by_innermost(t),
        "breakdown": {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps},
        "checks": checks,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("gbench: no CUDA card", file=sys.stderr)
        return 2
    out = traced_run(args.workload, args.seed, args.seconds, t0=T0)
    line = result_line(*out)
    lat = [c.latency_s for c in out[0].calls]
    print(f"gbench: {args.workload} seed {args.seed}: {len(lat)} calls, "
          "latencies (s): " + " ".join(f"{x:.4f}" for x in lat),
          file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
