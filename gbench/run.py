"""Run one cell of the benchmark once and print its result.

    python3 gbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compared, beside its limit. The same checks are the last lines of standard
error. Exit codes: 0 with a result; 2 without the cards the cell needs; 3
when the process holds JAX or the JAX package after the window; 1 on any
other failure.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _metrics(run, entries):
    from gbench.harness import manifest as mf
    out = {}
    for m in entries:
        value = mf.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from gbench.harness import manifest as mf
    from gbench.harness.cell import forbidden_modules, is_correct, measure

    man = mf.load_manifest()
    cell = mf.cell(man, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    run, checks, attempted, failed, compared = measure(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t0=T0, man=man)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = _metrics(run, mf.metrics_of(man, args.workload, kind))
    if not args.trace:
        missing = [m["name"] for m in mf.metrics_of(man, args.workload, kind)
                   if m["name"] not in metrics]
        if missing:
            raise RuntimeError(f"end-to-end metrics not measured: {missing}")
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": int(cell["chips"]),
              "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit_w": _power_limit_w()}
    line = {"correct": False, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if args.trace:
        if run.trace is None or run.trace.busy_s <= 0:
            raise RuntimeError("the profiler recorded no device time in the "
                               "window")
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    held = forbidden_modules()
    if held:
        print(f"gbench: the run holds JAX or the JAX package: {held}",
              file=sys.stderr)
        return 3
    line["correct"] = is_correct(checks, failed, compared)
    line["checks"] = checks
    print(json.dumps(line))
    sys.stdout.flush()
    lat = sorted(c.latency_s for c in run.calls)
    print(f"gbench: {args.workload} seed {args.seed}: {len(run.calls)} calls "
          f"in {run.window_s:.3f} s (latency min {lat[0]:.4f} median "
          f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s); "
          f"|V| {run.n_touched} |E| {run.n_undirected}; times "
          + " ".join(f"{k} {v:.3f}" for k, v in run.setup.items()
                     if v is not None)
          + f"; {compared} calls compared, correct={line['correct']}",
          file=sys.stderr)
    print("gbench: host peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
          " GiB; latencies (s) in order: "
          + " ".join(f"{x:.4f}" for x in (c.latency_s for c in run.calls)),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
