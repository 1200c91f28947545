"""Readings for the limits of the correctness check, on the chip.

    python3 gbench/calibrate.py --workload <name> --seconds <s> \
        --control <name> --seeds <n> [<n> ...]

runs the cell's window with the control (``queries/<q>.py`` ``CONTROLS``:
the plain reference put in the program's place, below the precision or
short of the guarantee the configuration states) on each seed, in one
process, and prints one JSON line a seed with every compared number. The
program's own readings are the ``checks`` of the benchmark's runs
(``run.py``). The benchmark's runs never run this."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch
    from gbench.harness.cell import is_correct, measure
    if not torch.cuda.is_available():
        print("gbench calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        run, checks, attempted, failed, compared = measure(
            args.workload, seed, args.seconds, False, device="cuda",
            control=args.control)
        print(json.dumps({
            "workload": args.workload, "control": args.control,
            "seed": seed, "calls": len(run.calls), "compared": compared,
            "failed": failed, "correct": is_correct(checks, failed, compared),
            "seconds": time.perf_counter() - t, "checks": checks}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
