"""drone-lint CLI for the PyTorch port: run the repro_torch.analysis rules
(DL002, DL005, DL006, DL007) over source trees.

    python tools/drone_lint_torch.py src/repro_torch     # gate on baseline
    python tools/drone_lint_torch.py --update-baseline src/repro_torch
    python tools/drone_lint_torch.py --no-baseline --select DL005 \
        src/repro_torch/kernels
    python tools/drone_lint_torch.py --list-rules

Exit status is 0 when no *new* findings exist (everything is either fixed,
suppressed inline, or absorbed by the checked-in baseline at
``tools/drone_lint_torch_baseline.json``), 1 otherwise, 2 on a usage error.
``--no-baseline`` is the strict mode: every finding fails. It imports
``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.analysis import (                      # noqa: E402
    RULES, analyze_paths, baseline_delta, load_baseline, write_baseline)

DEFAULT_BASELINE = os.path.join(ROOT, "tools",
                                "drone_lint_torch_baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="drone_lint_torch",
        description="AST cache-key / kernel-contract linter of the PyTorch "
        "port")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--select", action="append", default=None,
                    metavar="DLnnn", help="run only these rule codes "
                    "(repeatable or comma-separated)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON path (default: "
                    "tools/drone_lint_torch_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="strict mode: ignore the baseline, fail on every "
                    "finding")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to absorb current findings")
    ap.add_argument("--error-on-new", action="store_true",
                    help="exit 1 on new findings (this is already the "
                    "default; the flag documents intent)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in sorted(RULES):
            r = RULES[code]
            print(f"{code}  [{r.severity:7s}] {r.summary}")
        return 0

    select = None
    if args.select:
        select = [c.strip().upper() for chunk in args.select
                  for c in chunk.split(",") if c.strip()]
        unknown = [c for c in select if c not in RULES]
        if unknown:
            print(f"drone_lint_torch: unknown rule(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    paths = args.paths or [os.path.join(ROOT, "src", "repro_torch")]
    paths = [p if os.path.isabs(p) else os.path.join(ROOT, p)
             if not os.path.exists(p) else p for p in paths]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"drone_lint_torch: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2

    findings = analyze_paths(paths, select=select, relative_to=ROOT)

    if args.update_baseline:
        write_baseline(args.baseline, findings)
        print(f"drone_lint_torch: baseline updated with {len(findings)} "
              f"finding(s) -> {os.path.relpath(args.baseline, ROOT)}")
        return 0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    new = baseline_delta(findings, baseline)
    for f in new:
        print(f.render())
    absorbed = len(findings) - len(new)
    mode = "strict" if args.no_baseline else "baseline"
    print(f"drone_lint_torch [{mode}]: {len(findings)} finding(s), "
          f"{absorbed} baselined, {len(new)} new")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
