"""drone-lint for the PyTorch port: static cache-key, error-handling,
backend-resolution and kernel-contract checks over the port's own source.

A standard-library ``ast`` pass (``repro_torch.analysis.core`` +
``repro_torch.analysis.rules``), the port's copy of ``repro.analysis``:

  DL002  unhashable/mutable fields on cache-key dataclasses
  DL005  CUDA kernel wrappers without dtype guards / identity fills
  DL006  ``except Exception`` that swallows errors silently
  DL007  raw ``cfg.edge_backend`` reads outside the resolution layer

DL001, DL003 and DL004 (closures, ``shard_map`` arity and branches inside
jax-traced functions) have no counterpart: eager PyTorch traces nothing.
Nor does the reference's runtime half, ``retrace_guard`` (and
``GraphSession(debug_sanitize=True)`` built on it), which turns jax's
tracing counter into an assertion: a PyTorch runner is never retraced.

Command line: ``python tools/drone_lint_torch.py src/repro_torch``.
"""
from repro_torch.analysis.core import (    # noqa: F401
    Finding,
    Rule,
    RULES,
    analyze_file,
    analyze_paths,
    analyze_source,
    baseline_delta,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis import rules as _rules  # noqa: F401 (registers)

__all__ = [
    "Finding", "Rule", "RULES",
    "analyze_file", "analyze_paths", "analyze_source",
    "baseline_delta", "load_baseline", "write_baseline",
]
