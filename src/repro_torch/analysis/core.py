"""drone-lint framework of the PyTorch port: findings, rule registry,
suppressions, baseline (the port's own copy of ``repro.analysis.core``,
standard library only).

A *rule* is a function ``(tree, src, path) -> Iterable[Finding]`` registered
with the :func:`rule` decorator under a ``DLnnn`` code. :func:`analyze_source`
runs every (selected) rule over one parsed module and filters findings that
an inline ``# drone-lint: disable=DLnnn`` comment suppresses — on the flagged
line itself or the line directly above it.

The *baseline* is a checked-in JSON multiset of finding fingerprints
``(rule, path, stripped source line text)`` — line numbers are deliberately
not part of the fingerprint so unrelated edits above a baselined finding do
not resurrect it. ``baseline_delta`` subtracts the baseline from a fresh run;
the gate fails only on the delta, so pre-existing findings never block a
change while every *new* one does. The file format is the reference's.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "Rule", "RULES", "rule",
    "analyze_source", "analyze_file", "analyze_paths",
    "load_baseline", "write_baseline", "baseline_delta",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: ``path:line:col  CODE severity  message``."""

    rule: str                 # "DL001"
    path: str                 # repo-relative (or as passed) file path
    line: int                 # 1-based
    col: int                  # 0-based
    message: str
    severity: str = "error"   # "error" | "warning"
    line_text: str = ""       # stripped source line (fingerprint component)

    @property
    def fingerprint(self) -> Tuple[str, str, str]:
        """Line-number-free identity used by the baseline: the same finding
        survives unrelated edits elsewhere in the file."""
        return (self.rule, self.path, self.line_text)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule} [{self.severity}] {self.message}")


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    severity: str
    summary: str
    check: Callable[[ast.AST, str, str], Iterable[Finding]]


RULES: Dict[str, "Rule"] = {}


def rule(code: str, severity: str, summary: str):
    """Register a checker under ``code``; the checker yields findings with
    only (line, col, message) — the registry fills rule/severity/text."""
    def deco(fn):
        RULES[code] = Rule(code=code, severity=severity, summary=summary,
                           check=fn)
        return fn
    return deco


# ------------------------------------------------------------------ #
# suppressions
_DISABLE = re.compile(r"#\s*drone-lint:\s*disable=([\w,\s]+)")


def _suppressed_codes(src_lines: Sequence[str]) -> Dict[int, set]:
    """Map 1-based line number -> set of codes disabled on that line
    (``all`` disables every rule). A trailing comment covers its own line;
    a comment alone on a line also covers the line below it."""
    out: Dict[int, set] = {}
    for i, line in enumerate(src_lines, 1):
        m = _DISABLE.search(line)
        if not m:
            continue
        codes = {c.strip().upper() for c in m.group(1).split(",") if c.strip()}
        out.setdefault(i, set()).update(codes)
        if line.split("#", 1)[0].strip() == "":   # comment-only line
            out.setdefault(i + 1, set()).update(codes)
    return out


def _is_suppressed(f: Finding, supp: Dict[int, set]) -> bool:
    codes = supp.get(f.line, set())
    return "ALL" in codes or f.rule in codes


# ------------------------------------------------------------------ #
# drivers
def analyze_source(src: str, path: str,
                   select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the (selected) rules over one module's source text."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(rule="DL000", path=path, line=e.lineno or 1,
                        col=(e.offset or 1) - 1, severity="error",
                        message=f"syntax error: {e.msg}",
                        line_text=(e.text or "").strip())]
    lines = src.splitlines()
    supp = _suppressed_codes(lines)
    out: List[Finding] = []
    for code in sorted(RULES):
        if select and code not in select:
            continue
        r = RULES[code]
        for f in r.check(tree, src, path):
            text = lines[f.line - 1].strip() if 0 < f.line <= len(lines) \
                else ""
            f = dataclasses.replace(f, rule=code, severity=r.severity,
                                    path=path, line_text=text)
            if not _is_suppressed(f, supp):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def analyze_file(path: str,
                 select: Optional[Sequence[str]] = None,
                 relative_to: Optional[str] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    rel = os.path.relpath(path, relative_to) if relative_to else path
    return analyze_source(src, rel.replace(os.sep, "/"), select=select)


def analyze_paths(paths: Sequence[str],
                  select: Optional[Sequence[str]] = None,
                  relative_to: Optional[str] = None) -> List[Finding]:
    """Analyze files and/or directory trees (``*.py``, sorted, recursive)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files += [os.path.join(root, n) for n in sorted(names)
                          if n.endswith(".py")]
        else:
            files.append(p)
    out: List[Finding] = []
    for f in files:
        out += analyze_file(f, select=select, relative_to=relative_to)
    return out


# ------------------------------------------------------------------ #
# baseline
def load_baseline(path: str) -> Dict[Tuple[str, str, str], int]:
    """Baseline file -> fingerprint multiset (missing file = empty)."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    out: Dict[Tuple[str, str, str], int] = {}
    for entry in data.get("findings", []):
        key = (entry["rule"], entry["path"], entry.get("text", ""))
        out[key] = out.get(key, 0) + int(entry.get("count", 1))
    return out


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    counts: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
    entries = [{"rule": r, "path": p, "text": t, "count": c}
               for (r, p, t), c in sorted(counts.items())]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "findings": entries}, fh, indent=2,
                  sort_keys=True)
        fh.write("\n")


def baseline_delta(findings: Sequence[Finding],
                   baseline: Dict[Tuple[str, str, str], int]
                   ) -> List[Finding]:
    """Findings not absorbed by the baseline multiset (new ones)."""
    budget = dict(baseline)
    new: List[Finding] = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
        else:
            new.append(f)
    return new
