"""The program's own spans in a traced run, beside the device's idle gaps.

The port marks its query path with ``drone.*`` spans
(``repro_torch.core.metrics.span``): ``torch.profiler`` records each as a
``user_annotation`` on the calling thread, on the clock of the kernels.
``summarize`` reads a Chrome trace into a ``SpanTrace``: the fields of
``trace.TraceSummary`` with the same values, and two more, the window's
idle gaps as intervals and the ``drone.*`` spans on the window's thread.
The helpers below total a span, take its self time, and lay the idle gaps
over a set of spans by interval overlap (not by a gap's middle, as
``TraceSummary.idle_gaps`` names them). ``profiled`` is
``trace.profiled`` with this summary. Times are the trace's microseconds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from gbench.harness import trace as tr

__all__ = ["PREFIX", "SpanTrace", "summarize", "profiled", "count",
           "total_s", "self_s", "idle_overlap_s", "idle_by_innermost",
           "spans_of"]

PREFIX = "drone."
OUTSIDE = "(outside drone.*)"

Interval = Tuple[float, float]


@dataclasses.dataclass
class SpanTrace(tr.TraceSummary):
    gaps_us: List[Interval]                         # idle, ascending
    program_spans: List[Tuple[str, float, float]]   # (name, start, end) us


def summarize(events: Iterable[dict]) -> Optional[SpanTrace]:
    """``trace.summarize`` plus the gaps and the program's spans; ``None``
    without a window span."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    base = tr.summarize(events)
    if base is None:
        return None
    w = next(e for e in events if e.get("name") == tr.WINDOW_SPAN
             and e.get("cat") == "user_annotation")
    ws, we = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    _, gaps = tr._busy_and_gaps(base.spans, ws, we)
    spans = sorted(((e["name"], float(e["ts"]),
                     float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(PREFIX)
                    and e.get("pid") == w.get("pid")
                    and e.get("tid") == w.get("tid")
                    and float(e["ts"]) < we
                    and float(e["ts"]) + float(e["dur"]) > ws),
                   key=lambda s: (s[1], -s[2]))
    return SpanTrace(**{f.name: getattr(base, f.name)
                        for f in dataclasses.fields(tr.TraceSummary)},
                     gaps_us=gaps, program_spans=spans)


@contextlib.contextmanager
def profiled(enabled: bool):
    """``trace.profiled``, read back as a ``SpanTrace``."""
    if not enabled:
        yield lambda: None
        return
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        yield lambda: _export_and_read(prof)


def _export_and_read(prof) -> Optional[SpanTrace]:
    tmp = tempfile.mkdtemp(prefix="gbench-spans-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return summarize(events)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- helpers
def _named(t: SpanTrace, names: Sequence[str]) -> List[Interval]:
    return [(a, b) for n, a, b in t.program_spans if n in names]


def _union(iv: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _intersect(x: List[Interval], y: List[Interval]) -> List[Interval]:
    """Overlap of two ascending lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(iv: Iterable[Interval]) -> float:
    return sum(b - a for a, b in iv)


def count(t: SpanTrace, name: str) -> int:
    return sum(1 for n, _, _ in t.program_spans if n == name)


def total_s(t: SpanTrace, name: str) -> float:
    """Summed duration of every ``name`` span, in seconds."""
    return _length(_named(t, (name,))) * 1e-6


def self_s(t: SpanTrace, name: str, children: Sequence[str]) -> float:
    """Summed duration of the ``name`` spans less the time the
    ``children`` spans inside them cover, in seconds."""
    outer = _union(_named(t, (name,)))
    inner = _intersect(_union(_named(t, children)), outer)
    return (_length(outer) - _length(inner)) * 1e-6


def idle_overlap_s(t: SpanTrace, inside: Sequence[str],
                   outside: Sequence[str] = ()) -> float:
    """Idle seconds that overlap a span named in ``inside`` and no span
    named in ``outside``."""
    idle = _intersect(_union(t.gaps_us), _union(_named(t, inside)))
    return (_length(idle)
            - _length(_intersect(idle, _union(_named(t, outside))))) * 1e-6


def idle_by_innermost(t: SpanTrace) -> Dict[str, float]:
    """Idle seconds by the innermost ``drone.*`` span over them (the
    spans nest on one thread), ``OUTSIDE`` where none is open."""
    marks = []
    for k, (n, a, b) in enumerate(t.program_spans):
        marks.append((a, 1, -b, k, n))
        marks.append((b, 0, 0.0, k, n))
    marks.sort()
    segs: List[Tuple[float, float, str]] = []
    stack: List[Tuple[int, str]] = []
    cur = None
    for x, opening, _, k, n in marks:
        if cur is not None and x > cur:
            segs.append((cur, x, stack[-1][1] if stack else OUTSIDE))
        cur = x
        if opening:
            stack.append((k, n))
        else:
            stack.remove((k, n))
    gaps = _union(t.gaps_us)
    out: Dict[str, float] = defaultdict(float)
    covered = 0.0
    i = 0
    for a, b, n in segs:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            d = min(b, gaps[j][1]) - max(a, gaps[j][0])
            if d > 0:
                out[n] += d * 1e-6
                covered += d
            j += 1
    rest = _length(gaps) - covered
    if rest > 0:
        out[OUTSIDE] += rest * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def spans_of(run) -> Optional[SpanTrace]:
    """The run's trace when it holds the program's spans, one
    ``drone.query`` span for each of the window's calls; else ``None``
    (an untraced run, or a trace read without the spans)."""
    t = run.trace
    if getattr(t, "program_spans", None) is None or not run.calls \
            or count(t, "drone.query") != len(run.calls):
        return None
    return t
