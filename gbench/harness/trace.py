"""The traced run: ``torch.profiler`` over the window, read back from its
Chrome trace.

The window is the span ``gbench.window`` that ``cell.py`` opens around the
measured calls. ``read_trace`` returns a ``TraceSummary``: the window's
length, the device's busy time (the union of its kernel, copy and set
spans inside the window), every device span, the device ops that took most
time, and the device's idle gaps named by what the host was doing (the
innermost host span or op on the window's thread at the middle of each
gap: one of the benchmark's own ``gbench.*`` spans, or an ``aten`` op or a
CUDA runtime call inside it), summed by name. The trace file is written
under ``TMPDIR`` and removed once read."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Iterable, List, Optional, Tuple

__all__ = ["WINDOW_SPAN", "DeviceSpan", "TraceSummary", "profiled",
           "read_trace", "summarize", "owned_seconds"]

WINDOW_SPAN = "gbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclasses.dataclass
class DeviceSpan:
    name: str
    cat: str
    start_us: float
    dur_us: float
    stream: object


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    spans: List[DeviceSpan]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler.profile`` over CPU and CUDA when ``enabled``; yields
    a function that reads the trace once the block has closed."""
    if not enabled:
        yield lambda: None
        return
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        yield lambda: _export_and_read(prof)


def _export_and_read(prof) -> Optional[TraceSummary]:
    tmp = tempfile.mkdtemp(prefix="gbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return read_trace(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def read_trace(path: str) -> Optional[TraceSummary]:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return summarize(events)


def summarize(events: Iterable[dict]) -> Optional[TraceSummary]:
    """The summary of Chrome-trace events; ``None`` without a window span."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w = win[0]
    ws, we = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    spans = sorted((DeviceSpan(e["name"], e["cat"], float(e["ts"]),
                               float(e["dur"]), e.get("tid"))
                    for e in events if e.get("cat") in DEVICE_CATS
                    and float(e["ts"]) < we
                    and float(e["ts"]) + float(e["dur"]) > ws),
                   key=lambda s: s.start_us)
    busy, gaps = _busy_and_gaps(spans, ws, we)
    by_op = defaultdict(float)
    for s in spans:
        by_op[s.name] += s.dur_us * 1e-6
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") in HOST_CATS
                   and e.get("pid") == w.get("pid")
                   and e.get("tid") == w.get("tid")),
                  key=lambda h: (h[0], -h[1]))
    by_host = defaultdict(float)
    for (gs, ge), name in zip(gaps, _innermost(host, gaps)):
        by_host[name] += (ge - gs) * 1e-6
    return TraceSummary(
        window_s=(we - ws) * 1e-6, busy_s=busy * 1e-6, spans=spans,
        device_ops=_top(by_op), idle_gaps=_top(by_host))


NAME_CHARS = 160


def _top(d) -> List[Tuple[str, float]]:
    """The ``TOP`` largest entries, each name cut to ``NAME_CHARS``."""
    return [(k[:NAME_CHARS], v)
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def _busy_and_gaps(spans, ws, we):
    """Busy microseconds of the union of ``spans`` clipped to ``[ws, we]``,
    and the idle gaps between them."""
    busy, gaps, end = 0.0, [], ws
    for s in spans:
        a, b = max(s.start_us, ws), min(s.start_us + s.dur_us, we)
        if b <= end:
            continue
        if a > end:
            gaps.append((end, a))
        busy += b - max(a, end)
        end = b
    if end < we:
        gaps.append((end, we))
    return busy, gaps


def _innermost(host, gaps) -> List[str]:
    """For each gap (ascending), the name of the innermost host event that
    covers its middle: ``host`` is sorted by start, longer first, and
    nests on one thread."""
    names, stack, i = [], [], 0
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        names.append(stack[-1][2] if stack else "(no host span)")
    return names


def owned_seconds(trace: TraceSummary, kernels: Tuple[str, ...],
                  helpers: Tuple[str, ...] = ("combine_partials_kernel",)
                  ) -> float:
    """Device seconds of the kernels whose names contain one of
    ``kernels``, with each helper kernel (the shared second pass of
    ``csrc/chunked.cuh``) counted for the kernel that ran last before it
    on its stream."""
    last_owner = {}
    total = 0.0
    for s in trace.spans:
        if s.cat != "kernel":
            continue
        if any(h in s.name for h in helpers):
            owner = last_owner.get(s.stream, "")
        else:
            owner = s.name
            last_owner[s.stream] = owner
        if any(k in owner for k in kernels):
            total += s.dur_us * 1e-6
    return total


