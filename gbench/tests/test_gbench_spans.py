"""The program's spans read from a hand-made Chrome trace, the readers that
use them against hand-counted values, and a small traced run on the CPU
through ``trace_spans.py``."""
import ast
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest

from gbench import trace_spans
from gbench.harness import manifest as mf
from gbench.harness import spans
from gbench.harness import trace as tr
from gbench.tests.sizes import TRACE
from repro_torch.core.metrics import SPANS

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _x(name, cat, ts, dur, pid=1, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


def _u(name, a, b, tid=1):
    return _x(name, "user_annotation", a, b - a, tid=tid)


def _dev(a, b, cat="kernel"):
    return _x("k", cat, a, b - a, pid=0, tid=7)


EVENTS = [
    _u("gbench.window", 0, 1000),
    # call 1
    _u("drone.query", 100, 500),
    _u("drone.session.prepare", 100, 150),
    _u("drone.engine.run", 150, 400),
    _u("drone.engine.superstep", 150, 380),
    _u("drone.engine.sweep", 160, 200),
    _u("drone.edge.product", 170, 190),
    _u("drone.engine.sync", 200, 230),
    _u("drone.engine.sweep", 230, 260),
    _u("drone.engine.sync", 260, 300),
    _u("drone.engine.sync", 380, 395),
    _u("drone.session.fetch", 400, 440),
    _u("drone.session.stats", 440, 460),
    _u("drone.session.remember", 460, 490),
    # call 2
    _u("drone.query", 600, 800),
    _u("drone.session.prepare", 600, 610),
    _u("drone.engine.run", 610, 700),
    _u("drone.engine.superstep", 610, 690),
    _u("drone.engine.sweep", 615, 640),
    _u("drone.engine.sync", 640, 660),
    _u("drone.engine.sync", 690, 700),
    _u("drone.session.fetch", 700, 760),
    # not the window's thread
    _u("drone.query", 0, 1000, tid=2),
    # device: busy 120-140, 165-210, 300-390, 410-430, 620-650, 700-740
    _dev(120, 140), _dev(165, 210), _dev(300, 390),
    _dev(410, 430, "gpu_memcpy"), _dev(620, 650),
    _dev(700, 740, "gpu_memcpy"),
    # record_function's device-row copy of a span is not device work
    _x("drone.query", "gpu_user_annotation", 0, 1000, pid=0, tid=7),
]


def _run(events=EVENTS, calls=2):
    return SimpleNamespace(trace=spans.summarize(events),
                           calls=[object()] * calls, setup={})


def _read(name, run):
    return mf.metric_reader(name)(run)


def test_summary_keeps_the_trace_readers_values():
    s, base = spans.summarize(EVENTS), tr.summarize(EVENTS)
    for f in dataclasses.fields(tr.TraceSummary):
        assert getattr(s, f.name) == getattr(base, f.name)
    assert s.busy_s == pytest.approx(245e-6)    # no gpu_user_annotation
    assert "gpu_user_annotation" not in tr.DEVICE_CATS
    assert s.gaps_us == [(0, 120), (140, 165), (210, 300), (390, 410),
                         (430, 620), (650, 700), (740, 1000)]
    assert len(s.program_spans) == 21
    assert spans.count(s, "drone.query") == 2


def test_readers_give_hand_counted_values():
    run = _run()
    assert _read("session.host_ms", run) == pytest.approx(0.080)
    assert _read("session.fetch_ms", run) == pytest.approx(0.050)
    assert _read("engine.sync_wait_ms", run) == pytest.approx(0.0575)
    assert _read("sweep.host_us", run) == pytest.approx(95 / 3)
    assert _read("device_idle.engine_pct", run) == pytest.approx(17.5)
    assert _read("device_idle.session_pct", run) == pytest.approx(18.0)
    # the rest of the idle share lies outside the calls: 0-100, 500-600,
    # 800-1000
    idle = _read("device_idle_pct", run)
    assert idle == pytest.approx(75.5)
    assert idle - _read("device_idle.engine_pct", run) \
        - _read("device_idle.session_pct", run) == pytest.approx(40.0)


def test_idle_by_innermost_span():
    by = spans.idle_by_innermost(spans.summarize(EVENTS))
    want = {spans.OUTSIDE: 400, "drone.session.prepare": 40,
            "drone.engine.superstep": 45, "drone.engine.sweep": 40,
            "drone.engine.sync": 85, "drone.engine.run": 5,
            "drone.session.fetch": 40, "drone.session.stats": 20,
            "drone.session.remember": 30, "drone.query": 50}
    assert by == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert sum(by.values()) == pytest.approx(755e-6)


def test_readers_are_silent_without_spans():
    base = SimpleNamespace(trace=tr.summarize(EVENTS), calls=[1, 2],
                           setup={})
    untraced = SimpleNamespace(trace=None, calls=[1, 2], setup={})
    for name in trace_spans.SPAN_METRICS:
        assert _read(name, base) is None
        assert _read(name, untraced) is None
    # a window whose spans do not match its calls reads nothing
    assert _read("session.fetch_ms", _run(calls=3)) is None


def test_setup_readers_read_the_programs_clocks():
    run = SimpleNamespace(trace=None, calls=[], setup=dict(route_s=1.5,
                                                          layouts_s=2.5))
    assert _read("setup.route_s", run) == 1.5
    assert _read("setup.layouts_s", run) == 2.5


def _span_names(path):
    tree = ast.parse(path.read_text())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.startswith(spans.PREFIX)}


def test_every_span_a_reader_uses_is_the_programs():
    used = set()
    for path in sorted(METRICS.glob("*.py")) + [
            Path(spans.__file__), Path(trace_spans.__file__)]:
        used |= _span_names(path)
    used.discard(spans.PREFIX)
    assert used and used <= set(SPANS)
    for name in trace_spans.SPAN_METRICS:
        assert (METRICS / f"{name}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  mf.load_manifest()["workloads"]])
def test_traced_run_on_the_cpu_reads_every_span_metric(cell):
    """A small traced run: every span metric is read, and the spans agree
    with the program's counters."""
    run, checks, attempted, failed, compared = trace_spans.traced_run(
        cell, 2**31 + 11, 0.2, device="cpu", cfg_override=TRACE)
    line = trace_spans.result_line(run, checks, attempted, failed, compared)
    assert line["correct"]
    assert set(trace_spans.SPAN_METRICS) <= set(line["metrics"])
    t = run.trace
    n = len(run.calls)
    syncs = sum(c.host_syncs for c in run.calls)
    assert spans.count(t, "drone.query") == n
    assert spans.count(t, "drone.engine.sync") == syncs - n
    steps = [c.supersteps for c in run.calls]
    assert min(steps) >= 1
    assert line["metrics"]["supersteps_per_query"]["value"] == \
        pytest.approx(sum(steps) / n)
    assert sum(line["idle_by_span"].values()) == pytest.approx(
        t.window_s - t.busy_s)
