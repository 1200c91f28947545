"""The port's spans (``repro_torch.core.metrics.span``) and set-up clocks
(``SessionStats.setup_seconds``) on the CPU: idle spans cost one shared
no-op context and change nothing; under ``torch.profiler`` one SSSP query
on ``pallas_windows`` opens spans that nest as the call does and agree with
``ExecutionStats``' counters."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import repro_torch.algos as TA
import repro_torch.graphgen as TG
from repro_torch.core import EngineConfig
from repro_torch.core.metrics import SPANS, span
from repro_torch.session import GraphSession

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
#: ExecutionStats fields read from the host's clock
CLOCKS = {"wall_time", "compile_time", "partition_sweep_time"}


@pytest.fixture(scope="module")
def session():
    return GraphSession.from_graph(
        TG.kronecker_graph(8, seed=3), 4, "cdbh", device="cpu",
        cfg=EngineConfig(edge_backend="pallas_windows"))


def _counters(st):
    return {k: v for k, v in dataclasses.asdict(st).items()
            if k not in CLOCKS}


def _drone_spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("drone.")]


def test_idle_span_is_one_shared_noop():
    a, b = span("drone.query"), span("drone.engine.sync")
    assert a is b
    with a as entered:
        assert entered is None
    assert len(set(SPANS)) == len(SPANS)
    assert all(n.startswith("drone.") for n in SPANS)


def test_every_span_in_the_sources_is_declared():
    used = set()
    for path in SRC.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "span" and node.args:
                used.add(node.args[0].value)
    assert used == set(SPANS)


def test_profiler_changes_no_result_or_counter(session):
    params = {"source": 7}
    res0, st0 = session.query(TA.SSSP(), params, warm=False)
    with profile(activities=[ProfilerActivity.CPU]):
        res1, st1 = session.query(TA.SSSP(), params, warm=False)
    res2, st2 = session.query(TA.SSSP(), params, warm=False)
    np.testing.assert_array_equal(res1, res0)
    np.testing.assert_array_equal(res2, res0)
    assert _counters(st1) == _counters(st0) == _counters(st2)


def test_spans_nest_and_match_the_counters(session):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, st = session.query(TA.SSSP(), {"source": 11}, warm=False)
    sp = _drone_spans(prof)
    n = {name: sum(1 for s in sp if s[0] == name) for name in SPANS}
    assert n["drone.query"] == n["drone.engine.run"] == 1
    for name in ("drone.session.prepare", "drone.session.fetch",
                 "drone.session.stats", "drone.session.remember"):
        assert n[name] == 1
    assert n["drone.engine.superstep"] == st.supersteps
    assert n["drone.engine.sync"] == st.host_syncs - 1
    assert n["drone.engine.sweep"] == n["drone.engine.sync"] - st.supersteps
    assert n["drone.edge.product"] == n["drone.engine.sweep"]
    (_, q0, q1), = [s for s in sp if s[0] == "drone.query"]
    (_, r0, r1), = [s for s in sp if s[0] == "drone.engine.run"]
    assert q0 <= r0 <= r1 <= q1
    for name, a, b in sp:
        if name.startswith("drone.engine.") and name != "drone.engine.run":
            assert r0 <= a <= b <= r1, name
        assert q0 <= a <= b <= q1, name


def test_setup_clocks():
    g = TG.kronecker_graph(7, seed=5)
    sess = GraphSession.from_graph(g, 2, "cdbh", device="cpu")
    assert set(sess.stats.setup_seconds) == {"route", "build"}
    sess.query(TA.SSSP(), {"source": 1})                 # coo: no layouts
    assert set(sess.stats.setup_seconds) == {"route", "build", "upload"}
    cfg = EngineConfig(edge_backend="pallas_windows")
    sess.query(TA.SSSP(), {"source": 1}, cfg=cfg, warm=False)
    first = sess.stats.setup_seconds["layouts"]
    assert all(v > 0 for v in sess.stats.setup_seconds.values())
    sess.query(TA.SSSP(), {"source": 2}, cfg=cfg, warm=False)
    assert sess.stats.setup_seconds["layouts"] == first  # nothing built
