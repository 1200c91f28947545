"""BENCHMARK.json and every file it names parse, and keep to the shape the
benchmark's contract gives them."""
import json
import re
from pathlib import Path

import pytest

from gbench.harness import manifest as mf

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = mf.load_manifest(ROOT)
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "gbench/run.py"]
    assert MAN["paths"] == ["gbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"])
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"]
    assert all(NAME.match(k) for k in c["reduced"])
    gen = ROOT / "gbench" / "generators" / f"{cfg['generator']}.py"
    assert gen.is_file()
    for key in ("partitioner", "n_parts", "edge_backend"):
        assert key in cfg


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workloads_name_their_parts(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["name"].startswith(w["config"] + ".")
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert w["config"] in {c["name"] for c in MAN["configs"]}
    tr = mf.traffic(w["traffic"])
    q = mf.query(tr["query"])
    assert tr["keys_per_set"] % tr["lanes_per_call"] == 0
    assert set(q.LIMITS) == {"mismatched_values"}
    assert q.CONTROLS
    reported = mf.metrics_of(MAN, w["name"], "end_to_end")
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert mf.metrics_of(MAN, w["name"], "per_layer")


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metrics_have_readers_and_fields(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert callable(mf.metric_reader(m["name"]))
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        assert m["layer"] and "\n" not in m["layer"]


def test_names_are_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
