"""``BENCHMARK.json`` and the files it names, found by name under
``gbench/``: ``configs/<config>.json`` (through the manifest's ``file``),
``traffic/<mix>.json``, ``generators/<generator>.py``,
``queries/<query>.py`` and ``metrics/<metric>.py``."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

__all__ = ["GBENCH", "ROOT", "load_manifest", "cell", "config", "traffic",
           "metrics_of", "metric_reader", "generator", "query", "peaks"]

GBENCH = Path(__file__).resolve().parents[1]
ROOT = GBENCH.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(GBENCH / "traffic" / f"{_checked(name)}.json")


def peaks() -> dict:
    return _json(GBENCH / "peaks.json")["devices"]


def metrics_of(manifest: dict, workload: str, kind: str) -> list:
    """The ``kind`` (``end_to_end`` / ``per_layer``) metrics this cell
    reports: those without ``workloads`` and those that list it."""
    return [m for m in manifest[kind]
            if workload in m.get("workloads", [workload])]


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = GBENCH / "metrics" / f"{_checked(name)}.py"
    return _module(path, "gbench_metric_" + re.sub(r"\W", "_", name)).read


def generator(name: str) -> ModuleType:
    """``generators/<name>.py``: ``generate(cfg, seed, device)``."""
    return _module(GBENCH / "generators" / f"{_checked(name)}.py",
                   "gbench_generator_" + re.sub(r"\W", "_", name))


def query(name: str) -> ModuleType:
    """``queries/<name>.py``: the program's call and the reference."""
    return _module(GBENCH / "queries" / f"{_checked(name)}.py",
                   "gbench_query_" + re.sub(r"\W", "_", name))
