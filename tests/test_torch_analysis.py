"""drone-lint for the port (repro_torch.analysis, tools/drone_lint_torch.py).

DL002, DL006 and DL007 carry over as they are: the port's analyzer and the
JAX package's give identical findings (rule, line, col, message, severity,
line text) on each rule's true-positive, suppressed and clean fixtures, on
harder variants, and over both source trees. DL005 is rewritten for the
port's CUDA wrappers: torch fixtures, and mutations of temporary copies of
the two kernel modules (the dtype checks taken out of ``_check``, an
identity fill turned into a literal) that it must flag while the real tree
and the chunk plan's ``-1`` sentinel stay clean."""
import ast
import json
import os
import subprocess
import sys

import pytest

from repro.analysis import analyze_paths as ref_analyze_paths
from repro.analysis import analyze_source as ref_analyze_source
from repro_torch.analysis import (RULES, analyze_file, analyze_paths,
                                  analyze_source, baseline_delta,
                                  load_baseline, write_baseline)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARRIED = ("DL002", "DL006", "DL007")
KERNELS = os.path.join(ROOT, "src", "repro_torch", "kernels")
BASELINE = os.path.join(ROOT, "tools", "drone_lint_torch_baseline.json")
CLI = os.path.join(ROOT, "tools", "drone_lint_torch.py")

# --------------------------------------------------------------------------- #
# fixtures: (true positive, suppressed variant, clean variant)
# --------------------------------------------------------------------------- #
FIXTURES = {
    "DL002": dict(
        tp="""
import dataclasses
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    tags: list = dataclasses.field(default_factory=list)
""",
        suppressed="""
import dataclasses
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    tags: list = dataclasses.field(default_factory=list)  # drone-lint: disable=DL002
""",
        clean="""
import dataclasses
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    tags: tuple = ()
""",
    ),
    "DL005": dict(
        tp="""
import torch
def _launch(vals, out):
    fn(vals.data_ptr(), out.data_ptr())
def kernel_entry(vals):
    out = torch.full((8, 1), 0.0, dtype=vals.dtype)
    _launch(vals, out)
    return out
""",
        suppressed="""
import torch
def _launch(vals, out):
    fn(vals.data_ptr(), out.data_ptr())
# drone-lint: disable=DL005
def kernel_entry(vals):
    # drone-lint: disable=DL005
    out = torch.full((8, 1), 0.0, dtype=vals.dtype)
    _launch(vals, out)
    return out
""",
        clean="""
import torch
from repro_torch.kernels.ref import combine_identity, numpy_dtype
def _check(vals):
    if vals.dtype != torch.float32:
        raise ValueError(f"float32 only, got {vals.dtype}")
def _launch(vals, out):
    fn(vals.data_ptr(), out.data_ptr())
def kernel_entry(vals, combiner):
    _check(vals)
    ident = combine_identity(combiner, numpy_dtype(vals.dtype))
    out = torch.full((8, 1), ident.item(), dtype=vals.dtype)
    _launch(vals, out)
    return out
""",
    ),
    "DL006": dict(
        tp="""
def f():
    try:
        risky()
    except Exception:
        pass
""",
        suppressed="""
def f():
    try:
        risky()
    except Exception:  # drone-lint: disable=DL006
        pass
""",
        clean="""
import logging
log = logging.getLogger(__name__)
def f():
    try:
        risky()
    except (ValueError, KeyError) as e:
        log.debug("risky failed: %r", e)
""",
    ),
    "DL007": dict(
        tp="""
def dispatch(program, cfg):
    if cfg.edge_backend == "pallas_tiles":
        return "tiles"
    return "coo"
""",
        suppressed="""
def dispatch(program, cfg):
    if cfg.edge_backend == "pallas_tiles":  # drone-lint: disable=DL007
        return "tiles"
    return "coo"
""",
        clean="""
from repro_torch.core.engine import resolve_edge_backend

def resolve_partition_backends(program, cfg, pg):
    return (cfg.edge_backend,) * pg.n_parts   # resolver itself: exempt

def dispatch(program, cfg):
    eb = resolve_edge_backend(program, cfg)
    if eb == "pallas_tiles":
        return "tiles"
    return "coo"

def write_it(cfg, value):
    cfg.edge_backend = value                  # Store, not a read: exempt
""",
    ),
}

#: harder cases of the carried rules, for the finding-for-finding parity
VARIANTS = [
    """
import dataclasses
from typing import ClassVar, Dict, List
@dataclasses.dataclass
class ShapePolicy:
    sizes: List[int] = None
    names: ClassVar[list] = []
    table: Dict[str, int] = dataclasses.field(default_factory=dict)
@dataclasses.dataclass
class MyProgram(VertexProgram):
    hops: set = dataclasses.field(default_factory=lambda: {1})
    arr: "ndarray" = None
@dataclasses.dataclass(frozen=True)
class Key:
    a: tuple = ()
    b: int = dict()
    c: bytes = [1, 2]
@dataclasses.dataclass
class NotAKey:
    rows: list = dataclasses.field(default_factory=list)
""",
    """
import logging, warnings
def g():
    try:
        a()
    except:
        x = 1
    try:
        b()
    except (OSError, BaseException) as e:
        return None
    try:
        c()
    except Exception as e:
        print(e)
    try:
        d()
    except Exception:  # pragma: no cover
        pass
    try:
        e()
    except Exception:
        warnings.warn("e failed")
    try:
        f()
    except Exception:
        raise
""",
    """
class S:
    def run(self, config):
        key = (self.cfg.edge_backend, config.edge_backend)
        other = self.options.edge_backend
        def __post_init__(cfg):
            return cfg.edge_backend
        return lambda cfg: cfg.edge_backend
def normalize_edge_backend(program, cfg):
    def inner(c):
        return cfg.edge_backend
    return cfg.edge_backend
top = cfg.edge_backend
""",
]


def _tuples(findings):
    return [(f.rule, f.path, f.line, f.col, f.message, f.severity,
             f.line_text) for f in findings]


@pytest.mark.parametrize("code", sorted(FIXTURES))
def test_rule_true_positive(code):
    findings = analyze_source(FIXTURES[code]["tp"], "fixture.py")
    assert code in {f.rule for f in findings}, \
        f"{code} must fire on its true-positive fixture"


@pytest.mark.parametrize("code", sorted(FIXTURES))
def test_rule_suppressed(code):
    findings = analyze_source(FIXTURES[code]["suppressed"], "fixture.py")
    assert code not in {f.rule for f in findings}, \
        f"inline disable comment must silence {code}"


@pytest.mark.parametrize("code", sorted(FIXTURES))
def test_rule_clean(code):
    findings = analyze_source(FIXTURES[code]["clean"], "fixture.py")
    got = [f for f in findings if f.rule == code]
    assert not got, f"{code} false-positived on the clean fixture: {got}"


def test_rule_registry_is_the_ported_set():
    assert sorted(RULES) == ["DL002", "DL005", "DL006", "DL007"]
    assert {c: RULES[c].severity for c in RULES} == {
        "DL002": "error", "DL005": "error", "DL006": "warning",
        "DL007": "error"}


# --------------------------------------------------------------------------- #
# (a) the carried rules, finding for finding against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["tp", "suppressed", "clean"])
@pytest.mark.parametrize("code", CARRIED)
def test_carried_rule_matches_reference_on_fixtures(code, kind):
    src = FIXTURES[code][kind]
    want = _tuples(ref_analyze_source(src, "fixture.py", select=CARRIED))
    got = _tuples(analyze_source(src, "fixture.py", select=CARRIED))
    assert got == want
    if kind == "tp":
        assert want, f"the reference finds nothing in {code}'s fixture"


@pytest.mark.parametrize("i", range(len(VARIANTS)))
def test_carried_rules_match_reference_on_variants(i):
    want = _tuples(ref_analyze_source(VARIANTS[i], "variant.py",
                                      select=CARRIED))
    got = _tuples(analyze_source(VARIANTS[i], "variant.py", select=CARRIED))
    assert want and got == want


@pytest.mark.parametrize("tree", ["src/repro", "src/repro_torch", "tests",
                                  "examples", "chip_smoke.py"])
def test_carried_rules_match_reference_over_trees(tree):
    path = os.path.join(ROOT, tree)
    want = _tuples(ref_analyze_paths([path], select=CARRIED,
                                     relative_to=ROOT))
    got = _tuples(analyze_paths([path], select=CARRIED, relative_to=ROOT))
    assert got == want
    assert all(not os.path.isabs(t[1]) and "\\" not in t[1] for t in got)


# --------------------------------------------------------------------------- #
# (b) DL005 on the port's kernel wrappers, by mutation
# --------------------------------------------------------------------------- #
def _drop_dtype_checks(tree) -> int:
    """Take every ``if`` whose test reads ``.dtype`` out of ``_check``;
    returns how many went."""
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_check")
    removed = 0
    for node in ast.walk(fn):
        for field in ("body", "orelse"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            keep = [st for st in stmts if not (
                isinstance(st, ast.If) and any(
                    isinstance(a, ast.Attribute) and a.attr == "dtype"
                    for a in ast.walk(st.test)))]
            removed += len(stmts) - len(keep)
            setattr(node, field, keep or ([ast.Pass()] if field == "body"
                                          else []))
    return removed


def _kernel_source(name):
    with open(os.path.join(KERNELS, f"{name}.py"), encoding="utf-8") as fh:
        return fh.read()


def _dl005(tmp_path, name, src):
    path = tmp_path / f"{name}.py"
    path.write_text(src, encoding="utf-8")
    return analyze_file(str(path), select=["DL005"])


#: the public wrapper and the identity fill of each kernel module's plain
#: version (text that must appear exactly once)
_KERNEL_UNITS = {
    "bsp_spmv": ("bsp_spmv",
                 "out = torch.full((n_dst_tiles, TM, K), ident.item(),",
                 "out = torch.full((n_dst_tiles, TM, K), 0.0,"),
    "segment_combine": ("segment_combine_windowed",
                        "out = torch.full((n_windows * W, K), ident,",
                        "out = torch.full((n_windows * W, K), 0.0,"),
}


@pytest.mark.parametrize("name", sorted(_KERNEL_UNITS))
def test_dl005_flags_dtype_checks_removed(tmp_path, name):
    src = _kernel_source(name)
    tree = ast.parse(src)
    assert not _dl005(tmp_path, name, ast.unparse(tree)), \
        "the unparsed, unmutated module must be clean"
    assert _drop_dtype_checks(tree) >= 2
    mutated = ast.unparse(tree)
    found = _dl005(tmp_path, name, mutated)
    wrapper = _KERNEL_UNITS[name][0]
    assert [f.rule for f in found] == ["DL005"]
    assert f"kernel wrapper `{wrapper}`" in found[0].message
    assert "dtype guard" in found[0].message
    assert found[0].line_text.startswith(f"def {wrapper}(")


@pytest.mark.parametrize("name", sorted(_KERNEL_UNITS))
def test_dl005_flags_literal_fill(tmp_path, name):
    src = _kernel_source(name)
    _, fill, literal = _KERNEL_UNITS[name]
    assert src.count(fill) == 1
    found = _dl005(tmp_path, name, src.replace(fill, literal))
    assert len(found) == 1
    f = found[0]
    assert "numeric literal 0.0" in f.message
    assert f.line_text.startswith(literal.strip())
    assert f.line == 1 + src[:src.index(fill)].count("\n")


def test_dl005_real_kernels_and_chunk_plan_are_clean():
    found = analyze_paths([KERNELS], select=["DL005"], relative_to=ROOT)
    assert not found, "\n".join(f.render() for f in found)


def test_dl005_scope_excludes_the_chunk_sentinel(tmp_path):
    """``chunks.py``'s ``torch.full_like(slot, -1)`` is an index sentinel:
    clean as it is (no launcher in the module), and flagged once a launcher
    there reaches it, so its exemption is the rule's scope, not a blind
    spot."""
    with open(os.path.join(KERNELS, "chunks.py"), encoding="utf-8") as fh:
        src = fh.read()
    assert "torch.full_like(slot, -1)" in src
    assert not _dl005(tmp_path, "chunks", src)
    planted = src + """

def launch_plan(rows, n_rows, out):
    if rows.dtype != torch.int32:
        raise ValueError(rows.dtype)
    plan = build_chunk_plan(rows, n_rows, 4)
    fn(plan.chunk_ptr.data_ptr(), out.data_ptr())
"""
    found = _dl005(tmp_path, "chunks", planted)
    assert [f.line_text for f in found] == [
        "chunk_slot = torch.where(in_split, slot, torch.full_like(slot, -1))"]


@pytest.mark.parametrize("src,n", [
    # a public launcher must guard itself
    ("def launch(x):\n    fn(x.data_ptr())\n", 1),
    ("def launch(x):\n    assert x.dtype == torch.float32\n"
     "    fn(x.data_ptr())\n", 0),
    # an unreached private launcher is its own unit
    ("def _launch(x):\n    fn(x.data_ptr())\n", 1),
    # the guard may sit in a helper the wrapper calls directly ...
    ("def _g(x):\n    if x.dtype != 1:\n        raise TypeError\n"
     "def _l(x):\n    fn(x.data_ptr())\n"
     "def w(x):\n    _g(x)\n    _l(x)\n", 0),
    # ... not two calls away
    ("def _g(x):\n    if x.dtype != 1:\n        raise TypeError\n"
     "def _h(x):\n    _g(x)\n"
     "def _l(x):\n    fn(x.data_ptr())\n"
     "def w(x):\n    _h(x)\n    _l(x)\n", 1),
    # a dtype read in an if's body is not a guard
    ("def w(x):\n    if x is None:\n        d = x.dtype\n"
     "    fn(x.data_ptr())\n", 1),
    # every fill form, in a guarded unit
    ("import torch.nn.functional as F\n"
     "def w(x):\n    assert x.dtype == 1\n"
     "    a = torch.full((2,), -1)\n    b = torch.full_like(x, 3)\n"
     "    c = x.new_full((2,), fill_value=2.5)\n"
     "    d = F.pad(x, (0, 1), value=0)\n"
     "    e = F.pad(x, (0, 1), 'constant', 0)\n"
     "    m = torch.full((2,), False)\n"
     "    fn(x.data_ptr())\n", 5),
    # no launcher: nothing to check
    ("def w(x):\n    return torch.full((2,), 0.0)\n", 0),
])
def test_dl005_cases(src, n):
    found = analyze_source(src, "case.py", select=["DL005"])
    assert len(found) == n, [f.render() for f in found]


# --------------------------------------------------------------------------- #
# (c) the port's tree, (d) the CLI, (e) imports
# --------------------------------------------------------------------------- #
def test_src_repro_torch_has_zero_unbaselined_findings():
    findings = analyze_paths([os.path.join(ROOT, "src", "repro_torch")],
                             relative_to=ROOT)
    new = baseline_delta(findings, load_baseline(BASELINE))
    assert not new, "unbaselined drone-lint findings:\n" + "\n".join(
        f.render() for f in new)


def test_checked_in_baseline_is_empty():
    with open(BASELINE, encoding="utf-8") as fh:
        assert json.load(fh) == {"findings": [], "version": 1}


def test_baseline_roundtrip_and_delta(tmp_path):
    findings = analyze_source(FIXTURES["DL006"]["tp"], "mod.py")
    bl = tmp_path / "baseline.json"
    write_baseline(str(bl), findings)
    baseline = load_baseline(str(bl))
    assert baseline_delta(findings, baseline) == []
    shifted = analyze_source("\n\n\n" + FIXTURES["DL006"]["tp"], "mod.py")
    assert baseline_delta(shifted, baseline) == []
    assert len(baseline_delta(findings + findings, baseline)) == \
        len(findings)
    assert load_baseline(str(tmp_path / "missing.json")) == {}


def _cli(*args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, CLI, *args], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=120)


def test_cli_gate_strict_kernels_and_list_rules(tmp_path):
    out = _cli("src/repro_torch")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new" in out.stdout
    out = _cli("--no-baseline", "--select", "DL005", "src/repro_torch/kernels")
    assert out.returncode == 0, out.stdout + out.stderr
    planted = tmp_path / "planted.py"
    planted.write_text(FIXTURES["DL006"]["tp"], encoding="utf-8")
    out = _cli(str(planted))
    assert out.returncode == 1 and "DL006" in out.stdout, out.stdout
    out = _cli("--select", "DL001", str(planted))
    assert out.returncode == 2 and "unknown rule" in out.stderr
    out = _cli("--list-rules")
    assert out.returncode == 0
    listed = [ln.split()[0] for ln in out.stdout.splitlines() if ln.strip()]
    assert listed == ["DL002", "DL005", "DL006", "DL007"]


def test_cli_update_baseline_absorbs_then_gates(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text(FIXTURES["DL007"]["tp"], encoding="utf-8")
    bl = tmp_path / "bl.json"
    assert _cli("--baseline", str(bl), "--update-baseline",
                str(planted)).returncode == 0
    assert _cli("--baseline", str(bl), str(planted)).returncode == 0
    assert _cli("--baseline", str(bl), "--no-baseline",
                str(planted)).returncode == 1


def test_analysis_and_cli_import_neither_jax_nor_repro():
    code = (
        "import runpy, sys\n"
        "import repro_torch.analysis\n"
        f"mod = runpy.run_path({CLI!r})\n"
        "assert mod['main'](['--list-rules']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout
