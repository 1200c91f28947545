"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program. Top-level module names are
compared whole: ``repro_torch`` is the program, ``repro`` the JAX
package."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from gbench.harness.cell import FORBIDDEN
from gbench.tests.sizes import TRACE

GBENCH = Path(__file__).resolve().parents[1]
ROOT = GBENCH.parent
SOURCES = sorted(p for p in GBENCH.rglob("*.py") if "tests" not in p.parts)


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(GBENCH)))
def test_no_jax_in_sources(path):
    assert not set(_top_level_imports(path)) & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((GBENCH / "reference").glob("*.py")):
        assert set(_top_level_imports(path)) <= {"__future__", "warnings",
                                                 "typing", "torch"}, path


def test_names_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole small run on the CPU, in a fresh process: afterwards
    ``sys.modules`` holds nothing of JAX or the JAX package."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from gbench.harness.cell import measure, forbidden_modules\n"
        "measure('g500-s20.sssp', 5, 0.05, False, device='cpu',\n"
        f"        cfg_override={TRACE!r})\n"
        "held = forbidden_modules()\n"
        "assert 'repro_torch.session' in sys.modules\n"
        "print('HELD', held)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "HELD []" in out.stdout
