"""Neither the harness nor the reference imports JAX or the JAX package
``repro``, compared by whole top-level names (``repro_torch`` begins
with ``repro``), and the reference and the yardstick import nothing of
the program either."""
import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from perfbench import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
STANDALONE = ("reference.py", "yardstick.py", "traffic.py", "weights.py",
              "trace_reduce.py")


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [BENCH / n for n in STANDALONE]
                         + sorted((BENCH / "metrics").glob("*.py")),
                         ids=lambda p: p.name)
def test_yardstick_and_reference_import_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]


def test_a_run_process_loads_neither():
    """The harness, the reference and the port's serving path, imported
    in a fresh process, load no JAX and nothing of ``repro``."""
    code = ("import sys; import perfbench.harness, perfbench.reference; "
            "import repro_torch.serving.engine, repro_torch.configs; "
            "from perfbench import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
