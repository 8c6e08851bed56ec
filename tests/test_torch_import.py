"""The port stands alone: it imports without jax, names nothing of the
reference package, and never quietly runs on the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_port_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert "repro_torch.serving.engine" in mods
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro') and sys.modules[m]]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_name_no_reference_module():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = {f: r for f in files for r in _imported_roots(f)
           if r in ("repro", "jax", "jaxlib", "ml_dtypes")}
    assert not bad, bad


def test_default_device_raises_without_a_card(monkeypatch):
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServeEngine(reduce_for_smoke(get_config("qwen2-0.5b")), {})
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--smoke", "--requests", "1"])
    assert resolve_device("cpu").type == "cpu"
