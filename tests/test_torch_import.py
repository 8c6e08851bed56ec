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
# import roots the port never names: jax, and the reference package with
# its top-level benchmarks and examples
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro", "benchmarks",
             "examples")
BENCH_MODULES = ("completion_modes", "contention", "host_device_bw",
                 "rdma_analogue", "far_memory", "overlap", "install_path",
                 "fabric", "chaos", "run")
EXAMPLES = ("kernels", "serve_requests")


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_port_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert {"repro_torch.serving.engine", "repro_torch.kernels.rg_lru",
            "repro_torch.kernels.flash_attention",
            "repro_torch.models.rglru", "repro_torch.kernels.streamcopy",
            "repro_torch.kernels.ops", "repro_torch.quant",
            "repro_torch.rmem.codec", "repro_torch.benchmarks.common",
            "repro_torch.benchmarks.vmem_stream",
            "repro_torch.rmem.verbs", "repro_torch.rmem.node",
            "repro_torch.rmem.store", "repro_torch.core.queues",
            "repro_torch.core.descriptors", "repro_torch.access.selector",
            "repro_torch.access.adapters", "repro_torch.fabric",
            "repro_torch.fabric.placement", "repro_torch.fabric.manager",
            "repro_torch.fabric.sharded_path", "repro_torch.runtime",
            "repro_torch.runtime.fault", "repro_torch.obs.validate"} | {
        f"repro_torch.benchmarks.{m}" for m in BENCH_MODULES} | {
        f"repro_torch.examples.{m}" for m in EXAMPLES} <= set(mods)
    code = ("import sys, importlib\n"
            f"for m in {FORBIDDEN!r}:\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} and sys.modules[m]]\n"
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
           if r in FORBIDDEN}
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


@pytest.mark.parametrize("name", ["qdma", "verbs", "auto", "fabric"])
def test_new_paths_default_to_the_card(monkeypatch, name):
    """The access paths, queue engine and memory nodes default to cuda
    and raise without a card, as every entry point does."""
    from repro_torch.access import create_path
    from repro_torch.core import QueueEngine
    from repro_torch.rmem import MemoryNode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        create_path(name, n_pages=2, page_bytes=64)
    with pytest.raises(RuntimeError, match="CUDA device"):
        QueueEngine(n_channels=1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        MemoryNode("n", 64)


@pytest.mark.parametrize("name", [f"benchmarks.{m}" for m in BENCH_MODULES]
                         + [f"examples.{m}" for m in EXAMPLES])
def test_bench_and_example_entry_points_want_a_card(monkeypatch, name):
    """Every benchmark twin and example defaults to cuda and raises
    without a card; it never falls back to the CPU."""
    import importlib

    mod = importlib.import_module(f"repro_torch.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.main(["--quick"] if name.startswith("benchmarks") else [])
