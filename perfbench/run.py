"""Run one cell of ``BENCHMARK.json`` once, from the checkout's root:

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It needs no prepared environment: it puts the checkout's ``src`` on the
path, keeps every kernel cache inside the checkout (the port builds its
CUDA sources into ``src/repro_torch/csrc/build``), and prints one JSON
line last on standard output (see ``perfbench/harness.py``).
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _process_age_s() -> float:
    """Seconds this process had run before ``T_START`` (Linux), so that
    the set-up time counts from the process's start."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


def _environment() -> None:
    cache = ROOT / "build" / "perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))


if __name__ == "__main__":
    age = _process_age_s()
    _environment()
    from perfbench import harness
    sys.exit(harness.main(t_process=T_START - age))
