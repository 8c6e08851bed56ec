"""Run a script as every rank of a gloo process group on the CPU, one
subprocess a rank, so that no process group is ever started in the test
process (pytest-xdist workers run other files' tests there too).

``run_ranks(code, world, tmp_path)`` runs ``PRELUDE + code`` in ``world``
processes that meet through a file store under ``tmp_path``, kills them
all past ``timeout``, and returns the JSON object that rank 0 prints as
its last line.  The script reads ``RANK`` and ``WORLD`` and ends with
``done()``.
"""
import json
import os
import subprocess
import sys
import time
import uuid

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

PRELUDE = r"""
import json, os
import torch
import torch.distributed as dist
dist.init_process_group(
    "gloo", init_method="file://" + os.environ["INIT_FILE"],
    rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
RANK, WORLD = dist.get_rank(), dist.get_world_size()


def done(out=None):
    dist.barrier()
    dist.destroy_process_group()
    if RANK == 0:
        print(json.dumps(out or {}))
"""


def run_ranks(code: str, world: int, tmp_path, *, env=None,
              timeout: float = 240) -> dict:
    tag = uuid.uuid4().hex
    script = os.path.join(str(tmp_path), f"ranks_{tag}.py")
    with open(script, "w") as f:
        f.write(PRELUDE + code)
    store = os.path.join(str(tmp_path), f"ranks_{tag}.store")
    base = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                INIT_FILE=store, WORLD_SIZE=str(world), **(env or {}))
    procs = [subprocess.Popen([sys.executable, script],
                              env=dict(base, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, err[-3000:]) for r, (p, (_, err))
           in enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not bad, bad[0]
    return json.loads(outs[0][0].strip().splitlines()[-1])
