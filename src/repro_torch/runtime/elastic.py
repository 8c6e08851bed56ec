"""Elastic scaling: recompute data sharding + mesh on membership change.

Twin of ``repro/runtime/elastic.py`` (pure Python in both).
Checkpoints store global (unsharded) arrays, so a resize is:
  1. a coordinator notices dead workers (``Heartbeat``),
  2. ``plan_resize`` produces the new mesh shape + per-worker data shards,
  3. every survivor restores the latest checkpoint under the new mesh.

``plan_resize`` keeps the model axis intact when possible (TP degree is a
property of the compiled program) and shrinks the data axis; batch either
reshards (same global batch, more per-device) or scales (config policy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class ResizePlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    data_shards: Dict[int, int]       # worker -> shard_id
    num_shards: int
    per_shard_batch: int


def largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_resize(alive_workers: List[int], chips_per_worker: int,
                model_parallel: int, global_batch: int,
                keep_global_batch: bool = True) -> ResizePlan:
    n = len(alive_workers)
    if n == 0:
        raise ValueError("no alive workers")
    total_chips = n * chips_per_worker
    if total_chips % model_parallel:
        # can't keep TP degree: fall back to largest feasible power of two
        model_parallel = largest_pow2_leq(
            min(model_parallel, total_chips))
    data = total_chips // model_parallel
    # round data axis down to a divisor of the global batch
    while keep_global_batch and global_batch % data:
        data -= 1
    if data < 1:
        raise ValueError("cannot form data axis")
    shards = {w: i for i, w in enumerate(sorted(alive_workers))}
    per_shard = global_batch // n if not keep_global_batch else \
        global_batch // n + (global_batch % n > 0)
    return ResizePlan(mesh_shape=(data, model_parallel),
                      axis_names=("data", "model"),
                      data_shards=shards, num_shards=n,
                      per_shard_batch=max(1, per_shard))
