"""Production mesh construction (functions, not module constants:
importing this module starts no process group and touches no device).

Twin of ``repro/launch/mesh.py``.  A ``DeviceMesh`` spans the ranks of
the default process group, one device a rank, so each function needs a
group of exactly that many ranks, started by the caller
(``torch.distributed.init_process_group``, one process a card; tests
and the dry run start PyTorch's fake group instead) and raises a clear
error without one.  Axis names and sizes without a group:
``repro_torch.sharding.AbstractMesh``.
"""
from __future__ import annotations

import math
from typing import Sequence


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_dev_mesh(n_data: int = 4, n_model: int = 2,
                  device_type: str = "cuda"):
    """Small mesh for subprocess tests (a group of n_data*n_model
    ranks)."""
    return _device_mesh((n_data, n_model), ("data", "model"), device_type)


def _device_mesh(shape: Sequence[int], axes: Sequence[str],
                 device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {tuple(shape)} mesh {tuple(axes)} needs a process group "
            f"of {n} ranks and none is initialised: call "
            f"torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"a {tuple(shape)} mesh {tuple(axes)} needs {n} ranks, the "
            f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
