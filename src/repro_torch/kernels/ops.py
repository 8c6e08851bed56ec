"""Public facade of the port's kernels.

Twin of ``repro/kernels/ops.py``, without its ``interpret`` and ``mode``
arguments: the device of the tensors decides.  On CUDA tensors each
function launches its CUDA C++ kernel (or raises); on CPU tensors it runs
the plain PyTorch version beside it.  The plain versions are re-exported
under the reference's ``*_ref`` names.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import attention_chunked
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.page_install import (PageLayout,  # noqa: F401
                                              install_pages,
                                              install_pages_torch,
                                              install_slot, pack_page,
                                              pack_page_torch, page_layout)
from repro_torch.kernels.rg_lru import rg_lru_scan  # noqa: F401
from repro_torch.kernels.rg_lru import rg_lru_scan_torch
from repro_torch.kernels.streamcopy import stream_copy  # noqa: F401
from repro_torch.kernels.streamcopy import stream_copy_torch

# the plain versions, under the reference's oracle names
attention_ref = attention_chunked
stream_copy_ref = stream_copy_torch
rg_lru_scan_ref = rg_lru_scan_torch
pack_page_ref = pack_page_torch
install_pages_ref = install_pages_torch
