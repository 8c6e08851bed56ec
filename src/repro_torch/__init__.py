"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Laid out like ``repro`` so each module has a twin at the same relative
path.  The port imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``repro`` — and its entry points run on the card unless the
caller asks for ``device="cpu"``.

This slice serves the ``"attn"`` model family with KV paging over the
xdma access path; the page pack and page install kernels are CUDA C++
(``csrc/page_install.cu``).
"""
