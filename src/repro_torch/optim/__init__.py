"""repro_torch.optim: AdamW and gradient compression.

Twin of ``repro/optim/``: ``adamw`` (``AdamW``, ``for_arch``) and
``compression`` (bf16 and int8 error-feedback codes for a gradient
reduction).
"""
