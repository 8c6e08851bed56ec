"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, ShapeCfg, SHAPES,  # noqa: F401
                                reduce_for_smoke, shape_applicable)

ARCHS = (
    "qwen2-0.5b",
    "glm4-9b",
    "llama3-8b",
    "qwen2.5-14b",
    "rwkv6-1.6b",
    "qwen2-moe-a2.7b",
    "grok-1-314b",
    "recurrentgemma-2b",
    "qwen2-vl-7b",
    "musicgen-large",
)

_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "glm4-9b": "glm4_9b",
    "llama3-8b": "llama3_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "grok-1-314b": "grok1_314b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "musicgen-large": "musicgen_large",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
