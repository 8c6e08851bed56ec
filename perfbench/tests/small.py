"""A cell at a size a CPU test can hold: the port's smoke version of an
arch, its configuration file written from it, and a small closed loop."""
from __future__ import annotations

import copy
import dataclasses

from perfbench import harness, yardstick

E2E = (("ttft_p50_ms", "ms"), ("itl_p95_ms", "ms"),
       ("output_tok_s", "tokens/s"), ("setup_s", "s"))

MIX = {"clients": 4, "slots": 4, "max_len": 64, "pool": 8,
       "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                  "min": 8, "max": 48},
       "answer": {"dist": "uniform", "min": 6, "max": 12},
       "engine": {"access_path": "xdma", "fused_install": True,
                  "overlap": True, "kv_codec": "none",
                  "prefix_share": False},
       "trace_span": {"admissions": 2, "installs": 2, "decode_steps": 5},
       "check": {"min_tokens": 24, "max_requests": 4},
       "setup_answer_max": 12}


def config_file(cfg) -> dict:
    """The configuration file's keys for a port ``ModelConfig``."""
    a = cfg.attention
    j = {"hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
         "num_hidden_layers": cfg.n_layers, "num_attention_heads": a.n_heads,
         "num_key_value_heads": a.n_kv_heads, "head_dim": a.d_head,
         "vocab_size": cfg.vocab, "rms_norm_eps": cfg.norm_eps,
         "rope_theta": a.rope_theta,
         "tie_word_embeddings": cfg.tie_embeddings, "assumed": {}}
    if cfg.moe is not None:
        m = cfg.moe
        j.update(num_experts=m.n_experts, num_experts_per_tok=m.top_k,
                 moe_intermediate_size=m.d_expert,
                 shared_expert_intermediate_size=m.d_shared)
        j["assumed"]["moe_capacity_factor"] = m.capacity_factor
    return j


def port_cfg(arch: str, **changes):
    from repro_torch.configs import get_config, reduce_for_smoke
    cfg = reduce_for_smoke(get_config(arch))
    return dataclasses.replace(cfg, **changes) if changes else cfg


def cell(arch: str, limit: float = 0.3, error_limit: float = 0.05,
         mix=None, **changes):
    """(Cell, port config) of ``arch`` at smoke size."""
    cfg = port_cfg(arch, **changes)
    j = config_file(cfg)
    return harness.Cell(
        name=f"{arch}.small", chips=1, cfg=j, spec=yardstick.model_spec(j),
        mix=copy.deepcopy(mix or MIX),
        limits={"max_logit_gap": {"limit": limit},
                "mean_logit_error": {"limit": error_limit},
                "failed_requests": {"limit": 0}},
        end_to_end=[{"name": n, "unit": u} for n, u in E2E],
        per_layer=[]), cfg
