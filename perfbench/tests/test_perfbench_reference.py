"""The plain reference against the port at small shapes on the CPU, in
float32: the port's prefill and its decode steps through the cache give
the reference's teacher-forced logits, for the dense model and for the
MoE with and without capacity drops.  And the control: the reference in
float8, put in the program's place, reads wider than the port in bf16
and is not correct by the harness's own comparison."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import harness, reference, weights
from perfbench.tests import small


def port_logits(cfg, params, prompt, toks, max_len=64):
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    pre, dec = lm.make_prefill_step(cfg), lm.make_decode_step(cfg)
    caches = T.init_cache(cfg, 1, max_len, "cpu")
    caches, lg = pre(params, {"tokens": torch.as_tensor(prompt)[None]},
                     caches)
    out, pos = [lg[0].float()], len(prompt)
    for t in toks[:-1]:
        caches, lg = dec(params, {
            "tokens": torch.tensor([[t]], dtype=torch.int32),
            "pos": torch.tensor([[pos]], dtype=torch.int32)}, caches)
        out.append(lg[0].float())
        pos += 1
    return torch.stack(out)


def _case(arch, cf=None):
    c, cfg = small.cell(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        c.spec["moe"]["cf"] = cf
    return c, dataclasses.replace(cfg, dtype="float32")


@pytest.mark.parametrize("arch,cf", [("qwen2-vl-7b", None),
                                     ("qwen2-moe-a2.7b", None),
                                     ("qwen2-moe-a2.7b", 0.5)])
def test_reference_follows_the_port(arch, cf):
    c, cfg = _case(arch, cf)
    p = weights.make(c.spec, 5, "cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, 40).astype(np.int32)
    toks = [int(t) for t in rng.integers(0, cfg.vocab, 8)]
    want = port_logits(cfg, p, prompt, toks)
    got = reference.logits(c.spec, p, [{"prompt": prompt, "tokens": toks}])
    assert got[0].shape == want.shape
    assert float((got[0] - want).abs().max()) < 1e-4


def test_capacity_drops_late_tokens_and_matters():
    # 40 tokens, 4 experts, top-2 at factor 0.5: C = 16 of 20 a expert
    assert reference.capacity(40, 2, 0.5, 4) == 16
    assert reference.capacity(8, 4, 1.25, 60) == 8
    assert reference.capacity(3072, 4, 1.25, 60) == 256
    top_e = torch.tensor([[0, 1]] * 20)
    keep = reference.capacity_keep(top_e, 4, 16)
    assert keep[:16].all() and not keep[16:].any()
    c, cfg = _case("qwen2-moe-a2.7b", 0.5)
    p = weights.make(c.spec, 5, "cpu", dtype=torch.float32)
    smp = [{"prompt": np.arange(40, dtype=np.int32) % cfg.vocab,
            "tokens": [1, 2, 3]}]
    dropped = reference.logits(c.spec, p, smp)[0]
    c.spec["moe"]["cf"] = 4.0
    kept = reference.logits(c.spec, p, smp)[0]
    assert float((dropped - kept).abs().max()) > 1e-3


def test_control_reads_wider_than_the_served_program():
    """The bf16 port serves greedy tokens; judged by the harness's own
    comparison (``harness.judge``, ``harness.is_correct``) they are
    correct.  The float8 control put in the program's place, its first
    token and its logit at each position of the same sequences, reads
    three times wider on both numbers and is not correct."""
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    c, cfg = small.cell("qwen2-vl-7b")
    c.mix["check"]["min_tokens"] = 100
    p = weights.make(c.spec, 11, "cpu")
    rng = np.random.default_rng(1)
    samples = []
    for _ in range(4):
        prompt = rng.integers(0, cfg.vocab, 32).astype(np.int32)
        pre, dec = lm.make_prefill_step(cfg), lm.make_decode_step(cfg)
        caches = T.init_cache(cfg, 1, 64, "cpu")
        caches, lg = pre(p, {"tokens": torch.as_tensor(prompt)[None]},
                         caches)
        toks, got = [int(lg[0].argmax())], [float(lg[0].max())]
        for pos in range(32, 56):
            caches, lg = dec(p, {
                "tokens": torch.tensor([[toks[-1]]], dtype=torch.int32),
                "pos": torch.tensor([[pos]], dtype=torch.int32)}, caches)
            toks.append(int(lg[0].argmax()))
            got.append(float(lg[0].max()))
        samples.append({"prompt": prompt, "tokens": toks, "logits": got})
    ref = reference.logits(c.spec, p, samples)
    program = harness.judge(c, ref, samples, 0)
    ctl = reference.control_samples(
        reference.logits(c.spec, p, samples, fp8=True), samples)
    control = harness.judge(c, ref, ctl, 0)
    assert harness.is_correct(program), program
    assert not harness.is_correct(control), control
    for k in ("max_logit_gap", "mean_logit_error"):
        assert control[k]["value"] > 3 * program[k]["value"], (k, program,
                                                               control)
    assert control["served_tokens_checked"]["value"] == 100
