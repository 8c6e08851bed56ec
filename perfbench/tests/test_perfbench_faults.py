"""A whole run at small shapes on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath: each fault
a serving cell can have must turn ``correct`` false.  One card holds
the cell, so there is no exchange between cards to leave out."""
import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import small

SEED = 2 ** 31 + 977


def state_unchanged(engine):
    """The decode step returns the cache as it found it."""
    from repro_torch.interop import tree_flatten
    step = engine.decode

    def decode(params, batch, caches):
        before = [t.clone() for t in tree_flatten(caches)[0]]
        caches, logits = step(params, batch, caches)
        for t, b in zip(tree_flatten(caches)[0], before):
            t.copy_(b)
        return caches, logits
    engine.decode = decode


def half_batch(engine):
    """Half of the batch left out, the other half's rows standing in
    for it: the second half on even steps, the first on odd ones."""
    step = engine.decode
    calls = [0]

    def decode(params, batch, caches):
        caches, logits = step(params, batch, caches)
        calls[0] += 1
        h = logits.shape[0] // 2
        logits = logits.clone()
        if calls[0] % 2:
            logits[:h] = logits[h:2 * h].clone()
        else:
            logits[h:2 * h] = logits[:h].clone()
        return caches, logits
    engine.decode = decode


def token_altered(engine):
    """Every fourth step, each slot's token altered where the step
    produces it: the next id after the greedy one."""
    step = engine.decode
    calls = [0]

    def decode(params, batch, caches):
        caches, logits = step(params, batch, caches)
        calls[0] += 1
        if calls[0] % 4:
            return caches, logits
        logits = logits.clone()
        rows = torch.arange(logits.shape[0])
        j = (logits.argmax(dim=1) + 1) % logits.shape[1]
        logits[rows, j] = logits.max(dim=1).values + 1
        return caches, logits
    engine.decode = decode


def page_altered(engine):
    """A spilled page's first K rows overwritten on their way to host
    memory, so that decode reads what prefill did not write."""
    write = engine.pager.write_page

    def write_page(page, value):
        value = np.array(value, copy=True)
        value[: value.size // 16] = 0x42
        return write(page, value)
    engine.pager.write_page = write_page


def run(arch, tamper=None):
    c, cfg = small.cell(arch)
    return harness.run_cell(c, SEED, 2.5, False, device="cpu",
                            port_cfg=cfg, tamper=tamper)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "qwen2-moe-a2.7b"])
def test_sound_run_is_correct(arch):
    line = run(arch)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {n for n, _ in small.E2E}


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered, page_altered],
                         ids=lambda f: f.__name__)
def test_fault_turns_correct_false(fault):
    torch.manual_seed(0)
    line = run("qwen2-vl-7b", fault)
    g = line["checks"]["max_logit_gap"]
    assert not line["correct"] and g["value"] > g["limit"], line["checks"]
