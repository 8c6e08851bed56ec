"""The FLOP and byte functions against numbers worked by hand, for both
configurations of BENCHMARK.json."""
import json
from pathlib import Path

import pytest

from perfbench import yardstick as Y

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def spec(name):
    return Y.model_spec(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_kv_bytes_a_token_and_page():
    vl, moe = spec("qwen2-vl-7b"), spec("qwen2-moe-a2.7b")
    # a token: 28 layers x K and V x 4 heads x 128 x 2 B = 57344;
    # 24 x 2 x 16 x 128 x 2 B = 196608
    # a page at max_len 8192 adds each layer's int32 length
    assert Y.page_bytes(vl, 8192) == 57344 * 8192 + 28 * 4 == 469762160
    assert Y.page_bytes(moe, 8192) == 196608 * 8192 + 24 * 4 == 1610612832
    assert Y.page_bytes(moe, 2560) == 196608 * 2560 + 96


def test_weights_counted_as_the_port_holds_them():
    # the port's ModelConfig.n_params for the same two configs
    assert Y.weight_count(spec("qwen2-vl-7b")) == 7615616512
    assert Y.weight_count(spec("qwen2-moe-a2.7b")) == 14004619264


def test_prefill_flops_by_hand_dense():
    s = spec("qwen2-vl-7b")
    P = 3072
    # per token per layer: qkv 2*3584*(28+8)*128, o 2*3584*3584,
    # MLP 3 * 2 * 3584 * 18944
    proj = 2 * 3584 * 36 * 128 + 2 * 3584 * 3584
    mlp = 6 * 3584 * 18944
    assert proj == 58720256 and mlp == 407371776
    attn = 4 * 28 * 128 * (3072 * 3073 // 2)
    want = 28 * (P * (proj + mlp) + attn) + 2 * 3584 * 152064
    assert Y.prefill_flops(s, P) == want
    assert want == pytest.approx(4.198e13, rel=1e-3)


def test_prefill_flops_by_hand_moe_counts_top_k():
    s = spec("qwen2-moe-a2.7b")
    P = 1000
    proj = 2 * 2048 * 48 * 128 + 2 * 2048 * 2048
    router = 2 * 2048 * 60
    routed = 4 * 6 * 2048 * 1408             # top-4, not the capacity buffer
    shared = 6 * 2048 * 5632 + 2 * 2048
    attn = 4 * 16 * 128 * (1000 * 1001 // 2)
    want = 24 * (P * (proj + router + routed + shared) + attn) \
        + 2 * 2048 * 151936
    assert Y.prefill_flops(s, P) == want


def test_decode_flops_by_hand():
    s = spec("qwen2-vl-7b")
    rows = [100, 2000, 4096]
    tok = 28 * (2 * 3584 * 36 * 128 + 2 * 3584 * 3584
                + 6 * 3584 * 18944) + 2 * 3584 * 152064
    attn = 28 * 4 * 28 * 128 * sum(rows)
    assert Y.decode_flops(s, rows) == 3 * tok + attn
    assert Y.decode_flops(s, []) == 0


def test_flash_bound_compute_and_memory():
    s = spec("qwen2-moe-a2.7b")
    # long prompt: compute-bound, 4 H dh P(P+1)/2 at 989 TFLOP/s
    P = 4096
    flops = 4 * 16 * 128 * P * (P + 1) / 2
    assert Y.flash_bound_s(s, P) == pytest.approx(flops / 989e12)
    # one token: the bytes of q, k, v, o (2 * 1 * 128 * 32 * 2 B)
    assert Y.flash_bytes(s, 1) == 16384
    assert Y.flash_bound_s(s, 1) == pytest.approx(16384 / 3.35e12)


def test_install_bound():
    # the vl page's K and V at 8192 rows, without its 28 length words
    assert Y.install_bound_s(57344 * 8192, 3) == pytest.approx(
        2 * 469762048 * 3 / 3.35e12)
