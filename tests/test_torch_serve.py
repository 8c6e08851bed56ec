"""The port's serving path against the reference's: the same float32
params and prompts give the same greedy tokens, with KV paging over xdma
(fused install on and off, overlap on and off) and without paging."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

N_REQ, MAX_NEW, SLOTS, MAX_LEN = 6, 8, 4, 64


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(1))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(7)
    # staggered lengths: slots finish and refill at different steps
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(5, 20, size=N_REQ)]
    return cfg, pcfg, params, pparams, prompts


def _run(engine, request_cls, prompts):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_new=MAX_NEW))
    assert engine.run_until_drained() == 0
    if engine.pager is not None:
        engine.pager.close()
    return {r.rid: list(r.out_tokens) for r in engine.done}


@pytest.fixture(scope="module")
def reference_outputs(setup):
    cfg, _, params, _, prompts = setup
    return _run(RefEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                          access_path="xdma"), RefRequest, prompts)


def _port(setup, **kw):
    _, pcfg, _, pparams, prompts = setup
    eng = ServeEngine(pcfg, pparams, batch_slots=SLOTS, max_len=MAX_LEN,
                      device="cpu", **kw)
    return eng, _run(eng, Request, prompts)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("overlap", [True, False])
def test_paged_outputs_match_reference(setup, reference_outputs, fused,
                                       overlap):
    eng, outs = _port(setup, access_path="xdma", fused_install=fused,
                      overlap=overlap)
    assert outs == reference_outputs
    assert len(outs) == N_REQ and all(len(v) == MAX_NEW
                                      for v in outs.values())
    if fused:
        assert (eng.install_fused, eng.install_fallback) == (N_REQ, 0)
    else:
        assert (eng.install_fused, eng.install_fallback) == (0, N_REQ)


def test_paging_off_matches_paging_on(setup, reference_outputs):
    eng, outs = _port(setup)
    assert eng.pager is None
    assert outs == reference_outputs


def test_cli_returns_reference_result_keys():
    flags = ["--smoke", "--requests", "3", "--max-new", "4",
             "--kv-paging"]
    want = ref_serve.main(flags)
    got = port_serve.main(flags + ["--device", "cpu"])
    assert set(got) == set(want)
    assert set(got["install"]) == set(want["install"])
    assert set(got["latency"]) == set(want["latency"])
    assert got["requests"] == 3 and got["install"]["fused"] == 3
    assert all(len(v) == 4 for v in got["outputs"].values())
    plain = port_serve.main(flags[:-1] + ["--device", "cpu"])
    assert plain["outputs"] == got["outputs"]
