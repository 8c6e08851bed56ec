"""The port's examples against the reference's: the kernel tour's outputs
against the reference's kernels (interpret mode) on the same numpy
inputs, and the serving example's tokens on the same float32 params."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.launch.serve import Request as RefRequest  # noqa: E402
from repro.launch.serve import ServeEngine as RefEngine  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.examples import kernels, serve_requests  # noqa: E402

TOL = 2e-5


@pytest.mark.parametrize("seed", [0, 5])
def test_kernel_tour_matches_the_reference_kernels(seed, capsys):
    got = kernels.run("cpu", seed)
    assert "identity holds for 1/2/4" in capsys.readouterr().out
    x = {k: jnp.asarray(v) for k, v in kernels.inputs(seed).items()}
    want = ref_ops.flash_attention(x["q"], x["k"], x["v"], block_q=128,
                                   block_k=128, interpret=True)
    np.testing.assert_allclose(got["flash"].numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    for nb in (1, 2, 4):
        y = ref_ops.stream_copy(x["x"], block_rows=64, n_buffers=nb,
                                interpret=True)
        assert np.array_equal(np.asarray(y), kernels.inputs(seed)["x"])
    h = ref_ops.rg_lru_scan(x["a"], x["b"], block_t=32, block_w=256,
                            interpret=True)
    np.testing.assert_allclose(got["rg_lru"].numpy(), np.asarray(h),
                               rtol=TOL, atol=TOL)


def test_serve_example_gives_the_reference_tokens():
    cfg = dataclasses.replace(
        reduce_for_smoke(get_config("recurrentgemma-2b")), dtype="float32")
    pcfg = dataclasses.replace(
        port_reduce(port_config("recurrentgemma-2b")), dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    eng = RefEngine(cfg, params, batch_slots=4, max_len=96)
    rng = np.random.default_rng(0)
    for rid in range(10):
        eng.submit(RefRequest(rid=rid, prompt=rng.integers(
            0, cfg.vocab, 12).astype(np.int32), max_new=12))
    eng.run_until_drained()
    want = {r.rid: list(r.out_tokens) for r in eng.done}
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    got = serve_requests.serve(pcfg, pparams, "cpu")
    assert got == want
    assert len(got) == 10 and all(len(v) == 12 for v in got.values())


def test_serve_example_cli_runs_smoke_on_the_cpu():
    outs = serve_requests.main(["--smoke", "--device", "cpu"])
    assert sorted(outs) == list(range(10))
