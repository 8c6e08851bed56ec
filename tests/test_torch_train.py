"""Training in the port against the reference: ``loss_fn`` and every
gradient leaf against ``jax.value_and_grad`` for every arch of ARCHS at
smoke size (the MoE balance loss included), the remat path, three
``make_train_step`` steps (params, moments, metrics), and
``launch.train.main`` (plain, resumed from a checkpoint, with the
host-offloaded optimizer) with the reference's weights swapped into both
CLIs.  Float32 on both sides.

Tolerances: losses 2e-5 (abs + rel).  A gradient leaf is held to
``GRAD_TOL`` of its largest entry: the worst measured over every arch
was 2.3e-4 (recurrentgemma-2b, whose recurrence compounds float32
rounding of sums taken in another order), 1.6e-4 for the MoE archs and
at most 1.1e-4 for the others.  Over three train steps (lr 1e-4, where
AdamW's first steps move every param by about lr) the grad norm is held
to ``NORM_TOL`` (worst measured 1.4e-3, recurrentgemma-2b's second
step), the params to ``PARAM_TOL`` absolute (worst 1.3e-4) and the
moments to ``MOMENT_TOL`` of each leaf's largest: the worst measured
was 1.7e-4 for qwen2-0.5b and grok-1-314b, and 1.8e-2 for
recurrentgemma-2b, whose gate gradients move with params that
near-zero gradients push one way or the other."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS, get_config, reduce_for_smoke  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.optim.adamw import AdamW as RefAdamW  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

TOL = 2e-5
GRAD_TOL = 5e-4
NORM_TOL = 2e-3
PARAM_TOL = 2e-4
MOMENT_TOL = {"qwen2-0.5b": 5e-4, "grok-1-314b": 5e-4,
              "recurrentgemma-2b": 3e-2}


def _pair(arch, seed=1, **extra):
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="float32", **extra)
    pcfg = dataclasses.replace(port_reduce(port_config(arch)),
                               dtype="float32", **extra)
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(seed))
    return cfg, pcfg, params, interop.tree_to_torch(
        jax.tree.map(np.asarray, params))


def _batch(cfg, B=2, S=32, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _grads_close(pgrads, grads):
    leaves = jax.tree.leaves(grads)
    pleaves = interop.tree_leaves(pgrads)
    assert len(leaves) == len(pleaves)
    for g, pg in zip(leaves, pleaves):
        g = np.asarray(g)
        err = np.max(np.abs(pg.numpy() - g)) / max(np.max(np.abs(g)), 1e-30)
        assert err <= GRAD_TOL, err
        assert float(pg.abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_reference(arch):
    cfg, pcfg, params, pparams = _pair(arch)
    batch, pbatch = _batch(cfg)
    (loss, parts), grads = jax.value_and_grad(
        lambda p: lm.loss_fn(cfg, p, batch), has_aux=True)(params)
    (ploss, pparts), pgrads = plm.value_and_grad(pcfg, pparams, pbatch)
    _close(ploss, loss)
    _close(pparts["ce"], parts["ce"])
    _close(pparts["aux"], parts["aux"])
    if cfg.moe is not None:
        assert float(pparts["aux"]) > 0     # the balance loss is summed in
    _grads_close(pgrads, grads)


def test_loss_mask_and_loss_fn_match_reference():
    cfg, pcfg, params, pparams = _pair("qwen2-0.5b")
    batch, pbatch = _batch(cfg, mask=True)
    (loss, _), grads = jax.value_and_grad(
        lambda p: lm.loss_fn(cfg, p, batch), has_aux=True)(params)
    ploss, _ = plm.loss_fn(pcfg, pparams, pbatch)
    _close(ploss.detach(), loss)
    _grads_close(plm.value_and_grad(pcfg, pparams, pbatch)[1], grads)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b",
                                  "qwen2-moe-a2.7b"])
def test_remat_block_gives_the_same_loss_and_grads(arch):
    """``remat="block"`` (each pattern group under
    ``torch.utils.checkpoint``, two groups a unit with ``remat_span``)
    changes no value: the same loss and gradients as without, bit for
    bit on the CPU, and the reference's under its ``jax.checkpoint``."""
    cfg, pcfg, params, pparams = _pair(arch, remat="block", remat_span=2)
    batch, pbatch = _batch(cfg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: lm.loss_fn(cfg, p, batch), has_aux=True)(params)
    (ploss, _), pgrads = plm.value_and_grad(pcfg, pparams, pbatch)
    (nloss, _), ngrads = plm.value_and_grad(
        dataclasses.replace(pcfg, remat="none"), pparams, pbatch)
    assert torch.equal(ploss, nloss)
    for a, b in zip(interop.tree_leaves(pgrads), interop.tree_leaves(ngrads)):
        assert torch.equal(a, b)
    _close(ploss, loss)
    _grads_close(pgrads, grads)


def test_remat_recomputes_the_kernels_forward(monkeypatch):
    """Under ``remat="block"`` the backward runs each group's flash and
    rg_lru forwards again: twice the forward calls of ``remat="none"``
    for the layers in groups (the hybrid's two tail layers once)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rg_lru as R
    calls = {"flash": 0, "scan": 0}
    real_fa, real_scan = FA.FlashAttention.forward, R.RgLruScan.forward

    def fa(ctx, *a):
        calls["flash"] += 1
        return real_fa(ctx, *a)

    def scan(ctx, *a):
        calls["scan"] += 1
        return real_scan(ctx, *a)
    monkeypatch.setattr(FA.FlashAttention, "forward", staticmethod(fa))
    monkeypatch.setattr(R.RgLruScan, "forward", staticmethod(scan))
    _, pcfg, _, pparams = _pair("recurrentgemma-2b")   # 6 layers: 2 groups
    _, pbatch = _batch(pcfg)
    seen = {}
    for remat in ("none", "block"):
        calls.update(flash=0, scan=0)
        plm.value_and_grad(dataclasses.replace(pcfg, remat=remat), pparams,
                           pbatch)
        seen[remat] = dict(calls)
    assert seen["none"] == {"flash": 2, "scan": 4}
    assert seen["block"] == {"flash": 4, "scan": 8}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "grok-1-314b",
                                  "recurrentgemma-2b"])
def test_three_train_steps_match_reference(arch):
    """Three steps of ``make_train_step`` from the same state: the params,
    the moments and the metrics (loss, ce, aux, grad_norm) agree."""
    cfg, pcfg, params, pparams = _pair(arch)
    opt = RefAdamW(lr=1e-4, warmup_steps=2, decay_steps=10)
    popt = AdamW(lr=1e-4, warmup_steps=2, decay_steps=10)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    pstate = {"params": pparams, "opt": popt.init(pparams),
              "step": torch.zeros((), dtype=torch.int32)}
    step = jax.jit(lm.make_train_step(cfg, opt, clip_norm=0.5))
    pstep = plm.make_train_step(pcfg, popt, clip_norm=0.5)
    for i in range(3):
        batch, pbatch = _batch(cfg, seed=i)
        state, m = step(state, batch)
        pstate, pm = pstep(pstate, pbatch)
        for k in ("loss", "ce", "aux"):
            _close(pm[k], m[k])
        _close(pm["grad_norm"], m["grad_norm"], NORM_TOL)
    assert int(pstate["step"]) == int(state["step"]) == 3
    for got, want in zip(interop.tree_leaves(pstate["params"]),
                         jax.tree.leaves(state["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=PARAM_TOL, rtol=0)
    for key in ("m", "v"):
        for got, want in zip(interop.tree_leaves(pstate["opt"][key]),
                             jax.tree.leaves(state["opt"][key])):
            want = np.asarray(want)
            err = np.max(np.abs(got.numpy() - want))
            assert err <= MOMENT_TOL[arch] * max(np.max(np.abs(want)),
                                                 1e-30), err


def test_train_step_leaves_its_input_state_as_it_was():
    _, pcfg, _, pparams = _pair("qwen2-0.5b")
    popt = AdamW(lr=1e-2)
    pstate = {"params": pparams, "opt": popt.init(pparams),
              "step": torch.zeros((), dtype=torch.int32)}
    before = [t.clone() for t in interop.tree_leaves(pstate)]
    _, pbatch = _batch(pcfg)
    new, _ = plm.make_train_step(pcfg, popt)(pstate, pbatch)
    for a, b in zip(before, interop.tree_leaves(pstate)):
        assert torch.equal(a, b)
    assert int(new["step"]) == 1
    assert not torch.equal(new["params"]["emb"], pparams["emb"])


# ---------------------------------------------------------------------------
# the CLI, with the reference's weights in both
# ---------------------------------------------------------------------------

@pytest.fixture
def swapped(monkeypatch):
    cfg, pcfg, params, pparams = _pair("qwen2-0.5b", seed=4)
    monkeypatch.setattr(ref_train, "reduce_for_smoke", lambda c: cfg)
    monkeypatch.setattr(ref_train.T, "tree_init",
                        lambda defs, c, key: params)
    monkeypatch.setattr(port_train, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_train.T, "tree_init",
                        lambda defs, c, seed, device: pparams)
    return ["--arch", "qwen2-0.5b", "--smoke", "--batch", "2", "--seq",
            "32", "--log-every", "100", "--lr", "1e-4"]


def _same_losses(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4,
                               rtol=1e-4)
    assert set(got) == set(want)
    assert got["failures"] == want["failures"] == 0


def test_cli_plain_losses_match_reference(swapped):
    flags = swapped + ["--steps", "6"]
    want = ref_train.main(flags)
    got = port_train.main(flags + ["--device", "cpu"])
    _same_losses(got, want)
    assert got["final_loss"] == got["losses"][-1]


def test_cli_resumed_losses_match_reference(swapped, tmp_path, capsys):
    """4 steps with a checkpoint every 2, then a second run resuming
    from step 4 for 2 more, in each package's own directory."""
    for pkg, main in (("ref", ref_train.main), ("port", port_train.main)):
        d = str(tmp_path / pkg)
        extra = [] if pkg == "ref" else ["--device", "cpu"]
        first = main(swapped + ["--steps", "4", "--ckpt-dir", d,
                                "--ckpt-every", "2"] + extra)
        second = main(swapped + ["--steps", "2", "--ckpt-dir", d] + extra)
        if pkg == "ref":
            want = (first, second)
        else:
            got = (first, second)
    out = capsys.readouterr().out
    assert out.count("[train] resumed from step 4") == 2
    for g, w in zip(got, want):
        _same_losses(g, w)


def test_cli_offloaded_losses_match_reference(swapped):
    flags = swapped + ["--steps", "4", "--offload-optimizer"]
    want = ref_train.main(flags)
    got = port_train.main(flags + ["--device", "cpu"])
    _same_losses(got, want)


def test_cli_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main(["--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# the e2e benchmark twin and the quickstart example
# ---------------------------------------------------------------------------

def test_e2e_step_rows_are_the_reference_rows(capsys, tmp_path,
                                             monkeypatch):
    from benchmarks import e2e_step as ref_bench
    from repro_torch.benchmarks import e2e_step as port_bench
    # no dry-run artifacts on either side (the port's dry run writes its
    # own folder; tests/test_torch_dryrun.py holds its roofline rows)
    monkeypatch.setattr(ref_bench, "ART", str(tmp_path / "ref"))
    monkeypatch.setattr(port_bench, "ART_DIR", str(tmp_path / "port"))
    ref_bench.run(quick=True)
    want = [l.split(",")[0] for l in capsys.readouterr().out.splitlines()
            if l.startswith(("e2e_", "roofline_"))]
    rows = port_bench.run(quick=True, device="cpu")
    got = [l.split(",")[0] for l in capsys.readouterr().out.splitlines()
           if l.startswith(("e2e_", "roofline_"))]
    assert got == want == ["e2e_train_step_qwen2-0.5b"]
    assert rows[0]["tok_per_s"] > 0


def test_quickstart_trains_and_restores_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    res = quickstart.main(["--device", "cpu"])
    assert "checkpoint roundtrip ok (restored step 40)" in \
        capsys.readouterr().out
    assert res["restored_step"] == 40
    assert res["losses"][-1] < res["losses"][0]


def test_run_lists_every_reference_module_in_order():
    from benchmarks import run as ref_run
    from repro_torch.benchmarks import run as port_run
    assert [n for n, _ in port_run.MODULES] == \
        [n for n, _ in ref_run.MODULES]
