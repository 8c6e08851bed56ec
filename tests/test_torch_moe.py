"""The ported MoE FFN against the reference: global and grouped
dispatch, outputs and the balance loss, at the default capacity and at
one tight enough to drop assignments; float32 on both sides, 2e-5.  The
router logits are continuous draws, so no top-k tie decides an expert."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import moe as M  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402

TOL = 2e-5


def _cfgs(arch, dispatch, capacity_factor=None):
    out = []
    for get, red in ((get_config, reduce_for_smoke),
                     (port_config, port_reduce)):
        cfg = red(get(arch))
        moe = cfg.moe if capacity_factor is None else dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor)
        out.append(dataclasses.replace(cfg, dtype="float32", moe=moe,
                                       moe_dispatch=dispatch))
    return out


def _params(cfg, seed=4):
    p = T.tree_init(M.moe_defs(cfg), cfg, jax.random.PRNGKey(seed))
    p = {k: np.asarray(v) for k, v in p.items()}
    if "wsg" in p:      # its init is zeros: a live shared-expert gate
        p["wsg"] = np.random.default_rng(seed).standard_normal(
            p["wsg"].shape).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _dropped(cfg, x, p):
    """Assignments past capacity, by the reference's routing."""
    m = cfg.moe
    B, S, D = x.shape
    logits = np.asarray(x).reshape(-1, D) @ np.asarray(p["router"])
    top = np.argsort(-logits, axis=-1)[:, :m.top_k]
    if cfg.moe_dispatch == "grouped":
        C = M._round8(int(S * m.top_k * m.capacity_factor / m.n_experts))
        counts = [np.bincount(t.reshape(-1), minlength=m.n_experts)
                  for t in top.reshape(B, S * m.top_k)]
    else:
        C = M._round8(int(B * S * m.top_k * m.capacity_factor /
                          m.n_experts))
        counts = [np.bincount(top.reshape(-1), minlength=m.n_experts)]
    return int(sum(np.maximum(c - C, 0).sum() for c in counts))


@pytest.mark.parametrize("capacity", [None, 0.25], ids=["default", "tight"])
@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_moe_apply_matches_reference(arch, dispatch, capacity):
    cfg, pcfg = _cfgs(arch, dispatch, capacity)
    jp, tp = _params(cfg)
    rng = np.random.default_rng(len(arch) + len(dispatch))
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    out_ref, aux_ref = M.moe_apply(cfg, jp, jnp.asarray(x))
    out_port, aux_port = PM.moe_apply(pcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(out_port.numpy(), np.asarray(out_ref),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux_port), float(aux_ref),
                               atol=TOL, rtol=TOL)
    assert aux_port.dtype == torch.float32 and aux_port.ndim == 0
    drops = _dropped(cfg, x, jp)
    assert (drops > 0) == (capacity is not None), drops


def test_capacity_rule_and_decode_never_drops():
    """``C = _round8(int(N*K*cf/E))`` as the reference; a decode step of
    B <= 8 tokens fits every expert (each takes at most B)."""
    for n in (1, 4, 8, 12, 256, 1000):
        for arch in ("qwen2-moe-a2.7b", "grok-1-314b"):
            cfg = port_config(arch)
            m = cfg.moe
            assert PM._capacity(cfg, n) == M._round8(
                int(n * m.top_k * m.capacity_factor / m.n_experts))
            if n <= 8:
                assert PM._capacity(cfg, n) >= n
