"""The port's sharding rules against the reference's: ``resolve_spec``
over every param and cache def of every arch at the production and dev
meshes (the reference over ``jax.sharding.AbstractMesh``, the port over
its own ``AbstractMesh``), the divisibility property of
``tests/test_property.py``, ``batch_spec``, and the DTensor placements a
spec becomes.  Pure Python: no process group."""
import jax
import pytest
from jax.sharding import AbstractMesh as RefMesh

torch = pytest.importorskip("torch")

from repro import sharding as RS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import ParamDef  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return S.AbstractMesh(shape, axes), RefMesh(shape, axes)


def _ref_specs(defs, mesh, rules):
    """{key path: spec tuple} of the reference's defs."""
    pairs = jax.tree_util.tree_flatten_with_path(defs, is_leaf=RT._is_def)[0]
    return {tuple(k.key for k in path): tuple(
        RS.resolve_spec(d.shape, d.logical, mesh, rules))
        for path, d in pairs}


def _port_specs(defs, mesh, rules, path=()):
    if isinstance(defs, ParamDef):
        return {path: S.resolve_spec(defs.shape, defs.logical, mesh, rules)}
    out = {}
    for k, v in defs.items():
        out.update(_port_specs(v, mesh, rules, path + (k,)))
    return out


# the reference's dead RWKV cache leaf, absent from the port's tree (C.3)
DEAD = ("mix", "cm_x")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_of_every_def_equals_the_reference(arch, mesh):
    """Every param def under both rule tables and every cache def under
    the serve rules resolve to the reference's spec; the cache trees
    differ only by the reference's dead ``mix.cm_x``."""
    pm, rm = _meshes(mesh)
    cfg, rcfg = get_config(arch), ref_config(arch)
    for rules, rrules in ((S.TRAIN_RULES, RS.TRAIN_RULES),
                          (S.SERVE_RULES, RS.SERVE_RULES)):
        assert _port_specs(T.param_defs(cfg), pm, rules) == \
            _ref_specs(RT.param_defs(rcfg), rm, rrules)
    got = _port_specs(T.cache_defs(cfg, 128, 4096), pm, S.SERVE_RULES)
    want = _ref_specs(RT.cache_defs(rcfg, 128, 4096), rm, RS.SERVE_RULES)
    dead = {k for k in want if k[-2:] == DEAD}
    assert bool(dead) == (cfg.rwkv is not None)
    assert got == {k: v for k, v in want.items() if k not in dead}


def test_rule_tables_are_the_reference_tables():
    assert S.TRAIN_RULES == RS.TRAIN_RULES
    assert S.SERVE_RULES == RS.SERVE_RULES


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_equals_the_reference(mesh):
    pm, rm = _meshes(mesh)
    for rules, rrules in ((S.TRAIN_RULES, RS.TRAIN_RULES),
                          (S.SERVE_RULES, RS.SERVE_RULES)):
        assert S.batch_spec(pm, rules) == tuple(RS.batch_spec(rm, rrules))


def test_placements_of_single_and_joint_axes():
    """One mesh axis: Shard(dim) on its mesh dim.  A joint ("pod",
    "data") dim: Shard(dim) on both mesh dims, in the mesh's order;
    another order raises."""
    pm, _ = _meshes("2x16x16")
    spec = S.resolve_spec((256, 64, 32), ("batch", "d_ff", None), pm,
                          S.TRAIN_RULES)
    assert spec == (("pod", "data"), "model", None)
    assert S.placements(spec, pm) == (Shard(0), Shard(0), Shard(1))
    assert S.placements((None, "data"), pm) == (Replicate(), Shard(1),
                                                Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        S.placements((("data", "pod"),), pm)


def test_tree_shardings_and_specs_follow_the_tree():
    pm, _ = _meshes("4x2")
    cfg = get_config("qwen2-0.5b")
    defs = T.param_defs(cfg)
    ab, lg = T.tree_abstract(defs, cfg), T.tree_logical(defs)
    specs = S.tree_specs(ab, lg, pm, S.TRAIN_RULES)
    sh = S.tree_shardings(ab, lg, pm, S.TRAIN_RULES)
    assert specs["emb"] == ("model", "data")
    assert sh["emb"] == (pm, (Shard(1), Shard(0)))
    assert ab["emb"].device.type == "meta"
    with pytest.raises(ValueError, match="shaped"):
        S.tree_specs(ab, {"emb": lg["emb"]}, pm, S.TRAIN_RULES)


def test_constrain_without_a_ctx_is_the_identity():
    x = torch.ones(2, 3)
    assert S.constrain(x, ("batch", None), None) is x
    ctx = S.ShardCtx(S.AbstractMesh((4, 2), ("data", "model")),
                     S.TRAIN_RULES)
    with pytest.raises(TypeError, match="DTensor"):
        ctx.constrain(x, ("batch", None))


def test_mesh_axes_reads_an_abstract_mesh_and_refuses_others():
    assert S.mesh_axes(S.AbstractMesh((2, 3), ("a", "b"))) == {"a": 2,
                                                              "b": 3}
    with pytest.raises(TypeError):
        S.mesh_axes(object())
    with pytest.raises(ValueError):
        S.AbstractMesh((2,), ("a", "b"))


def test_resolve_spec_always_divides():
    """Any resolved sharding evenly divides the dim it shards, and the
    spec is the reference's (twin of tests/test_property.py; skips
    without hypothesis, as that file does)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(st.integers(1, 64), st.integers(1, 64), st.integers(1, 16))
    @settings(max_examples=60, deadline=None)
    def check(d1, d2, axis):
        _divides_and_matches(d1, d2, axis)
    check()


def _divides_and_matches(d1, d2, axis):
    pm = S.AbstractMesh((4, 4), ("data", "model"))
    spec = S.resolve_spec((d1 * axis, d2), ("d_ff", "d_model"), pm,
                          S.TRAIN_RULES)
    for dim, entry in zip((d1 * axis, d2), spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= pm.shape[a]
        assert dim % n == 0
    want = RS.resolve_spec((d1 * axis, d2), ("d_ff", "d_model"),
                           RefMesh((4, 4), ("data", "model")),
                           RS.TRAIN_RULES)
    assert spec == tuple(want)
