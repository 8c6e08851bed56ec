"""The port's modeled HBM traffic against the reference's: integer
arithmetic over configs and resolved specs, equal in every (arch x shape
x mesh) cell that ``shape_applicable`` allows.  The one difference is
exact and known: a decode cell of rwkv6-1.6b, whose ``state_rw`` term
the reference charges for its dead ``mix.cm_x`` cache leaf and the port,
which has no such leaf, does not (ROADMAP C.3)."""
import pytest
from jax.sharding import AbstractMesh as RefMesh

torch = pytest.importorskip("torch")

from repro import sharding as RS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import traffic as RT  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, get_config,  # noqa: E402
                                 shape_applicable)
from repro_torch.launch import traffic as PT  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import ParamDef  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
CELLS = [(a, s, m) for a in ARCHS for s in SHAPES for m in MESHES
         if shape_applicable(get_config(a), SHAPES[s])[0]]


def _dead_leaf_bytes(cfg, shape, mesh) -> int:
    """What the reference's decode charges for ``mix.cm_x``: read and
    written, in every RWKV layer, at its local size."""
    if cfg.rwkv is None or shape.kind != "decode":
        return 0
    B = shape.global_batch
    d = ParamDef((B, cfg.d_model), ("batch", None))
    per = PT._tree_local_bytes({"cm_x": d}, cfg, mesh, S.SERVE_RULES)
    return 2 * cfg.n_layers * per


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_modeled_bytes_equal_the_reference(arch, shape, mesh):
    dims, axes = MESHES[mesh]
    pm, rm = S.AbstractMesh(dims, axes), RefMesh(dims, axes)
    cfg, sh = get_config(arch), SHAPES[shape]
    rules, rrules = ((S.TRAIN_RULES, RS.TRAIN_RULES) if sh.kind == "train"
                     else (S.SERVE_RULES, RS.SERVE_RULES))
    got = PT.modeled_bytes(cfg, sh, pm, rules, sh.kind)
    want = RT.modeled_bytes(ref_config(arch), REF_SHAPES[shape], rm,
                            rrules, sh.kind)
    dead = _dead_leaf_bytes(cfg, sh, pm)
    assert set(got) == set(want)
    for k in ("activations", "total"):
        got[k] += dead
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_local_bytes_equal_the_reference(arch, mesh):
    dims, axes = MESHES[mesh]
    pm, rm = S.AbstractMesh(dims, axes), RefMesh(dims, axes)
    for rules, rrules in ((S.TRAIN_RULES, RS.TRAIN_RULES),
                          (S.SERVE_RULES, RS.SERVE_RULES)):
        assert PT._tree_local_bytes(T.param_defs(get_config(arch)),
                                    get_config(arch), pm, rules) == \
            RT._tree_local_bytes(RTF.param_defs(ref_config(arch)),
                                 ref_config(arch), rm, rrules)


def test_shards_counts_joint_axes():
    pm = S.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert PT._shards((256, 64), ("batch", "d_ff"), pm,
                      S.TRAIN_RULES) == 512
    assert PT._shards((3, 5), ("batch", "d_ff"), pm, S.TRAIN_RULES) == 1
