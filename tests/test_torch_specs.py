"""The port's abstract cells against the reference's: ``train_specs`` and
``serve_specs`` give the same leaves, shapes, dtypes and resolved specs
for every (arch x shape) cell that ``shape_applicable`` allows, on both
production meshes (the reference over ``jax.sharding.AbstractMesh``);
``AdamW.init_abstract`` and ``transformer.tree_abstract`` allocate
nothing.  The port's RWKV cache tree lacks only the reference's dead
``mix.cm_x`` leaf (ROADMAP C.3)."""
import jax
import pytest
from jax.sharding import AbstractMesh as RefMesh

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim.adamw import AdamW as RefAdamW  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, get_config,  # noqa: E402
                                 shape_applicable)
from repro_torch.interop import dtype_name  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.sharding import AbstractMesh, placements  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s, m) for a in ARCHS for s in SHAPES for m in MESHES
         if shape_applicable(get_config(a), SHAPES[s])[0]]
DEAD = ("mix", "cm_x")


def _ref_leaves(tree, shard_tree):
    """{path: (shape, dtype name, spec)} of the reference's trees."""
    ab = jax.tree_util.tree_flatten_with_path(tree)[0]
    sh = jax.tree.leaves(shard_tree)
    return {tuple(k.key for k in p): (tuple(x.shape), str(x.dtype),
                                      tuple(s.spec))
            for (p, x), s in zip(ab, sh)}


def _port_leaves(tree, specs, shards, mesh, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_port_leaves(tree[k], specs[k], shards[k], mesh,
                                    path + (k,)))
        return out
    assert tree.device.type == "meta"
    assert shards == (mesh, placements(specs, mesh))
    return {path: (tuple(tree.shape), dtype_name(tree.dtype), specs)}


def test_the_cells_are_the_issue_count():
    assert len(CELLS) == 64


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_cell_specs_equal_the_reference(arch, shape, mesh):
    dims, axes = MESHES[mesh]
    pm, rm = AbstractMesh(dims, axes), RefMesh(dims, axes)
    cfg, rcfg = get_config(arch), ref_config(arch)
    sh, rsh = SHAPES[shape], REF_SHAPES[shape]
    if sh.kind == "train":
        got, opt = SP.train_specs(cfg, sh, pm)
        r_ab, r_sh, ropt = RSP.train_specs(rcfg, rsh, rm)
        assert opt.state_dtype == ropt.state_dtype
    else:
        got = SP.serve_specs(cfg, sh, pm, sh.kind)
        r_ab, r_sh = RSP.serve_specs(rcfg, rsh, rm, sh.kind)
    assert len(got.abstract) == len(r_ab)
    for i, (ab, spec, shard, rab, rs) in enumerate(zip(
            got.abstract, got.specs, got.shardings, r_ab, r_sh)):
        mine = _port_leaves(ab, spec, shard, pm)
        want = _ref_leaves(rab, rs)
        if sh.kind != "train" and i == 2:          # the cache tree
            dead = {k for k in want if k[-2:] == DEAD}
            assert bool(dead) == (cfg.rwkv is not None)
            want = {k: v for k, v in want.items() if k not in dead}
        assert mine == want


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_init_abstract_equals_the_reference(master, state_dtype):
    """Meta tensors of each moment's shape and dtype, ``master`` float32
    copies when asked for, as the reference's ShapeDtypeStructs."""
    cfg = get_config("recurrentgemma-2b")
    ab = T.tree_abstract(T.param_defs(cfg), cfg)
    got = AdamW(state_dtype=state_dtype,
                master_weights=master).init_abstract(ab)
    rcfg = ref_config("recurrentgemma-2b")
    want = RefAdamW(state_dtype=state_dtype, master_weights=master
                    ).init_abstract(RT.tree_abstract(RT.param_defs(rcfg),
                                                     rcfg))
    assert sorted(got) == sorted(want)
    for key in want:
        pw = jax.tree_util.tree_flatten_with_path(want[key])[0]
        pg = dict(_flat(got[key]))
        assert {tuple(k.key for k in p): (tuple(x.shape), str(x.dtype))
                for p, x in pw} == {
            p: (tuple(t.shape), dtype_name(t.dtype)) for p, t in pg.items()}
        assert all(t.device.type == "meta" for t in pg.values())


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def test_with_layers_and_the_logical_tree():
    cfg = SP.with_layers(get_config("qwen2-0.5b"), 3)
    assert cfg.n_layers == 3
    defs = T.param_defs(cfg)
    lg = T.tree_logical(defs)
    assert lg["emb"] == ("vocab", "d_model")
    assert lg["groups"]["b0"]["attn"]["wq"][0] == "layers"
    ab, lgb = SP.batch_abstract(get_config("qwen2-vl-7b"), 2, 8, "train")
    assert sorted(ab) == ["labels", "pos", "tokens", "vision_embeds",
                          "vision_mask"]
    assert lgb["pos"] == ("batch", "seq", None)
    assert ab["vision_mask"].dtype == torch.bool
