"""Checkpoints across the packages: a checkpoint written by either
restores in the other, with the same ``.npy`` leaf files byte for byte
and the same manifest (the ``"treedef"`` string included); corruption,
retention, ``.tmp`` directories, async saves; ``save_far``/
``restore_far`` on the port's far-memory node; and the engine's tree
helpers (``write_tree``, ``read_tree``, ``read_tree_async``, the
deprecated ``flavor=``) and ``ChannelPool.h2c_tree``.  The train state
crosses ``interop`` both ways (int32 step, bf16 moments)."""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa
from repro.optim.adamw import for_arch as ref_for_arch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core.channels import ChannelPool  # noqa: E402
from repro_torch.core.engine import MemoryEngine  # noqa: E402
from repro_torch.rmem.node import MemoryNode  # noqa: E402


def ref_state(seed=0):
    """A train state as the reference holds it: bf16 params, float32
    and bf16 moments (grok's policy), a stacked group, an int32 step."""
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"emb": jax.random.normal(k[0], (16, 8), jnp.bfloat16),
              "final_ln": jnp.zeros((8,), jnp.bfloat16),
              "groups": {"b0": {"attn": {"wq": jax.random.normal(
                  k[1], (2, 8, 2, 4), jnp.bfloat16)}}}}
    opt = ref_for_arch("grok-1-314b").init(params)
    opt = jax.tree.map(lambda m: m + jax.random.normal(k[2], m.shape,
                                                       m.dtype), opt)
    return {"params": params, "opt": opt,
            "step": jnp.asarray(11, jnp.int32)}


def port_state(seed=0):
    return interop.tree_to_torch(jax.tree.map(np.asarray, ref_state(seed)))


def _bytes_equal(port_tree, ref_tree):
    pl, rl = interop.tree_leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        assert interop.dtype_name(a) == jnp.dtype(b.dtype).name
        assert tuple(a.shape) == tuple(b.shape)
        assert interop.to_numpy(a).tobytes() == np.asarray(b).tobytes()


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_state_crosses_interop_both_ways():
    ref = ref_state()
    port = port_state()
    assert port["step"].dtype == torch.int32 and port["step"].ndim == 0
    assert port["opt"]["m"]["emb"].dtype == torch.bfloat16
    _bytes_equal(port, ref)
    back = interop.tree_to_numpy(port)
    for a, b in zip(interop.tree_leaves(back), jax.tree.leaves(ref)):
        assert a.tobytes() == np.asarray(b).tobytes()


def test_port_and_reference_write_the_same_files(tmp_path):
    """The same state saved by both packages: every ``.npy`` file and
    the manifest are byte-equal."""
    RefManager(str(tmp_path / "ref")).save(11, ref_state(), block=True)
    mgr = CheckpointManager(str(tmp_path / "port"), device="cpu")
    mgr.save(11, port_state(), block=True)
    mgr.close()
    ref_files = _files(tmp_path / "ref" / "step_0000000011")
    port_files = _files(tmp_path / "port" / "step_0000000011")
    assert sorted(ref_files) == sorted(port_files)
    assert "params__groups__b0__attn__wq.npy" in port_files
    for name in ref_files:
        if name != "manifest.json":
            assert port_files[name] == ref_files[name], name
    pm = json.loads(port_files["manifest.json"])
    rm = json.loads(ref_files["manifest.json"])
    assert pm == rm                       # "treedef" string included


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoints_restore_in_the_other_package(tmp_path, writer):
    d = str(tmp_path)
    if writer == "ref":
        RefManager(d).save(11, ref_state(1), block=True)
        mgr = CheckpointManager(d, device="cpu")
        step, back = mgr.restore(port_state(0))
        mgr.close()
        assert step == 11
        _bytes_equal(back, ref_state(1))
    else:
        mgr = CheckpointManager(d, device="cpu")
        mgr.save(11, port_state(1), block=True)
        mgr.close()
        step, back = RefManager(d).restore(ref_state(0))
        assert step == 11
        _bytes_equal(port_state(1), back)


def test_restore_needs_no_treedef(tmp_path):
    """Leaves are read by name: a manifest whose structure string is
    gone restores the same."""
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(3, port_state(2), block=True)
    path = tmp_path / "step_0000000003" / "manifest.json"
    man = json.loads(path.read_text())
    man["treedef"] = "unused"
    path.write_text(json.dumps(man))
    _, back = mgr.restore(port_state(0))
    _bytes_equal(back, ref_state(2))
    _, rback = RefManager(str(tmp_path)).restore(ref_state(0))
    _bytes_equal(back, rback)


def test_async_save_gc_tmp_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    for s in (1, 2, 3):
        st = port_state(s)
        st["step"] = torch.tensor(s, dtype=torch.int32)
        mgr.save(s, st, block=False)
    mgr.wait()
    os.makedirs(tmp_path / "step_0000000009.tmp")     # a crashed save
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_step() == 3
    step, back = mgr.restore(port_state(0))
    assert step == 3 and int(back["step"]) == 3
    step, back = mgr.restore(port_state(0), step=2)
    _bytes_equal(back["params"], ref_state(2)["params"])
    mgr.close()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty"), device="cpu").restore(
            port_state(0))


def test_corruption_missing_leaf_and_shape_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(5, port_state(), block=True)
    f = tmp_path / "step_0000000005" / "params__emb.npy"
    raw = np.load(f)
    raw[0] ^= 0xFF
    np.save(f, raw)
    with pytest.raises(IOError, match="digest"):
        mgr.restore(port_state())
    with pytest.raises(IOError, match="digest"):
        RefManager(str(tmp_path)).restore(ref_state())
    bigger = port_state()
    bigger["params"]["extra"] = torch.zeros(3)
    mgr.save(6, port_state(), block=True)
    with pytest.raises(KeyError, match="params__extra"):
        mgr.restore(bigger)
    wrong = port_state()
    wrong["params"]["final_ln"] = torch.zeros(9, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(wrong)
    with pytest.raises(TypeError, match="shardings"):
        mgr.restore(port_state(), shardings=object())
    with pytest.raises(ValueError, match="meta"):
        mgr.restore(interop.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            port_state()))


RESTORE_CHILD = r"""
import hashlib
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.interop import to_numpy, tree_map
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
mgr = CheckpointManager(os.environ["CKPT"], device="cpu")
whole = torch.load(os.environ["LIKE"])
like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                whole)
sh = tree_map(lambda t: (mesh, (Shard(0),) if t.ndim else (Replicate(),)),
              like)
step, got = mgr.restore(like, shardings=sh)
mgr.close()
man = json.load(open(os.path.join(os.environ["CKPT"], f"step_{step:010d}",
                                  "manifest.json")))
digests = {e["name"]: e["sha256"] for e in man["leaves"]}
names = {"params__emb": got["params"]["emb"], "step": got["step"],
         "opt__m__groups__b0__attn__wq":
         got["opt"]["m"]["groups"]["b0"]["attn"]["wq"]}
same = {n: hashlib.sha256(to_numpy(t.full_tensor()).tobytes()
                          ).hexdigest()[:16] == digests[n]
        for n, t in names.items()}
emb = got["params"]["emb"].to_local()
done({"step": step, "same": same, "local": list(emb.shape),
      "own_rows": bool(torch.equal(emb, whole["params"]["emb"].chunk(
          WORLD)[RANK])),
      "placements": [str(p) for p in got["params"]["emb"].placements],
      "all_dtensors": all(isinstance(t, DTensor) for t in
                          [got["step"], got["params"]["final_ln"]])})
"""


def test_restore_places_leaves_over_a_mesh(tmp_path):
    """``restore(shardings=)`` onto an abstract (meta) ``like``
    distributes each restored leaf to its placements over a gloo mesh of
    2 CPU ranks: the emb rows split in two, each rank holding its own
    half, the whole of every leaf hashing to the manifest's digest."""
    from torch_ranks import run_ranks
    ckpt = os.path.join(str(tmp_path), "ckpt")
    mgr = CheckpointManager(ckpt, device="cpu")
    mgr.save(11, port_state(), block=True)
    mgr.close()
    like = os.path.join(str(tmp_path), "like.pt")
    torch.save(port_state(), like)
    out = run_ranks(RESTORE_CHILD, 2, tmp_path, timeout=120,
                    env={"CKPT": ckpt, "LIKE": like})
    assert out["step"] == 11 and all(out["same"].values()), out
    assert out["local"] == [8, 8] and out["own_rows"]
    assert out["placements"] == ["S(0)"] and out["all_dtensors"]


def test_save_far_restore_far_round_trip(tmp_path):
    """A diskless checkpoint on the port's far-memory node: restored
    byte-equal, the manifest's names, sizes, shapes, dtypes and digests
    those of the reference's ``save_far`` of the same state; ``reuse``
    overwrites in place; a flipped byte on the node raises."""
    from repro.rmem.node import MemoryNode as RefNode
    with RefNode("ref-ckpt", 1 << 20) as rnode:
        rman = RefManager(str(tmp_path / "r")).save_far(11, ref_state(),
                                                        rnode)
    with MemoryNode("ckpt", 1 << 20, device="cpu") as node:
        mgr = CheckpointManager(str(tmp_path / "p"), device="cpu")
        man = mgr.save_far(11, port_state(), node)
        keys = ("name", "nbytes", "shape", "dtype", "sha256")
        assert [{k: e[k] for k in keys} for e in man["leaves"]] == \
            [{k: e[k] for k in keys} for e in rman["leaves"]]
        assert man["bytes"] == rman["bytes"] and man["qp"]["doorbells"] >= 1
        step, back = mgr.restore_far(port_state(3), man, node)
        assert step == 11
        _bytes_equal(back, ref_state())
        brk = node._brk
        man2 = mgr.save_far(12, port_state(4), node, reuse=man)
        assert node._brk == brk
        _, back = mgr.restore_far(port_state(0), man2, node)
        _bytes_equal(back, ref_state(4))
        e = man2["leaves"][0]
        node.pool[e["addr"]] ^= 0xFF
        with pytest.raises(IOError, match="digest"):
            mgr.restore_far(port_state(0), man2, node)
        mgr.close()


# ---------------------------------------------------------------------------
# the engine's tree helpers
# ---------------------------------------------------------------------------

def test_engine_tree_round_trip_keeps_bf16_bits():
    st = port_state(5)
    with MemoryEngine(n_channels=2, path="xdma", device="cpu") as eng:
        host = eng.read_tree(st)
        _bytes_equal(host, ref_state(5))
        join = eng.read_tree_async(st)
        again = join()
        dev = eng.write_tree(
            {"a": np.arange(6, dtype=np.float32).reshape(2, 3)})
        back = eng.write_tree(again)
        assert eng.stats()["bytes_moved"] > 0
    _bytes_equal(again, ref_state(5))
    _bytes_equal(back, ref_state(5))
    assert dev["a"].tolist() == [[0, 1, 2], [3, 4, 5]]


def test_flavor_is_deprecated_but_works():
    with pytest.warns(DeprecationWarning, match="flavor"):
        eng = MemoryEngine(flavor="qdma", device="cpu")
    assert eng.flavor == "qdma"
    eng.close()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = MemoryEngine(path="xdma", device="cpu")
    assert eng.flavor == "xdma"
    eng.close()


def test_h2c_tree_in_flatten_order():
    tree = {"b": np.ones(3, np.float32), "a": {"y": np.arange(4),
                                               "x": np.zeros((2, 2))}}
    with ChannelPool(2, device="cpu") as pool:
        out = pool.drain(pool.h2c_tree(tree))
    assert [tuple(t.shape) for t in out] == [(2, 2), (4,), (3,)]
    assert out[1].tolist() == [0, 1, 2, 3]
