"""Logical-axis sharding rules with divisibility-aware fallback, on DTensor.

Twin of ``repro/sharding.py``.  Every parameter and activation is
annotated with a tuple of *logical* axis names (e.g. ``("layers",
"d_model", "d_ff")``).  ``resolve_spec`` maps logical axes to mesh axes
through an ordered rule table, skipping any candidate mesh axis that does
not evenly divide the dimension or is already consumed by another dim of
the same tensor: a dim that cannot be sharded is replicated instead of
erroring (e.g. qwen2-0.5b's 14 heads on a 16-way model axis).

A spec is a tuple with one entry per tensor dim, as ``PartitionSpec``'s
entries: ``None``, a mesh axis name, or a tuple of names sharded jointly.
``resolve_spec`` is pure Python over a mesh's axis names and sizes, so it
takes a ``torch.distributed.device_mesh.DeviceMesh`` (through
``mesh_dim_names``) or the port's ``AbstractMesh(shape, axis_names)``,
which needs no process group.

DTensor placements (``placements``) give one entry per *mesh* dim:
``Shard(i)`` when the spec puts that mesh axis on tensor dim ``i``,
``Replicate()`` otherwise.  A dim sharded jointly over several axes
(``("pod", "data")``) takes ``Shard(i)`` on each of those mesh dims.
DTensor splits a tensor dim over its mesh dims in mesh-dim order, the
first mesh dim outermost, so the joint entry's axes must appear in the
mesh's order (pod before data, as in ``TRAIN_RULES`` and the production
mesh): then shard ``p * n_data + d`` lies on (pod p, data d), as under
jax's ``PartitionSpec(("pod", "data"))``.  An entry in another order
raises.

``ShardCtx.constrain`` redistributes a DTensor activation to the resolved
placements, and its gradient in the backward, where the reference pins
both with ``with_sharding_constraint``; ``constrain(x, logical, None)``
returns ``x`` unchanged (one device).  A sharded step runs under ``scope(ctx)``,
DTensor's ``implicit_replication``: the plain tensors the model makes
from global shapes (RoPE tables, masks, zeros, the optimizer's schedule
scalars) enter DTensor ops as replicated.

Where DTensor cannot run the model's op as it stands, the port steps in
at these places, and nowhere else:

- the flash and rg_lru kernels take ``data_ptr``s: they run on each
  rank's local shards through ``local_map``
  (``kernels/flash_attention.py``, ``kernels/rg_lru.py``);
- RWKV's time mix (its head split of a sharded width, the chunked WKV)
  runs on each rank's batch shard and local heads through
  ``local_map`` (``models/rwkv.py``, ``_on_local_heads``), its output a
  partial sum over the heads' mesh dims that the block's pin reduces;
- a block pins its residual after its mixer as well as after the
  block, a tail block too (``transformer.block_apply``,
  ``apply_blocks``): DTensor propagates placements op by op, and an
  unpinned residual stays split on d_model behind a heads-split
  attention, so the MLP computes the whole d_ff on every rank (ROADMAP
  C.6);
- the default positions are made a DTensor placed as the tokens
  (``lm.positions``, ``placed_as``), since the scope's flag is the
  thread's own and RoPE's backward would otherwise mix a plain tensor
  into a DTensor op on the autograd engine's thread; the remat unit
  enters the scope again for its recompute (``transformer.apply_blocks``);
- the loss's label logits are picked on each rank's vocab shard and
  summed over the vocab's mesh dims (``lm.label_logits``): DTensor's
  ``gather`` would differentiate into a zero tensor of the logits'
  global shape;
- the attention and MLP projections take their weights as a layer
  computes with them (``for_compute``): the FSDP shards gathered, the
  tensor-parallel split of heads or d_ff kept where the rules make one.
  Where no mesh dim splits the heads (qwen2-0.5b's 14 on 16), DTensor
  would split the projection's flattened heads x d_head output, which
  it then cannot unflatten; for the MLP its own choice holds more at
  the step's peak (``tests/test_torch_dryrun.py``'s hand count of the
  reduced qwen2-0.5b sees the difference).  Decode attention groups
  q's heads only over the mesh dims that split the KV heads
  (``layers._whole_groups``);
- the embedding lookup runs on each rank's tokens (``lm._lookup``),
  against its vocab shard where it has fewer tokens than the shard has
  rows, else against the table gathered whole: DTensor's strategies for
  it fail (the index's backward on torch 2.11, ``F.embedding``'s masked
  partial on 2.13);
- a decode step writes its new K/V row into each rank's shard of a
  cache sharded over batch and positions (``layers._write_rows``):
  DTensor has no strategy for that indexed write;
- the global MoE (its sort and scatter over all tokens) runs on each
  rank's token shard and expert shard through ``local_map``
  (``models/moe.py``, ``_on_token_shards``): each expert keeps its
  first C assignments over all tokens from an all-gather of the token
  shards' counts, and the output is a partial sum over the experts'
  mesh dims that the block's pin reduces; the shared expert's gate is
  pinned, since the sigmoid's backward has no strategy for the partial
  sum its gradient is (``moe._shared_expert``);
- the rwkv channel mix pins its ``v`` (``models/rwkv.py``), or its
  backward reduce-scatters a whole-d_ff partial sum (ROADMAP C.7);
- the grouped MoE's ``searchsorted``, which has no sharding strategy,
  runs on whole values on every rank (``on_whole_values``);
- a gradient comes back with the placements autograd gave it (a
  partial sum, a shard of another dim) and is redistributed to its
  param's (``as_placed`` in ``lm.value_and_grad``), so the update is
  local and the state keeps its placements step after step.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.interop import tree_flatten, tree_unflatten

# Candidate mesh axes per logical axis, in preference order.  Entries may be
# tuples (shard over several mesh axes jointly).  These are the *training*
# defaults (FSDP + TP); serving overrides below.
TRAIN_RULES: Dict[str, Tuple] = {
    # activations
    "batch": (("pod", "data"), ("data",)),
    "seq": (),                       # replicated by default in training
    "seq_shard": (("model",),),      # sequence parallelism opt-in
    # parameters — TP axes
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "d_ff": (("model",),),
    "vocab": (("model",),),
    "experts": (("model",),),
    "rec_width": (("model",),),
    # parameters — FSDP axis
    "d_model": (("data",),),
    "d_model_pod": (("pod", "data"), ("data",)),  # ZeRO over pods too
    # never sharded
    "layers": (),
    "d_head": (),
    "conv": (),
    "lora": (),
    "mrope": (),
}

# Serving: no FSDP (params replicated over data, TP over model), batch on data,
# KV sequence on model (flash-decode style sequence parallelism).
SERVE_RULES: Dict[str, Tuple] = {
    **TRAIN_RULES,
    "d_model": (),
    "d_model_pod": (),
    "kv_seq": (("model",),),
    "seq": (("data",),),           # prefill: shard long seq over data
}

Spec = Tuple[Any, ...]


class AbstractMesh:
    """Axis names and sizes without devices or a process group, like
    ``jax.sharding.AbstractMesh``: ``shape`` maps each name to its size."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``, in
    the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # DeviceMesh
        return dict(zip(names, mesh.shape))
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    raise TypeError(f"{mesh!r} has no axis names")


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh, rules: Mapping[str, Tuple]) -> Spec:
    """Map logical axes -> a spec honouring divisibility + exclusivity."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical "
                         f"{tuple(logical)} differ in length")
    sizes = mesh_axes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        assigned = None
        if name:
            for cand in rules.get(name, ()):
                axes = tuple(a for a in cand if a in sizes)
                if not axes:
                    continue
                size = 1
                for a in axes:
                    size *= sizes[a]
                if size > 1 and dim % size == 0 and not (set(axes) & used):
                    assigned = axes if len(axes) > 1 else axes[0]
                    used.update(axes)
                    break
        out.append(assigned)
    return tuple(out)


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec``: one per mesh dim (module
    note)."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_axes(mesh))
    out = [Replicate() for _ in order]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        ix = [order.index(a) for a in axes]
        if ix != sorted(ix):
            raise ValueError(f"joint axes {axes} are not in the mesh's "
                             f"order {tuple(order)}")
        for j in ix:
            out[j] = Shard(dim)
    return tuple(out)


def tree_specs(abstract_tree, logical_tree, mesh, rules) -> Any:
    """The resolved spec of every leaf of an abstract tree (tensors on
    the meta device, or anything with a ``shape``)."""
    leaves, tdef = tree_flatten(abstract_tree)
    logical = _logical_leaves(logical_tree, tdef, len(leaves))
    return tree_unflatten(tdef, [resolve_spec(x.shape, lg, mesh, rules)
                                 for x, lg in zip(leaves, logical)])


def tree_shardings(abstract_tree, logical_tree, mesh, rules) -> Any:
    """``(mesh, placements)`` for every leaf of an abstract tree."""
    leaves, tdef = tree_flatten(tree_specs(abstract_tree, logical_tree,
                                           mesh, rules))
    return tree_unflatten(tdef, [(mesh, placements(s, mesh))
                                 for s in leaves])


def _logical_leaves(logical_tree, tdef, n: int) -> list:
    """The logical tuples of a tree shaped as the abstract one (its
    leaves are tuples, which ``tree_flatten`` keeps whole)."""
    logical, ltdef = tree_flatten(logical_tree)
    if ltdef != tdef or len(logical) != n:
        raise ValueError("the logical tree is not shaped as the tree")
    return logical


def sharding_leaves(shardings, tdef, n: int) -> list:
    """The ``(mesh, placements)`` of each of the ``n`` leaves of a tree
    whose structure is ``tdef``: ``shardings`` is one pair for every
    leaf or a tree of pairs shaped as the tree (``tree_shardings``)."""
    if isinstance(shardings, dict):
        sh, sdef = tree_flatten(shardings)
    elif isinstance(shardings, tuple) and len(shardings) == 2:
        sh, sdef = [shardings] * n, tdef
    else:
        raise TypeError(f"shardings: want (mesh, placements) or a dict "
                        f"of them, got {type(shardings).__name__}")
    if sdef != tdef:
        raise ValueError("the shardings are not shaped as the tree")
    return sh


def distribute_tree(tree, shardings, src_data_rank: Optional[int] = 0):
    """Each tensor of ``tree`` as a DTensor at its ``(mesh, placements)``
    of ``shardings`` (``sharding_leaves``' forms), through
    ``distribute_tensor``: with ``src_data_rank=None`` every rank keeps
    its own slice of the tensor it holds and nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor
    leaves, tdef = tree_flatten(tree)
    sh = sharding_leaves(shardings, tdef, len(leaves))
    return tree_unflatten(tdef, [
        distribute_tensor(t, m, list(pl), src_data_rank=src_data_rank)
        for t, (m, pl) in zip(leaves, sh)])


def from_whole(t: torch.Tensor, mesh, placements_) -> Any:
    """A DTensor at ``(mesh, placements)`` of ``t``, a whole value each
    rank holds off the mesh's device (a leaf read on the host): only
    this rank's slice goes to the mesh's device, and nothing is
    communicated.  A dim sharded over several mesh dims is split in
    mesh-dim order, as ``distribute_tensor`` splits it."""
    from torch.distributed.tensor import DTensor, Shard
    t = t.contiguous()
    coord = mesh.get_coordinate()
    local = t
    for j, p in enumerate(placements_):
        if isinstance(p, Shard):
            n = mesh.size(j)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"split evenly over mesh dim {j} ({n})")
            local = local.chunk(n, dim=p.dim)[coord[j]]
    return DTensor.from_local(local.to(mesh.device_type).contiguous(), mesh,
                              list(placements_), run_check=False,
                              shape=t.shape, stride=t.stride())


class ShardCtx:
    """Mesh + rules bundle for in-graph activation constraints."""

    def __init__(self, mesh, rules: Mapping[str, Tuple]):
        self.mesh = mesh
        self.rules = rules

    def placements(self, shape, logical) -> tuple:
        return placements(resolve_spec(shape, logical, self.mesh,
                                       self.rules), self.mesh)

    def constrain(self, x, logical: Sequence[Optional[str]]):
        """``x`` (a DTensor on this mesh) redistributed to the placements
        ``logical`` resolves to; unchanged when it has them."""
        if not is_dtensor(x):
            raise TypeError("ShardCtx.constrain takes a DTensor: distribute "
                            "the params and batch first (distribute_tree)")
        return _Pin.apply(x, self.mesh, self.placements(x.shape, logical))


class _Pin(torch.autograd.Function):
    """A DTensor redistributed to ``want``, and its gradient too, as
    ``with_sharding_constraint`` pins a cotangent: otherwise a gradient
    keeps the placements autograd gave it (a partial sum over the model
    axis from the MLP's backward), and every product behind it follows
    that placement."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x.view_as(x) if tuple(x.placements) == want else \
            x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None, None


_scopes = threading.local()


@contextlib.contextmanager
def scope(ctx: Optional[ShardCtx]):
    """The context a step under ``ctx`` runs in (module note), entered
    once however deeply nested (``implicit_replication`` turns itself
    off on exit); a null context without a ctx.  Its flag is the
    thread's own, so no backward formula may mix a plain tensor with a
    DTensor: the autograd engine runs a card's backward on its own
    thread."""
    if ctx is None or getattr(_scopes, "on", False):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _scopes.on = True
    try:
        with implicit_replication():
            yield
    finally:
        _scopes.on = False


def for_compute(w, *keep: int):
    """Weight ``w`` as a layer computes with it under a mesh: its shards
    along dims ``keep`` (tensor parallel) kept, every other placement
    gathered (FSDP's all-gather before use; its backward reduce-scatters
    the gradient); ``w`` itself off a mesh (module note)."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    want = [p if isinstance(p, Shard) and p.dim in keep else Replicate()
            for p in w.placements]
    return w if want == list(w.placements) else \
        w.redistribute(w.device_mesh, want)


def constrain(x, logical, ctx: Optional[ShardCtx]):
    """Pin activation sharding; no-op when ctx is None (single-device)."""
    return x if ctx is None else ctx.constrain(x, logical)


def batch_spec(mesh, rules=TRAIN_RULES) -> Spec:
    """The spec of a batch's leading dim: the first ``batch`` rule whose
    axes the mesh has."""
    sizes = mesh_axes(mesh)
    for cand in rules["batch"]:
        axes = tuple(a for a in cand if a in sizes)
        if axes:
            return (axes if len(axes) > 1 else axes[0],)
    return ()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; DTensor's module is not imported for
    the asking (no DTensor exists before it is)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _dtensors(args) -> list:
    out = []
    for x in args:
        if isinstance(x, dict):
            out += _dtensors(x.values())
        elif is_dtensor(x):
            out.append(x)
    return out


def on_whole_values(fn, *args):
    """``fn(*args)`` where DTensor propagation has no strategy: every
    DTensor among ``args`` (or the leaves of dict args) is all-gathered
    to ``Replicate`` and handed to ``fn`` as a plain tensor, and ``fn``'s
    tensor outputs come back as replicated DTensors.  Each rank computes
    the whole value, as one device would; both conversions are
    differentiable.  Without a DTensor among ``args``, ``fn(*args)``."""
    found = _dtensors(args)
    if not found:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = found[0].device_mesh
    rep = [Replicate()] * mesh.ndim

    def down(x):
        if isinstance(x, dict):
            return {k: down(v) for k, v in x.items()}
        if is_dtensor(x):
            return x.redistribute(mesh, rep).to_local()
        return x

    def up(x):
        if isinstance(x, dict):
            return {k: up(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(up(v) for v in x)
        if isinstance(x, torch.Tensor):
            return DTensor.from_local(x, mesh, rep, run_check=False)
        return x
    return up(fn(*[down(a) for a in args]))


def as_placed(x, ref):
    """DTensor ``x`` redistributed to the placements of DTensor ``ref``
    (a gradient to its param's: the reductions happen here, once, and
    the update is local); ``x`` unchanged otherwise."""
    if not (is_dtensor(x) and is_dtensor(ref)) or \
            tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def placed_as(t, ref):
    """``t``, a plain tensor of ``ref``'s shape holding the same whole
    value on every rank, as a DTensor placed as ``ref`` (each rank keeps
    its slice, nothing is communicated); ``t`` itself when ``ref`` is no
    DTensor."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, ref.device_mesh, ref.placements,
                             src_data_rank=None)


def local(x):
    """A DTensor's local shard; any other value itself."""
    return x.to_local() if is_dtensor(x) else x


def full(x):
    """A DTensor's whole value as a plain tensor on every rank (its
    placements all-gathered and reduced); any other value unchanged."""
    return x.full_tensor() if is_dtensor(x) else x
