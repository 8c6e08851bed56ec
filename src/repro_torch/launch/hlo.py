"""What one traced step costs a rank: collective operand bytes by
category, FLOPs, bytes accessed and live memory.

Twin of ``repro/launch/hlo.py``, which reads XLA's partitioned (per-shard)
HLO text.  The port has no HLO: ``Trace``, a ``TorchDispatchMode``,
watches the step as it runs and counts the ops one rank runs on its own
tensors, below DTensor (an op on DTensors is handed back to DTensor,
whose ops on the local shards the mode then sees):

- collectives: the functional collectives DTensor issues
  (``_c10d_functional``, and its own all-to-all), filed under the
  reference's ``COLLECTIVES``; a point-to-point send (c10d's ``send``)
  is a ``collective-permute``.  Operand bytes follow the reference's
  convention: an all-gather's operand is this rank's shard, a
  reduce-scatter's and an all-reduce's the rank's whole input buffer,
  i.e. the bytes of the op's input tensors;
- flops: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry, which holds the port's kernels' formulas too) over the ops
  the rank runs.  A ``FlopCounterMode`` over DTensors counts each op
  once at its global shapes; on a plain (one-device) step its total is
  this one;
- bytes accessed: every op's input and output tensor bytes, view ops
  excepted: the unfused count, as XLA's ``"bytes accessed"`` key is;
- hlo_chars: the characters of the trace's op listing, one line an op
  (``aten.mm.default(bf16[16,896],bf16[896,4864])->bf16[16,4864]``),
  the port's stand-in for the size of the module text;
- memory: the bytes of the storages the step allocates, by storage
  lifetime: a storage counts once, however many views share it, from
  the op that made it until its last reference dies (a
  ``weakref.finalize`` on the storage); ``peak`` is the most of them
  live at once.  The arguments' storages (``arguments``) are known from
  the start and never count.  The mode keeps no reference to a tensor:
  a record a storage of its bytes, the op and the shape.  An op whose
  card kernel allocates a temporary inside itself, which no dispatch
  shows (``logsumexp``'s input-sized exp), counts it for that op alone.
  Under any dispatch mode autograd switches some backward formulas to
  out-of-place versions (composite compliance): ``gather``'s backward
  makes a zero buffer and scatters into a copy of it, where the step
  run with no mode scatters into the buffer itself.  For those formulas
  (``_IN_PLACE_WITHOUT_MODE``) the output takes the zero buffer's place
  in the count.

Ops on FakeTensors are not counted.  DTensor runs each new op once on
FakeTensors of its global shapes to learn the output's shape; those
shadow ops are no rank's work.  So a step to count runs on meta tensors
(``launch/dryrun.py``) or on a card's tensors, never under
``FakeTensorMode``.

``collective_bytes``, ``total_collective_bytes`` and
``cost_analysis_dict`` keep the reference's names and return shapes and
take a finished ``Trace``.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.device import is_fake
from repro_torch.sharding import local

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name -> category; the operand is the op's first argument
_COLLECTIVE_OPS = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::send": "collective-permute",
}

# ops whose fake (meta) version returns a chunk of a larger buffer where
# the card's allocates the output alone: DTensor's all-to-all builds the
# whole gathered tensor and returns this rank's chunk of it
_OUTPUT_SIZED = {"_dtensor::shard_dim_alltoall"}

# ops whose card kernel holds an input-sized temporary that no dispatch
# shows: logsumexp subtracts the max into a new tensor, exponentiates it
# in place and sums it
_INPUT_SIZED_TEMP = {"aten::logsumexp"}

# autograd node -> the out-of-place op its backward formula runs under a
# dispatch mode on the zero buffer it has just made, where with no mode
# it runs the in-place op on that buffer (``gather_backward``,
# ``index_backward`` and ``index_select_backward`` in PyTorch's
# FunctionsManual.cpp)
_IN_PLACE_WITHOUT_MODE = {"GatherBackward0": "aten::scatter_add",
                          "IndexBackward0": "aten::index_put",
                          "IndexSelectBackward0": "aten::index_add"}

_IN_PLACE_OPS = frozenset(_IN_PLACE_WITHOUT_MODE.values())

_SHORT = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
          torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
          torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
          torch.bool: "pred"}


def _wrappers() -> tuple:
    """The tensor subclasses that run an op on the tensors they wrap
    (DTensor, a collective's async result), as far as imported."""
    out = []
    for mod, name in (("torch.distributed.tensor", "DTensor"),
                      ("torch.distributed._functional_collectives",
                       "AsyncCollectiveTensor")):
        cls = getattr(sys.modules.get(mod), name, None)
        if cls is not None:
            out.append(cls)
    return tuple(out)


def _tensors(x) -> List[torch.Tensor]:
    """The tensors in an op's argument or result (lists and tuples
    flattened one level deep, as op schemas nest them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sig(t: torch.Tensor) -> str:
    return f"{_SHORT.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"


def tensors_of(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def storage_bytes(tree) -> Dict[int, int]:
    """{storage key: bytes} of the distinct storages under ``tree``'s
    tensors (a DTensor's local shard)."""
    out = {}
    for t in tensors_of(tree):
        st = local(t).untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


class Trace(TorchDispatchMode):
    """Counts one rank's part of a step (module note).  Enter it around
    the step, after ``arguments``; read ``flops``, ``bytes_accessed``,
    ``collectives``, ``collective_shapes``, ``chars``, ``ops``, ``peak``
    and ``live_at_peak`` after it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Dict[str, int] = defaultdict(int)
        self.bytes_accessed = 0
        self.collectives: Dict[str, Dict[str, float]] = {}
        # (category, shape) of each collective operand, in the order run
        self.collective_shapes: List[Tuple[str, Tuple[int, ...]]] = []
        self.chars = 0
        self.ops = 0
        self.argument = 0
        self.live = 0
        self.peak = 0
        self._t = 0             # allocations so far: the memory clock
        self._t_peak = 0
        self._seen: Dict[int, int] = {}        # storage key -> record
        # [bytes, allocated at, freed at or None, op, shape, dtype]
        self._records: List[list] = []

    # -- memory ------------------------------------------------------------

    def arguments(self, *trees) -> int:
        """Register the storages of the step's arguments (their local
        shards): known from the start, never counted as allocated.
        Returns their bytes."""
        for key, n in storage_bytes(trees).items():
            if key not in self._seen:
                self._seen[key] = -1
                self.argument += n
        return self.argument

    def _freed(self, key: int, i: int) -> None:
        self._seen.pop(key, None)
        rec = self._records[i]
        if rec[2] is None:      # not handed over already
            rec[2] = self._t
            self.live -= rec[0]

    def _hand_over(self, t: torch.Tensor) -> None:
        """The op about to allocate its output works, with no mode, in
        place on ``t``'s storage, the last one allocated: it ends here,
        and the output takes its place."""
        i = self._seen.get(t.untyped_storage()._cdata)
        if i is None or i != len(self._records) - 1:
            return
        rec = self._records[i]
        rec[2] = self._t
        self.live -= rec[0]

    def _allocated(self, out: List[torch.Tensor], inputs: set,
                   label: str, output_sized: bool) -> None:
        for t in out:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen or key in inputs:
                continue
            n = _nbytes(t) if output_sized else st.nbytes()
            self._t += 1
            i = len(self._records)
            self._records.append([n, self._t, None, label, tuple(t.shape),
                                  _SHORT.get(t.dtype, str(t.dtype))])
            self._seen[key] = i
            weakref.finalize(st, self._freed, key, i)
            self.live += n
            if self.live > self.peak:
                self.peak, self._t_peak = self.live, self._t

    def _transient(self, t: torch.Tensor, label: str) -> None:
        """A temporary of ``t``'s bytes inside one op: live for that op
        alone."""
        n = _nbytes(t)
        self._t += 1
        self._records.append([n, self._t, self._t, label, tuple(t.shape),
                              _SHORT.get(t.dtype, str(t.dtype))])
        if self.live + n > self.peak:
            self.peak, self._t_peak = self.live + n, self._t

    def live_at_peak(self, n: int = 8) -> List[dict]:
        """The ``n`` largest storages live at the peak, largest first:
        bytes, the op that made each, its shape and dtype."""
        t = self._t_peak
        live = [r for r in self._records
                if r[1] <= t and (r[2] is None or r[2] >= t)]
        live.sort(key=lambda r: -r[0])
        return [{"bytes": r[0], "op": r[3], "shape": list(r[4]),
                 "dtype": r[5]} for r in live[:n]]

    # -- the dispatch ------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, w) for t in types for w in _wrappers()):
            return NotImplemented           # it runs the op on its shards
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        if any(is_fake(t) for t in ins):
            return func(*args, **kwargs)    # a sharding-propagation shadow
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(is_fake(t) for t in outs):
            return out
        self.ops += 1
        name = func._schema.name
        self.chars += len(f"{func}({','.join(map(_sig, ins))})->"
                          f"{','.join(map(_sig, outs))}") + 1
        cat = _COLLECTIVE_OPS.get(name)
        if cat is not None:
            c = self.collectives.setdefault(
                cat, {"count": 0, "operand_bytes": 0.0})
            c["count"] += 1
            operands = _tensors(args[0])
            c["operand_bytes"] += float(sum(map(_nbytes, operands)))
            self.collective_shapes += [(cat, tuple(t.shape))
                                       for t in operands]
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(func._overloadpacket)] += n
        if name in _INPUT_SIZED_TEMP:
            self._transient(ins[0], str(func))
        if name in _IN_PLACE_OPS:
            node = torch._C._current_autograd_node()
            if node is not None and \
                    _IN_PLACE_WITHOUT_MODE.get(node.name()) == name:
                self._hand_over(args[0])
        if not func.is_view:
            self.bytes_accessed += sum(map(_nbytes, ins)) + \
                sum(map(_nbytes, outs))
            self._allocated(outs, {t.untyped_storage()._cdata for t in ins},
                            str(func), name in _OUTPUT_SIZED)
        return out


def collective_bytes(trace: Trace) -> Dict[str, Dict[str, float]]:
    """Returns {category: {"count": n, "operand_bytes": b}} per-device."""
    return {k: dict(v) for k, v in trace.collectives.items()}


def cost_analysis_dict(trace: Trace) -> Dict[str, float]:
    """{"flops", "bytes accessed"} of the traced step, XLA's keys."""
    return {"flops": float(trace.flops),
            "bytes accessed": float(trace.bytes_accessed)}


def total_collective_bytes(trace: Trace) -> Tuple[float, Dict]:
    per = collective_bytes(trace)
    return sum(v["operand_bytes"] for v in per.values()), per
