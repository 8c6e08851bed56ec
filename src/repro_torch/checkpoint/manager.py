"""Resharding-safe checkpointing with async C2H drains.

Twin of ``repro/checkpoint/manager.py``, with its on-disk format, so a
checkpoint written by either package restores in the other:
``<dir>/step_<N>/`` (N zero-padded to 10 digits) holds one ``.npy`` per
tree leaf, its raw bytes as a flat ``uint8`` array, named by the leaf's
key path joined with ``__`` (``params__groups__b0__attn__wq``), plus
``manifest.json`` with the step, the tree structure and, per leaf, its
name, shape, dtype name and the first 16 hex digits of the bytes'
sha256.  Writes go to ``step_<N>.tmp`` and are renamed into place, so a
crash mid-save never corrupts the latest checkpoint.  The manifest's
``"treedef"`` is written as jax's ``str(PyTreeDef)`` of the same nested
dicts (``PyTreeDef({'opt': {...}, 'params': {...}, 'step': *})``);
restore reads leaves by name and never the structure string.

The device->host snapshot streams through the NMA engine's C2H channels
(``MemoryEngine.read_tree_async``), then a background thread persists
it: training resumes while bytes drain, the paper's C2H pattern.

``save_far``/``restore_far`` spill a snapshot to a far-memory node
(``repro_torch.rmem.MemoryNode``) through one-sided verbs instead of
disk: a diskless checkpoint on the rmem tier.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import MemoryEngine
from repro_torch.interop import (dtype_name, torch_dtype, tree_flatten,
                                 tree_unflatten)
from repro_torch.sharding import from_whole, sharding_leaves


def _flatten_with_path(tree, path=()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) pairs in jax's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_path(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def treedef_str(tree) -> str:
    """jax's ``str(PyTreeDef)`` of a tree of nested dicts."""
    def fmt(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def _leaf_name(path) -> str:
    return "__".join(str(p) for p in path) or "leaf"


def _host_bytes(leaf: torch.Tensor) -> np.ndarray:
    """A host leaf's bytes as a flat uint8 array (bf16 through its bits)."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def _from_bytes(raw: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    """A leaf from its raw bytes, dtype name and shape, on ``device``."""
    dt = torch_dtype(dtype)
    bits = torch.int16 if dt == torch.bfloat16 else dt
    t = torch.from_numpy(np.ascontiguousarray(raw).copy()).view(bits)
    return t.view(dt).reshape(shape).to(device)


def _digest(raw: np.ndarray) -> str:
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 engine: Optional[MemoryEngine] = None, digest: bool = True,
                 path="auto", device=None):
        """``path`` names the access path the C2H snapshot drain rides
        (the stage-only ``auto`` selector by default) and ``device`` the
        engine's device (None means ``"cuda"``); both are ignored when an
        ``engine`` is handed in."""
        self.dir = directory
        self.keep = keep
        self._owns_engine = engine is None
        self.engine = engine or MemoryEngine(n_channels=2, path=path,
                                             device=device)
        self.digest = digest
        os.makedirs(directory, exist_ok=True)
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, block: bool = True) -> None:
        self.wait()  # one async save at a time
        pairs = _flatten_with_path(tree)
        paths = [p for p, _ in pairs]
        treedef = treedef_str(tree)
        join = self.engine.read_leaves_async([l for _, l in pairs])

        def persist():
            try:
                self._write(step, paths, join(), treedef)
            except BaseException as e:  # surfaced on next wait()
                self._save_error = e

        self._save_thread = threading.Thread(target=persist, daemon=True)
        self._save_thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            e, self._save_error = self._save_error, None
            raise e

    def _write(self, step: int, paths, host_leaves, treedef: str) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "treedef": treedef,
                                    "leaves": []}
        names = set()
        for path, leaf in zip(paths, host_leaves):
            name = _leaf_name(path)
            if name in names:
                raise ValueError(f"duplicate leaf name {name}")
            names.add(name)
            raw = _host_bytes(leaf)
            np.save(os.path.join(tmp, name + ".npy"), raw)
            entry = {"name": name, "shape": list(leaf.shape),
                     "dtype": dtype_name(leaf)}
            if self.digest:
                entry["sha256"] = _digest(raw)
            manifest["leaves"].append(entry)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- far-memory spill ----------------------------------------------------
    def save_far(self, step: int, tree: Any, node,
                 doorbell_batch: int = 8,
                 reuse: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Spill a snapshot to a ``repro_torch.rmem.MemoryNode``.

        Returns the manifest ``restore_far`` needs (leaf name -> node
        address); digests guard the far copy as on disk.  Leaves are
        posted as one-sided writes with doorbell batching and fenced
        once at the end.  Pass the previous manifest as ``reuse`` to
        overwrite leaves of the same name and size in place (node memory
        is bump-allocated)."""
        from repro_torch.rmem.verbs import MemoryRegion, QueuePair
        self.wait()
        reuse_addrs = {e["name"]: e for e in reuse["leaves"]} if reuse \
            else {}
        pairs = _flatten_with_path(tree)
        host_leaves = self.engine.read_leaves_async(
            [l for _, l in pairs])()
        entries: List[Dict[str, Any]] = []
        keepalive = []                     # MRs must outlive the doorbell
        with QueuePair(node, doorbell_batch=doorbell_batch) as qp:
            for (path, _), leaf in zip(pairs, host_leaves):
                raw = _host_bytes(leaf)
                nbytes = raw.nbytes
                name = _leaf_name(path)
                prev = reuse_addrs.get(name)
                if prev is not None and prev["nbytes"] == nbytes:
                    addr = prev["addr"]
                else:
                    addr = node.alloc(max(nbytes, 1))
                mr = MemoryRegion(raw if nbytes else np.zeros(1, np.uint8))
                keepalive.append(mr)
                qp.post_write(mr, 0, addr, max(nbytes, 1))
                entry = {"name": name, "addr": addr, "nbytes": nbytes,
                         "shape": list(leaf.shape),
                         "dtype": dtype_name(leaf)}
                if self.digest:
                    entry["sha256"] = _digest(raw)
                entries.append(entry)
            qp.flush()
            return {"step": step, "node": node.name, "leaves": entries,
                    "bytes": sum(e["nbytes"] for e in entries),
                    "qp": qp.stats()}

    def restore_far(self, like: Any, manifest: Dict[str, Any],
                    node) -> Tuple[int, Any]:
        """Pull a ``save_far`` snapshot back from the node into ``like``'s
        structure (each leaf on ``like``'s leaf's device), verifying
        digests."""
        from repro_torch.rmem.verbs import MemoryRegion, QueuePair
        by_name = {e["name"]: e for e in manifest["leaves"]}
        pairs = _flatten_with_path(like)
        out = []
        with QueuePair(node) as qp:
            for path, leaf in pairs:
                name = _leaf_name(path)
                if name not in by_name:
                    raise KeyError(f"leaf {name} missing from far "
                                   f"snapshot")
                e = by_name[name]
                raw = np.zeros(max(e["nbytes"], 1), np.uint8)
                qp.read(MemoryRegion(raw), 0, e["addr"],
                        max(e["nbytes"], 1))
                raw = raw[:e["nbytes"]]
                if self.digest and "sha256" in e and \
                        _digest(raw) != e["sha256"]:
                    raise IOError(f"far digest mismatch for {name}")
                if tuple(e["shape"]) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch {name}: far "
                                     f"{tuple(e['shape'])} vs model "
                                     f"{tuple(leaf.shape)}")
                out.append(_from_bytes(raw, e["dtype"], e["shape"],
                                       leaf.device))
        return manifest["step"], tree_unflatten(tree_flatten(like)[1], out)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, n,
                                                "manifest.json")):
                out.append(int(n[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[int, Any]:
        """Restore into the structure of ``like``, each leaf on the
        device of ``like``'s leaf.  Verifies digests; raises on
        corruption so the caller's fault handler can fall back to an
        older step.  ``shardings`` (``(mesh, placements)`` per leaf, as
        ``repro_torch.sharding.tree_shardings`` gives, or one pair for
        every leaf) makes each restored leaf a DTensor: every rank reads
        the whole leaf into host memory and moves only its own slice to
        the mesh's device (``from_whole``), so no device holds a whole
        sharded leaf.  With ``shardings``, ``like`` may be abstract (meta
        tensors, as ``transformer.tree_abstract`` and
        ``AdamW.init_abstract`` give); without, its leaves' devices are
        where the leaves go."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        pairs = _flatten_with_path(like)
        shard = [None] * len(pairs) if shardings is None else \
            sharding_leaves(shardings, tree_flatten(like)[1], len(pairs))
        out = []
        for (path, leaf), sh in zip(pairs, shard):
            name = _leaf_name(path)
            if name not in by_name:
                raise KeyError(f"leaf {name} missing from checkpoint {step}")
            e = by_name[name]
            raw = np.load(os.path.join(d, name + ".npy"))
            if self.digest and "sha256" in e and \
                    _digest(raw) != e["sha256"]:
                raise IOError(f"digest mismatch for {name} @ step {step}")
            if tuple(e["shape"]) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch {name}: ckpt "
                                 f"{tuple(e['shape'])} vs model "
                                 f"{tuple(leaf.shape)}")
            if sh is not None:
                out.append(from_whole(_from_bytes(raw, e["dtype"],
                                                  e["shape"], "cpu"), *sh))
            elif leaf.device.type == "meta":
                raise ValueError(f"{name}: an abstract (meta) like needs "
                                 f"shardings to say where leaves go")
            else:
                out.append(_from_bytes(raw, e["dtype"], e["shape"],
                                       leaf.device))
        return step, tree_unflatten(tree_flatten(like)[1], out)

    def close(self) -> None:
        """Wait for a pending save; close the engine if this manager
        made it."""
        try:
            self.wait()
        finally:
            if self._owns_engine:
                self.engine.close()
