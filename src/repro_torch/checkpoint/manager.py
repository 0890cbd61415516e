"""Atomic, retained, pinnable checkpoints of nested run state.

The twin of ``repro/checkpoint/manager.py``, with the same on-disk layout,
so either package restores a step the other wrote:

    <root>/step_<n:08d>/shards.npz      one array ``leaf_<i>`` per leaf
    <root>/step_<n:08d>/manifest.json   step, leaf names, dtypes, shapes
    <root>/pin_<n:08d>                  retention pin (durable marker)

* **Atomicity**: a step is written under ``step_<n>.tmp-<pid>`` and renamed
  into place after the manifest is fsync'd; a kill mid-write leaves the
  previous steps intact, and ``.tmp`` or manifest-less directories are
  skipped and garbage-collected.
* **Names**: leaves are named by ``_tree.flatten_with_names`` (dict keys and
  child indices joined by ``/``), the names the reference writes.
* **bf16**: numpy has no bfloat16 (and the card's machine has no
  ``ml_dtypes``), so a bf16 tensor is stored as its uint16 bits with
  ``"bfloat16"`` in the manifest; the reference's flat-byte form of the
  same values reads back too.
* **Async**: ``save(..., blocking=False)`` copies every leaf to host memory
  on the calling thread and writes on a worker thread, so the caller may
  overwrite its buffers (the next chunk's slice of the error trace) as
  soon as ``save`` returns.
* **Retention**: ``keep_last`` newest steps survive garbage collection, and
  so does every pinned step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from .. import _tree
from ..models.sharding import MeshShape, shard_tree
from ..obs import get_journal

__all__ = ["CheckpointManager", "save_tree", "restore_tree"]

_MANIFEST = "manifest.json"


def _to_host(leaf) -> np.ndarray:
    """A fresh host copy of one leaf (bf16 tensors as their uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16).copy()
        return t.cpu().numpy().copy()
    return np.array(leaf)


def _host_tree(tree):
    """(names, host arrays, dtype names) of ``tree``."""
    names, leaves, _ = _tree.flatten_with_names(tree)
    host = [_to_host(leaf) for leaf in leaves]
    dtypes = ["bfloat16" if isinstance(leaf, torch.Tensor)
              and leaf.dtype == torch.bfloat16 else h.dtype.name
              for leaf, h in zip(leaves, host)]
    return names, host, dtypes


def _write(path: str, step: int, names: List[str], host: List[np.ndarray],
           dtypes: List[str]) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shards.npz"),
             **{f"leaf_{i}": h for i, h in enumerate(host)})
    manifest = {"step": step, "names": names, "dtypes": dtypes,
                "shapes": [list(h.shape) for h in host], "format": 1}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    try:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)                    # atomic publish
    except OSError:
        # a concurrent writer published the same step first: its snapshot
        # holds the same values, so this one is dropped
        if os.path.exists(os.path.join(path, _MANIFEST)):
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            raise


def save_tree(path: str, tree: Any, step: int) -> None:
    """Atomic write of a snapshot of ``tree`` into the step directory
    ``path``."""
    _write(path, step, *_host_tree(tree))


def _from_saved(arr: np.ndarray, dtype_name: str, shape):
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).reshape(shape)
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return arr


def _like(saved, like):
    """A restored leaf in the form of ``like``'s leaf: a tensor on its
    device (in the saved dtype), a numpy array, or a Python scalar."""
    if isinstance(like, torch.Tensor):
        t = saved if isinstance(saved, torch.Tensor) else torch.from_numpy(
            np.array(saved))
        return t.to(like.device)
    if isinstance(like, (bool, int, float)) and not isinstance(
            saved, torch.Tensor):
        return saved.item()
    return saved


def restore_tree(path: str, like: Any, *, mesh=None, specs=None) -> Any:
    """Load the snapshot in ``path`` into the structure of ``like`` (its
    leaf values are ignored; a tensor leaf gives the restored leaf's
    device). Raises ``ValueError`` if the leaf names differ.

    With ``mesh`` and ``specs`` the whole leaves are re-cut for that mesh:
    each tensor leaf becomes this rank's block under its spec
    (``models/sharding.shard_tree``). ``mesh`` is a ``launch/mesh.Mesh``
    (its shape and this rank's coordinates), or a pair (``MeshShape``,
    coordinates); the snapshot may have been written from any other mesh,
    as the reference's elastic restore re-shards a (4, 2) save onto (2, 4).
    """
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "shards.npz"))
    names, like_leaves, structure = _tree.flatten_with_names(like)
    if names != manifest["names"]:
        raise ValueError("checkpoint tree mismatch:\n saved=%s\n want=%s"
                         % (manifest["names"][:5], names[:5]))
    leaves = [_like(_from_saved(data[f"leaf_{i}"], manifest["dtypes"][i],
                                manifest["shapes"][i]), like_leaves[i])
              for i in range(len(names))]
    tree = _tree.unflatten(structure, leaves)
    if mesh is None or specs is None:
        return tree
    if isinstance(mesh, tuple):
        shape, coords = mesh
    else:
        shape, coords = MeshShape.from_mesh(mesh), mesh.coords
    return shard_tree(tree, specs, shape, coords)


class CheckpointManager:
    """Steps under ``root`` (module docstring for the layout).

    ``on_save`` (optional) is called with the step number at the top of
    every ``save``: the chunk-boundary hook for heartbeats and fault
    injection. ``pin(step)`` / ``unpin(step)`` exempt a step from
    ``keep_last`` retention through a durable ``pin_<n>`` file that other
    managers of the same root see.
    """

    def __init__(self, root: str, keep_last: int = 3, on_save=None):
        self.root = root
        self.keep_last = keep_last
        self.on_save = on_save
        os.makedirs(root, exist_ok=True)
        self._worker: Optional[threading.Thread] = None
        self._failed: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def _pin_path(self, step: int) -> str:
        return os.path.join(self.root, f"pin_{step:08d}")

    def pin(self, step: int) -> None:
        """Exempt ``step`` from GC until ``unpin`` (durable across restarts)."""
        with open(self._pin_path(step), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        get_journal().event("ckpt_pin", "checkpoint", step=step)

    def unpin(self, step: int) -> None:
        try:
            os.remove(self._pin_path(step))
        except FileNotFoundError:
            return
        get_journal().event("ckpt_unpin", "checkpoint", step=step)

    def pinned_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("pin_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def all_steps(self) -> List[int]:
        """Published steps: not a ``.tmp`` staging directory, manifest
        present."""
        out = []
        for name in os.listdir(self.root):
            full = os.path.join(self.root, name)
            if name.startswith("step_") and ".tmp" not in name \
                    and os.path.exists(os.path.join(full, _MANIFEST)):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        # the span opens before on_save fires, so a kill injected at the
        # boundary hook leaves its span_start unmatched in the journal
        sp = get_journal().begin("ckpt_save", "checkpoint", step=step,
                                 blocking=blocking)
        self.wait()                             # never two writers
        if self.on_save is not None:
            self.on_save(step)
        snapshot = _host_tree(tree)             # device -> host, this thread
        if blocking:
            self._save(step, snapshot)
        else:
            self._worker = threading.Thread(
                target=self._save_async, args=(step, snapshot), daemon=True)
            self._worker.start()
        sp.end()

    def _save(self, step: int, snapshot) -> None:
        _write(self._step_dir(step), step, *snapshot)
        self._gc()

    def _save_async(self, step: int, snapshot) -> None:
        try:
            self._save(step, snapshot)
        except BaseException as err:        # raised again by wait()
            self._failed = err
            return
        get_journal().event("ckpt_write", "checkpoint", step=step)

    def wait(self) -> None:
        """Join the writer of an async save; raise what it raised."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._failed is not None:
            err, self._failed = self._failed, None
            raise err

    def restore(self, like: Any, step: Optional[int] = None, *, mesh=None,
                specs=None):
        """(tree, step) of ``step`` (default: the latest), or (None, None)
        where there is none. ``mesh`` / ``specs``: re-cut for a mesh
        (``restore_tree``)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        with get_journal().span("ckpt_restore", "checkpoint", step=step):
            tree = restore_tree(self._step_dir(step), like, mesh=mesh,
                                specs=specs)
        return tree, step

    def _gc(self) -> None:
        for name in os.listdir(self.root):
            if ".tmp" in name:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        pinned = set(self.pinned_steps())
        removed = []
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            if s in pinned:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            removed.append(s)
        if removed:
            get_journal().event("ckpt_gc", "checkpoint", removed=removed,
                                pinned=sorted(pinned))
