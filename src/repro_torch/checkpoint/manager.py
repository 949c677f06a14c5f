"""Checkpointing (counterpart of ``repro/checkpoint/manager.py``), in
the reference's on-disk format: ``<root>/step_<n>/{arrays.npz,
manifest.json, COMPLETE}``, each leaf stored under its tree path
(``repro_torch.tree``: ``0/blocks/slot0/attn/q/w`` for the stacked
parameters of a ``(params, opt_state)`` pair). A checkpoint of the port
restores with ``repro.checkpoint.restore_tree`` and the reverse.

* **Atomicity**: a snapshot is written to ``step_<n>.tmp-<pid>`` with a
  marker file last, then renamed into place; an existing snapshot is
  renamed aside first and dropped after, so at no instant does the path
  name a partial snapshot, and ``steps()`` sees complete ones only.
* **Async**: ``save_async`` copies every leaf to host memory now (a new
  buffer even for a CPU tensor: the optimizer updates its tensors in
  place, and a writer sharing their storage would race the next step)
  and writes to disk on a daemon thread; ``wait()`` joins it.
* **Device-agnostic restore**: leaves come back as tensors in the
  dtypes of a ``like`` tree, on the device asked for, or -- given a
  ``DeviceMesh`` and placements, in place of the reference's shardings
  -- as DTensors on that mesh, so a checkpoint written from one mesh
  restores onto another (elastic scaling).
* **Sharded saves**: a tree of DTensors is gathered whole on every rank
  (each rank must save the same tree) and written by rank 0 alone; a
  synchronous save then waits at a barrier for the write.
* **Retention**: keep the newest ``keep`` snapshots.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree as tree_lib

_MARKER = "COMPLETE"


class CorruptCheckpointError(RuntimeError):
    """A checkpoint directory carries the COMPLETE marker but its
    manifest or array payload does not load (bit rot, a truncated copy,
    a concurrent writer): distinct from FileNotFoundError, which means
    there is no checkpoint."""


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf that shares no storage with it (a DTensor
    gathered whole: a collective over its mesh)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _sharded(tree: Any) -> bool:
    return any(isinstance(leaf, DTensor) for leaf in tree_lib.leaves(tree))


def _writes(sharded: bool) -> bool:
    """Whether this process writes: always, but for a sharded tree rank 0 only."""
    return not sharded or dist.get_rank() == 0


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {tree_lib.key(path): leaf for path, leaf in tree_lib.leaves_with_paths(tree)}


def save_tree(path: str, tree: Any, extra: dict | None = None) -> None:
    """Atomic snapshot of a tree (tensor, DTensor or numpy leaves) into
    ``path``."""
    sharded = _sharded(tree)
    flat = {k: v if isinstance(v, np.ndarray) else _host(v) for k, v in _flatten(tree).items()}
    if _writes(sharded):
        _write(path, flat, extra)
    if sharded:
        dist.barrier()


def _write(path: str, flat: dict[str, np.ndarray], extra: dict | None) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"keys": list(flat), "extra": extra or {}}, f)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
    # the old snapshot goes aside before the new one goes in; the aside
    # name never parses as a step
    old = f"{path}.old-{os.getpid()}"
    shutil.rmtree(old, ignore_errors=True)  # stale aside from a crash
    if os.path.isdir(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def restore_tree(path: str, like: Any, device=None, *, placements=None,
                 mesh=None) -> tuple[Any, dict]:
    """Restore into the structure, shapes and dtypes of ``like`` (a tree
    of tensors; ``meta`` ones say shapes and dtypes only). Leaves land on
    ``device``, or else on the ``like`` leaf's device -- or, given a
    ``DeviceMesh`` ``mesh``, as DTensors on it with ``placements`` (one
    sequence of placements for every leaf, or a tree of them shaped as
    ``like``; ``distributed.to_placements`` makes them from specs), on
    the mesh's device type."""
    if mesh is not None:
        device = torch.device(mesh.device_type)
    if not os.path.exists(os.path.join(path, _MARKER)):
        raise FileNotFoundError(f"no complete checkpoint at {path}")
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(
            f"checkpoint at {path} is marked complete but its manifest "
            f"({manifest_path}) does not load: {e}"
        ) from e
    npz_path = os.path.join(path, "arrays.npz")
    try:
        data = np.load(npz_path)
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(
            f"checkpoint at {path} is marked complete but its array "
            f"payload ({npz_path}) does not load: {e}"
        ) from e

    def leaf(path_keys, like_leaf):
        key = tree_lib.key(path_keys)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        if tuple(arr.shape) != tuple(like_leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(like_leaf.shape)}")
        t = torch.from_numpy(arr).to(device=device or like_leaf.device, dtype=like_leaf.dtype)
        if mesh is None:
            return t
        return distribute_tensor(t, mesh, _leaf_placements(placements, path_keys))

    with data:
        tree = tree_lib.map_with_path(leaf, like)
    return tree, manifest["extra"]


def _leaf_placements(placements, path: tuple[str, ...]):
    if isinstance(placements, dict):
        return tree_lib.get(placements, path)
    return placements


class CheckpointManager:
    """Directory layout: ``<root>/step_<n>/{arrays.npz,manifest.json,COMPLETE}``."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(root, exist_ok=True)

    # -- discovery ---------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and os.path.exists(os.path.join(self.root, name, _MARKER)):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()
        save_tree(self._dir(step), tree, dict(extra or {}, step=step))
        if _writes(_sharded(tree)):
            self._gc()

    def save_async(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """Copy every leaf to host memory now, write to disk on a daemon
        thread."""
        self.wait()
        sharded = _sharded(tree)
        host_tree = tree_lib.tree_map(_host, tree)
        if not _writes(sharded):
            return

        def _work():
            try:
                save_tree(self._dir(step), host_tree, dict(extra or {}, step=step))
                self._gc()
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the writer; a write that failed raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore -------------------------------------------------------------
    def restore(self, like: Any, step: int | None = None, device=None, *, placements=None,
                mesh=None) -> tuple[Any, dict]:
        """The newest (or ``step``'s) snapshot, as :func:`restore_tree`."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_tree(self._dir(step), like, device, placements=placements, mesh=mesh)

    # -- retention -----------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)
