"""Checkpoint and resume of tensor trees.

The port of ``horovod_tpu/utils/checkpoint.py``, which wraps orbax; the
port keeps its API (``Checkpointer(directory, max_to_keep=,
single_process=, read_only=)``, ``save``, ``latest_step``, ``restore``,
``all_steps``, ``close``) over ``torch.save`` and ``torch.load``:

- each step is a directory ``<directory>/<step>/`` holding ``tree.pt``,
  a nest of dicts, lists and tuples whose leaves are tensors and Python
  scalars;
- a save writes into ``<step>.tmp-<pid>`` and renames it, so a reader
  never sees a half-written step;
- rank 0 writes (``single_process=True``: this process writes, whatever
  its rank); ``max_to_keep`` prunes the oldest steps after each save;
- a writable checkpointer sweeps stale tmp directories when it opens; a
  ``read_only`` one never does, so it cannot race a writer's save;
- ``restore(target=...)`` puts every tensor on the device of the target's
  leaf at the same place (the CPU without a target).

``save(..., wait=False)`` copies the tree to host memory at once (so the
caller may go on changing it) and writes in a background thread;
:meth:`Checkpointer.wait_until_finished` or the next save waits for it.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional

import torch

_TREE = "tree.pt"


def _map(tree: Any, fn, target: Any = None) -> Any:
    """``fn(leaf, target_leaf)`` over a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, target.get(k) if isinstance(target, dict)
                        else None) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        tl = target if isinstance(target, (list, tuple)) and \
            len(target) == len(tree) else [None] * len(tree)
        return type(tree)(_map(v, fn, t) for v, t in zip(tree, tl))
    return fn(tree, target)


def _to_host(leaf: Any, _=None) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


def _to_target(leaf: Any, target: Any) -> Any:
    if isinstance(leaf, torch.Tensor) and isinstance(target, torch.Tensor):
        return leaf.to(target.device)
    return leaf


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensors of a tree."""
    total = [0]

    def add(leaf, _):
        if isinstance(leaf, torch.Tensor):
            total[0] += leaf.numel() * leaf.element_size()
        return leaf
    _map(tree, add)
    return total[0]


class Checkpointer:
    """Step directories of tensor trees, written by one process.

    Usage::

        ckpt = Checkpointer("/path/ckpts")
        ckpt.save(step, {"params": params, "opt_state": opt_state})
        restored = ckpt.restore(target={"params": params, ...})
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 single_process: bool = False,
                 read_only: bool = False) -> None:
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._single_process = single_process
        self._read_only = read_only
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self._dir, exist_ok=True)
        if not read_only:
            for name in os.listdir(self._dir):
                if ".tmp-" in name:
                    shutil.rmtree(os.path.join(self._dir, name),
                                  ignore_errors=True)

    def _writes(self) -> bool:
        if self._read_only:
            return False
        if self._single_process:
            return True
        from .. import context
        return not context.is_initialized() or context.rank() == 0

    def save(self, step: int, tree: Any, *, wait: bool = True) -> None:
        """Write ``tree`` as ``step`` (on the writing process only)."""
        if not self._writes():
            return
        self.wait_until_finished()
        host = _map(tree, _to_host)
        if wait:
            self._write(int(step), host)
            return
        self._writer = threading.Thread(
            target=self._write_bg, args=(int(step), host), daemon=True,
            name="hvdtpu-checkpoint")
        self._writer.start()

    def _write_bg(self, step: int, host: Any) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # surfaced by wait_until_finished
            self._error = e

    def _write(self, step: int, host: Any) -> None:
        final = os.path.join(self._dir, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _TREE), "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        fd = os.open(self._dir, os.O_RDONLY)     # the rename, durable
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if self._max_to_keep > 0:
            for old in self.all_steps()[:-self._max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Wait for a ``wait=False`` save; re-raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def all_steps(self) -> list[int]:
        """Finished steps, oldest first."""
        steps = []
        for name in os.listdir(self._dir):
            if name.isdigit() and os.path.exists(
                    os.path.join(self._dir, name, _TREE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                target: Optional[Any] = None) -> Any:
        """The tree of ``step`` (default the latest), its tensors on the
        devices of ``target``'s leaves (CPU without a target)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        with open(os.path.join(self._dir, str(step), _TREE), "rb") as f:
            tree = torch.load(f, map_location="cpu", weights_only=True)
        return tree if target is None else _map(tree, _to_target, target)

    def close(self) -> None:
        self.wait_until_finished()
