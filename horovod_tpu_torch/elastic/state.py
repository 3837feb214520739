"""Elastic state objects: commit / restore / sync.

The port of ``horovod_tpu/elastic/state.py``: ``State``, ``ObjectState``
and ``FileBackedState`` are copies over the port's ``broadcast_object``.
In place of the reference's ``JaxState`` (which imports jax) there is
:class:`TorchState`, shaped like the reference's torch binding
(``horovod_tpu/torch/elastic.py``; † ``horovod/torch/elastic/state.py``).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Callable

import torch

from ..utils.checkpoint import _map


class State:
    """Snapshot protocol: ``commit()`` at safe points, ``restore()`` on
    failure rollback, ``sync()`` after membership changes (re-broadcast from
    rank 0 so joining workers get current values)."""

    def __init__(self) -> None:
        self._reset_callbacks: list[Callable[[], None]] = []

    def register_reset_callbacks(self, callbacks) -> None:
        """† ``State.register_reset_callbacks`` — called after re-init
        (e.g. rebuild optimizer for a new world size)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        for cb in self._reset_callbacks:
            cb()

    def commit(self) -> None:
        self.save()
        self.check_host_updates()

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def check_host_updates(self) -> None:
        """Raise ``HostsUpdatedInterrupt`` when the driver signalled a
        membership change; wired up by the ``run`` decorator."""
        notifier = getattr(self, "_notifier", None)
        if notifier is not None:
            notifier.check()


class ObjectState(State):
    """Arbitrary picklable attributes († ``ObjectState``): everything set
    via ``__init__(**kwargs)`` or attribute assignment is snapshot."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._saved: dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self.save()

    def _public(self) -> dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def save(self) -> None:
        self._saved = copy.deepcopy(self._public())

    def restore(self) -> None:
        for k, v in copy.deepcopy(self._saved).items():
            setattr(self, k, v)

    def sync(self) -> None:
        import horovod_tpu_torch as hvd
        synced = hvd.broadcast_object(self._public(), root_rank=0)
        for k, v in synced.items():
            setattr(self, k, v)
        self.save()


class FileBackedState(ObjectState):
    """ObjectState whose commits also persist to disk.

    The elastic driver restarts the whole job on a membership change
    (:mod:`horovod_tpu_torch.runner.elastic`: blacklist + relaunch), so
    in-memory snapshots alone cannot carry training state across
    incarnations.  Rank 0 writes a JSON snapshot atomically at every
    ``save()``; every rank loads it at construction, so a relaunched job
    resumes from the last commit of the previous incarnation.  When the
    runtime is already initialized at more than one rank, construction
    ends with a ``sync()`` broadcasting rank 0's loaded values.  Values
    must be JSON-serializable; tensor trees belong in :class:`TorchState`
    and :class:`~horovod_tpu_torch.utils.checkpoint.Checkpointer`.
    """

    def __init__(self, path: str, **kwargs: Any) -> None:
        stored: dict[str, Any] = {}
        if os.path.exists(path):
            with open(path) as f:
                stored = json.load(f)
        self._path = path          # before super().__init__ calls save()
        self._resumed = bool(stored)
        super().__init__(**{**kwargs, **stored})
        import horovod_tpu_torch as hvd
        if hvd.is_initialized() and hvd.size() > 1:
            self.sync()
            # All ranks must agree whether this is a resume (rank 0's
            # file is the authoritative one) or control flow diverges.
            self._resumed = bool(
                hvd.broadcast_object(self._resumed, root_rank=0))

    @property
    def resumed(self) -> bool:
        """True when construction loaded a previous incarnation's commit."""
        return self._resumed

    def save(self) -> None:
        super().save()
        import horovod_tpu_torch as hvd
        if hvd.is_initialized() and hvd.rank() != 0:
            return                 # † rank-0-only checkpoint convention
        tmp = f"{self._path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self._public(), f)
        os.replace(tmp, self._path)


def _has_tensor(value: Any) -> bool:
    found = [False]

    def look(leaf, _):
        found[0] = found[0] or isinstance(leaf, torch.Tensor)
        return leaf
    _map(value, look)
    return found[0]


def _named_leaves(tree: Any, prefix: str) -> list:
    """``(name, tensor)`` for every tensor of a nest of dicts, lists and
    tuples, in a deterministic order."""
    out: list = []
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out += _named_leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += _named_leaves(v, f"{prefix}.{i}")
    elif isinstance(tree, torch.Tensor):
        out.append((prefix, tree))
    return out


def _snap(leaf: Any, old: Any = None) -> Any:
    """``leaf`` in host memory: a tensor into the previous snapshot's
    buffer when it fits (pinned for a CUDA tensor, so the copy is
    asynchronous; :meth:`TorchState.save` synchronizes once), anything
    else deep-copied."""
    if not isinstance(leaf, torch.Tensor):
        return copy.deepcopy(leaf)
    src = leaf.detach()
    if not (isinstance(old, torch.Tensor) and old.shape == src.shape
            and old.dtype == src.dtype and old.device.type == "cpu"):
        old = torch.empty(src.shape, dtype=src.dtype,
                          pin_memory=src.is_cuda)
    old.copy_(src, non_blocking=src.is_cuda)
    return old


def _optimizer_state_fits(inner, saved: dict) -> bool:
    params = [p for g in inner.param_groups for p in g["params"]]
    if len(saved["param_groups"]) != len(inner.param_groups) or \
            set(saved["state"]) != {i for i, p in enumerate(params)
                                    if p in inner.state}:
        return False
    for i, st in saved["state"].items():
        live = inner.state[params[i]]
        if set(live) != set(st):
            return False
        for k, v in st.items():
            cur = live[k]
            if isinstance(v, torch.Tensor) != isinstance(cur, torch.Tensor) \
                    or (isinstance(v, torch.Tensor)
                        and (v.shape != cur.shape or v.dtype != cur.dtype)):
                return False
    return True


def _restore_optimizer(inner, saved: dict) -> None:
    """The snapshot's state into the optimizer: into its live state
    tensors when they have the snapshot's layout (no allocation, every
    reference to them stays valid), else through ``load_state_dict``."""
    if not _optimizer_state_fits(inner, saved):
        inner.load_state_dict(_map(saved, _snap))
        return
    params = [p for g in inner.param_groups for p in g["params"]]
    for i, st in saved["state"].items():
        live = inner.state[params[i]]
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                live[k].copy_(v, non_blocking=True)
            else:
                live[k] = copy.deepcopy(v)
    for group, sg in zip(inner.param_groups, saved["param_groups"]):
        for k, v in sg.items():
            if k != "params":
                group[k] = copy.deepcopy(v)


def _sync_host_copies() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class TorchState(State):
    """Tensor state with host-memory snapshots († ``TorchState``):
    ``TorchState(model=..., optimizer=..., **values)``.

    - ``model`` (an ``nn.Module``) and ``optimizer`` (a
      ``torch.optim.Optimizer``, or the port's distributed wrappers) are
      snapshot through their ``state_dict``;
    - a keyword value holding tensors (a dict of tensors such as the
      port's Llama parameters, or any nest of dicts, lists and tuples) is
      a *tree*: committed leaf by leaf and restored in place, so every
      view and optimizer reference of a leaf stays valid;
    - any other keyword value follows ``ObjectState`` semantics.

    ``commit()`` copies everything to host memory (pinned buffers, kept
    from one commit to the next, for tensors on the card), so a snapshot
    survives the runtime's teardown.  ``restore()`` rolls back to it, in
    place: the leaves of trees, the model's tensors and the optimizer's
    state tensors keep their storage (no device memory is allocated), and
    ``sync()`` re-broadcasts current values; both then broadcast rank 0's
    values through the port's ``broadcast_parameters`` and
    ``broadcast_optimizer_state``, onto each tensor's own device.
    """

    def __init__(self, model: torch.nn.Module | None = None,
                 optimizer: torch.optim.Optimizer | None = None,
                 **kwargs: Any) -> None:
        super().__init__()
        self._model = model
        self._optimizer = optimizer
        self._trees: dict[str, Any] = {}
        self._objects: dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._saved: dict[str, Any] = {}
        self.save()

    # -- attribute plumbing: state.epoch etc. read/write the dicts --

    def __getattr__(self, name: str) -> Any:
        if name == "model":
            return self.__dict__["_model"]
        if name == "optimizer":
            return self.__dict__["_optimizer"]
        for table in ("_trees", "_objects"):
            values = self.__dict__.get(table, {})
            if name in values:
                return values[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            super().__setattr__(name, value)
        elif name == "model":
            self._model = value
        elif name == "optimizer":
            self._optimizer = value
        elif _has_tensor(value):
            self._objects.pop(name, None)
            self._trees[name] = value
        else:
            self._trees.pop(name, None)
            self._objects[name] = value

    def _inner_optimizer(self):
        return getattr(self._optimizer, "_inner", self._optimizer)

    # -- State protocol --

    def save(self) -> None:
        old = self._saved
        snap: dict[str, Any] = {
            "objects": copy.deepcopy(self._objects),
            "trees": {k: _map(v, _snap, old.get("trees", {}).get(k))
                      for k, v in self._trees.items()}}
        if self._model is not None:
            snap["model"] = _map(self._model.state_dict(), _snap,
                                 old.get("model"))
        if self._optimizer is not None:
            snap["optimizer"] = _map(self._inner_optimizer().state_dict(),
                                     _snap, old.get("optimizer"))
        _sync_host_copies()
        self._saved = snap

    def _load_saved(self) -> None:
        snap = self._saved
        self._objects = copy.deepcopy(snap["objects"])
        with torch.no_grad():
            for k, host in snap["trees"].items():
                live = dict(_named_leaves(self._trees.get(k), k))
                for name, t in _named_leaves(host, k):
                    live[name].copy_(t, non_blocking=True)
            if self._model is not None and "model" in snap:
                self._model.load_state_dict(snap["model"])
            if self._optimizer is not None and "optimizer" in snap:
                _restore_optimizer(self._inner_optimizer(),
                                   snap["optimizer"])
        # the host buffers are written again by the next commit
        _sync_host_copies()

    def _broadcast(self) -> None:
        import horovod_tpu_torch as hvd
        if not hvd.is_initialized():
            return
        named: list = []
        for k in sorted(self._trees):
            named += _named_leaves(self._trees[k], k)
        if self._model is not None:
            named += [(f"model.{k}", v) for k, v in
                      self._model.state_dict().items()
                      if isinstance(v, torch.Tensor)]
        if named:
            hvd.broadcast_parameters(named, root_rank=0)
        if self._optimizer is not None:
            hvd.broadcast_optimizer_state(self._optimizer, root_rank=0)
        self._objects = hvd.broadcast_object(
            self._objects, root_rank=0, name="TorchState.objects")

    def restore(self) -> None:
        self._load_saved()
        self._broadcast()

    def sync(self) -> None:
        self._broadcast()
        self.save()
