"""``DistributedOptimizer`` and the parameter and state broadcasts.

The port of ``horovod_tpu/torch/__init__.py`` (``broadcast_parameters``
:167, ``broadcast_optimizer_state`` :184, ``_DistributedOptimizer``
:209-420; † ``horovod/torch/optimizer.py``): each parameter's
post-accumulate-grad hook enqueues an in-place async allreduce of its
gradient as soon as backward has produced it, so the collectives overlap
the rest of backward; ``step()`` synchronizes every handle and then runs
the wrapped optimizer.

The reference moved every gradient torch → numpy → jax and staged host
buckets (:49-68, :213-226).  Here gradients stay on the card: the hook
hands ``p.grad`` itself to the engine, whose fusion takes the buckets'
place, and the allreduce writes the average back into it.

Names must match across ranks, since every gradient is negotiated by
name: ``named_parameters`` gives them, and without it a parameter is
named by its position in ``param_groups`` (the reference's fallback,
``param.{id(p)}``, differs between processes and deadlocks).
"""

from __future__ import annotations

import weakref
from typing import Any, Optional

import torch

from .. import context
from ..ops.collectives import Average, ReduceOp
from ..ops.compression import Compression, routes_engine_side


def _named_tensors(params: Any) -> list:
    """``(name, tensor)`` pairs from a ``state_dict``-like mapping (sorted
    by name, as upstream sorts it) or an iterable of pairs."""
    if isinstance(params, dict):
        items = sorted(params.items())
    else:
        items = list(params)
    return [(str(k), v) for k, v in items if isinstance(v, torch.Tensor)]


def _broadcast_all(named: list, root_rank: int, prefix: str) -> None:
    """Broadcast every tensor in place from ``root_rank``: one async
    in-place broadcast each, then one synchronize each.  A tensor on
    another device than the runtime's (the CPU ``step`` counter of a
    non-fused Adam on a CUDA runtime) goes through a copy there."""
    import horovod_tpu_torch as hvd
    dev = context.global_state().device
    pending = []
    for name, t in named:
        staged = t.detach() if t.device == dev else t.detach().to(dev)
        pending.append((t, staged, hvd.broadcast_async_(
            staged, root_rank, name=f"{prefix}.{name}")))
    for t, staged, handle in pending:
        hvd.synchronize(handle)
        if staged.data_ptr() != t.data_ptr():
            with torch.no_grad():
                t.copy_(staged)


def broadcast_parameters(params: Any, root_rank: int = 0) -> None:
    """Overwrite every rank's parameters with the root's, in place
    († ``hvd.broadcast_parameters``).  ``params`` is a ``state_dict`` or an
    iterable of ``(name, tensor)`` pairs, e.g.
    ``model.named_parameters()`` or ``llama.named_trainable(params)``."""
    _broadcast_all(_named_tensors(params), root_rank, "broadcast_parameters")


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Overwrite every rank's optimizer state with the root's
    († ``hvd.broadcast_optimizer_state``): tensor state in place, the
    rest (Python scalars) as one object."""
    import horovod_tpu_torch as hvd
    inner = getattr(optimizer, "_inner", optimizer)
    named, scalars = [], {}
    for gi, group in enumerate(inner.param_groups):
        for pi, p in enumerate(group["params"]):
            for key, val in sorted(inner.state.get(p, {}).items()):
                slot = f"g{gi}.p{pi}.{key}"
                if isinstance(val, torch.Tensor):
                    named.append((slot, val))
                else:
                    scalars[slot] = (p, key, val)
    _broadcast_all(named, root_rank, "broadcast_optimizer_state")
    if scalars:
        synced = hvd.broadcast_object(
            {k: v[2] for k, v in scalars.items()}, root_rank,
            name="broadcast_optimizer_state.scalars")
        for k, (p, key, _) in scalars.items():
            inner.state[p][key] = synced[k]


class _DistributedOptimizer(torch.optim.Optimizer):
    """† ``horovod/torch/optimizer.py _DistributedOptimizer``: gradient
    hooks enqueue async allreduces during backward; ``step()``
    synchronizes and applies the averaged gradients."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, op: ReduceOp = Average,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 bucket_cap_bytes: Optional[int] = None) -> None:
        if bucket_cap_bytes is not None and (
                isinstance(bucket_cap_bytes, bool)
                or not isinstance(bucket_cap_bytes, int)
                or bucket_cap_bytes < 1):
            raise ValueError(f"bucket_cap_bytes must be None or a positive "
                             f"int, got {bucket_cap_bytes!r}")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._inner = optimizer
        self.op = op
        self._compression = compression
        self._bpps = backward_passes_per_step
        self.bucket_cap_bytes = bucket_cap_bytes
        params = [p for group in optimizer.param_groups
                  for p in group["params"]]
        if named_parameters is not None:
            named = list(named_parameters)
            names = [n for n, _ in named]
            if len(set(names)) != len(names):
                raise ValueError("named_parameters holds a name twice")
            self._names = {id(p): n for n, p in named}
            unnamed = [i for i, p in enumerate(params)
                       if id(p) not in self._names]
            if unnamed:
                raise ValueError(
                    f"named_parameters names {len(named)} tensors but not "
                    f"the optimizer's parameters at positions "
                    f"{unnamed[:5]}; every rank negotiates each gradient "
                    "by its name")
        else:
            self._names = {id(p): f"g{gi}.p{pi}"
                           for gi, group in enumerate(optimizer.param_groups)
                           for pi, p in enumerate(group["params"])}
        self._params = [p for p in params if p.requires_grad]
        self._pass_counts: dict = {}
        # param -> (handle, compression ctx, wire tensor) of this step
        self._handles: dict = {}
        # The hook holds the optimizer weakly: a parameter's hook that held
        # it strongly would make a cycle through the autograd hooks, which
        # the garbage collector does not see, and a dropped model with its
        # optimizer (parameters, gradients, Adam's moments) would never be
        # freed.
        me = weakref.ref(self)

        def hook(p: torch.Tensor) -> None:
            opt = me()
            if opt is not None:
                opt._hook(p)

        self._hook_handles = [p.register_post_accumulate_grad_hook(hook)
                              for p in self._params]

    # the wrapped optimizer's surface
    @property
    def param_groups(self):
        return self._inner.param_groups

    @param_groups.setter
    def param_groups(self, value):
        self._inner.param_groups = value

    @property
    def state(self):
        return self._inner.state

    def _name_of(self, p: torch.Tensor) -> str:
        return self._names[id(p)]

    def _hook(self, p: torch.Tensor) -> None:
        import horovod_tpu_torch as hvd
        # Local gradient aggregation († backward_passes_per_step): torch
        # sums into p.grad across backwards; the collective fires on the
        # Nth pass, carrying the sum / N.
        count = self._pass_counts.get(p, 0) + 1
        self._pass_counts[p] = count
        if count < self._bpps:
            return
        self._pass_counts[p] = 0
        if p in self._handles:
            raise RuntimeError(
                f"gradient for {self._name_of(p)} reduced twice before "
                "step(); call step() once per backward_passes_per_step "
                "backward passes († duplicate in-flight name check)")
        grad = p.grad
        if self._bpps > 1:
            grad.div_(self._bpps)
        name = f"grad.{self._name_of(p)}"
        if routes_engine_side(self._compression):
            # Quantized inside the collective, into p.grad.
            wire, ctx = grad, None
            handle = hvd.allreduce_async_(grad, self.op, name=name,
                                          compression=self._compression)
        else:
            wire, ctx = self._compression.compress(grad)
            handle = hvd.allreduce_async_(wire, self.op, name=name)
        self._handles[p] = (handle, ctx, wire)

    def synchronize(self) -> None:
        """Wait for every gradient's allreduce of this step and write the
        results into ``p.grad`` († ``synchronize()``).  Raises when a
        parameter's gradient was not reduced this step."""
        import horovod_tpu_torch as hvd
        missing = [self._name_of(p) for p in self._params
                   if p not in self._handles]
        try:
            for p, (handle, ctx, wire) in self._handles.items():
                out = hvd.synchronize(handle)
                if wire is not p.grad:
                    with torch.no_grad():
                        p.grad.copy_(self._compression.decompress(out, ctx))
        finally:
            self._handles.clear()
        if missing:
            raise RuntimeError(
                f"step() before every gradient was reduced: no gradient "
                f"this step for {len(missing)} parameter(s), e.g. "
                f"{missing[:3]}; every rank must reduce every gradient "
                "each step")

    def step(self, closure=None):
        if self._bpps > 1 and any(self._pass_counts.values()):
            raise RuntimeError(
                f"step() called after "
                f"{max(self._pass_counts.values())} backward passes; "
                f"backward_passes_per_step={self._bpps} requires exactly "
                f"{self._bpps} († optimizer.step() assertion)")
        self.synchronize()
        return self._inner.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        if self._handles:
            raise RuntimeError(
                "zero_grad() between backward and step(): the gradients' "
                "allreduces are still in flight")
        return self._inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, sd):
        return self._inner.load_state_dict(sd)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None, op: ReduceOp = Average,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         bucket_cap_bytes: Optional[int] = None
                         ) -> _DistributedOptimizer:
    """† ``hvd.DistributedOptimizer`` for torch: wrap ``optimizer`` so
    that every gradient is averaged (``op``) across ranks before its
    update.  ``compression`` casts gradients for the wire
    (``Compression.fp16``/``bf16``) or quantizes them inside the
    collective (``Compression.int8``/``fp8``).  With ``op=hvd.Adasum``
    every gradient is its own Adasum allreduce (the projection is not
    elementwise, so the engine never fuses two).
    ``backward_passes_per_step`` sums
    that many backward passes locally before one allreduce.

    ``bucket_cap_bytes`` is accepted for the JAX package's signature and
    checked (None or a positive int), and it governs nothing here: the
    reference staged gradients into host buckets of that size, one
    transfer and one collective each.  In the port gradients never leave
    the card, and the engine's fusion threshold (``fusion_threshold``,
    ``HVDTPU_FUSION_THRESHOLD``) decides which gradients share one
    collective, so the averaged gradients are the same with or without
    it."""
    return _DistributedOptimizer(
        optimizer, named_parameters=named_parameters, op=op,
        compression=compression,
        backward_passes_per_step=backward_passes_per_step,
        bucket_cap_bytes=bucket_cap_bytes)
