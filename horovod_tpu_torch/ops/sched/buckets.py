"""Bucketed gradient reduction: the Horovod fusion-buffer analogue.

The port of ``horovod_tpu/ops/sched/buckets.py``, sized by
``HVDTPU_BUCKET_BYTES`` (``cfg.bucket_bytes``; <= 0 means one bucket per
dtype):

- :func:`bucketed_distributed_gradients`: the gradients are grouped into
  size-targeted buckets; each bucket's tensors are enqueued on the async
  engine and the engine is nudged at once, so bucket *b*'s collective is
  issued while bucket *b+1* is still being enqueued.  The entries are
  ordinary engine entries (negotiation, ``wp``/``sc`` metas, join).
- :func:`attach_gradient_reduction`: the reference's ``custom_vjp``
  bucket boundary inside jit becomes a boundary on the autograd graph: an
  identity ``autograd.Function`` over each bucket's tensors whose
  backward reduces the bucket's gradients through one
  :func:`~.in_context.overlap_allreduce` chain each, as soon as backward
  has produced all of them.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch


def _resolved_bucket_bytes(bucket_bytes: Optional[int]) -> int:
    if bucket_bytes is not None:
        return int(bucket_bytes)
    from ...context import global_state
    from ... import config as config_mod
    state = global_state()
    cfg = state.config if state.initialized else config_mod.Config()
    return int(getattr(cfg, "bucket_bytes", 0) or 0)


def plan_buckets(leaves: Sequence[torch.Tensor],
                 bucket_bytes: Optional[int] = None) -> list:
    """Group tensor *indices* into size-targeted buckets: greedy in order
    (the order backward produces gradients), never mixing dtypes; a
    bucket closes when the next same-dtype tensor would push it past the
    target, and one oversized tensor gets its own.  Returns
    ``[[index, ...], ...]``."""
    target = _resolved_bucket_bytes(bucket_bytes)
    open_by_dtype: dict = {}
    order: list = []
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        cur = open_by_dtype.get(leaf.dtype)
        if cur is not None and target > 0 and \
                cur["bytes"] + nbytes > target:
            cur = None
        if cur is None:
            cur = {"idx": [], "bytes": 0}
            open_by_dtype[leaf.dtype] = cur
            order.append(cur)
        cur["idx"].append(i)
        cur["bytes"] += nbytes
    return [b["idx"] for b in order]


def bucketed_distributed_gradients(grads: Any, op=None, *, compression=None,
                                   process_set=None,
                                   bucket_bytes: Optional[int] = None,
                                   name: str = "bucketed") -> Any:
    """Reduce this rank's gradients (a list or a dict of tensors) bucket
    by bucket through the engine; returns them reduced in the same
    structure.  The same results as one allreduce each (same entries,
    fusion, negotiation and wire-mode rules), but each bucket's entries
    are issued as soon as they are enqueued.  Names are ``<name>.<key>``,
    the same on every rank."""
    import horovod_tpu_torch as hvd
    from ..compression import Compression, routes_engine_side
    if op is None:
        op = hvd.Average
    if compression is None:
        compression = Compression.none
    keys = list(grads) if isinstance(grads, dict) else range(len(grads))
    leaves = [grads[k] for k in keys]
    engine_side = routes_engine_side(compression) or \
        isinstance(compression, str)
    handles: list = [None] * len(leaves)
    ctxs: list = [None] * len(leaves)
    for bucket in plan_buckets(leaves, bucket_bytes):
        for i in bucket:
            if engine_side:
                wire = leaves[i]
            else:
                wire, ctxs[i] = compression.compress(leaves[i])
            handles[i] = hvd.allreduce_async(
                wire, op, name=f"{name}.{keys[i]}", process_set=process_set,
                compression=compression if engine_side else None)
        # Wake the cycle thread now instead of waiting out cycle_time_ms.
        hvd.global_state().engine.nudge()
    reduced = [hvd.synchronize(h) if engine_side
               else compression.decompress(hvd.synchronize(h), ctx)
               for h, ctx in zip(handles, ctxs)]
    if isinstance(grads, dict):
        return dict(zip(keys, reduced))
    return reduced


class _Boundary(torch.autograd.Function):
    """Identity forward; the backward reduces the bucket's gradients."""

    @staticmethod
    def forward(ctx, reduce_fn, *tensors):
        ctx.reduce_fn = reduce_fn
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(
            None if g is None else ctx.reduce_fn(g) for g in grads)


def attach_gradient_reduction(params: Sequence[torch.Tensor], group=None, *,
                              average: bool = True, mode: str = "fp32",
                              chunks: int = 2, block: int = 512,
                              bucket_bytes: Optional[int] = None) -> list:
    """Bucket boundaries on the autograd graph: returns ``params`` as
    tensors equal to them whose gradients come back reduced across
    ``group``, bucket by bucket, each gradient through one
    :func:`~.in_context.overlap_allreduce` chain.  Use the returned
    tensors in the forward; the values and the forward are untouched."""
    from .in_context import overlap_allreduce
    params = list(params)

    def reduce_fn(g):
        return overlap_allreduce(g.contiguous(), group, average=average,
                                 mode=mode, chunks=chunks, block=block)

    out = list(params)
    for bucket in plan_buckets(params, bucket_bytes):
        wrapped = _Boundary.apply(reduce_fn, *(params[i] for i in bucket))
        for j, i in enumerate(bucket):
            out[i] = wrapped[j]
    return out
