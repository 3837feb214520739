"""The collective verbs on one rank's local tensor, over ``torch.distributed``.

The port of ``horovod_tpu/ops/collectives.py``.  There a per-rank tensor
is one global ``[num_ranks, *shape]`` array and every verb is a compiled
XLA program over the mesh; here each process holds its own rank's tensor,
as in upstream Horovod, and each verb is one or two ``torch.distributed``
calls (NCCL on the card, Gloo on the CPU) on that tensor.  Reduction kinds
mirror † ``horovod/common/common.h`` ``ReduceOp``.

These functions run on the engine's thread only (:mod:`.engine`), so the
collectives of every rank are issued in the negotiated order; user code
reaches them through the engine's verbs in the package root.  Each takes
the ``torch.distributed`` group and its size, and works in place on a
contiguous buffer where the verb allows it.

Semantics kept from the reference:

- ``AVERAGE`` is a sum, then a division by the group's size with the
  rounding XLA compiles it to (:func:`average_`), floor division for
  integers (collectives.py:258-263).  NCCL's ``ncclAvg``
  truncates integers toward zero, so it is not used.
- ``prescale``/``postscale`` multiply in the tensor's dtype before and
  after the reduction.
- ``PRODUCT`` gathers every rank's tensor and multiplies in rank order.
- ``ADASUM`` is :func:`.adasum.adasum_allreduce`; the wire modes and the
  decomposed schedule are :mod:`.reduction` and :mod:`.sched`.
- ragged ``allgather`` pads every rank's rows to the largest count,
  gathers and slices; ``alltoall`` with ``splits`` exchanges the splits
  first, then moves exactly the rows each rank asked for.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

import torch


class ReduceOp(enum.Enum):
    """† ``horovod/common/common.h`` ReduceOp enum."""
    AVERAGE = "average"
    SUM = "sum"
    ADASUM = "adasum"
    MIN = "min"
    MAX = "max"
    PRODUCT = "product"


# Module-level aliases matching ``hvd.Average`` etc.
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


def _dist_op(op: ReduceOp):
    import torch.distributed as dist
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVERAGE:
            dist.ReduceOp.SUM, ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX}[op]


def _scale_(buf: torch.Tensor, factor: float) -> None:
    """``buf *= factor`` in ``buf``'s dtype (the reference multiplies by
    ``jnp.asarray(factor, dtype)``; an integer buffer so takes the
    factor truncated)."""
    if factor != 1.0:
        buf.mul_(torch.tensor(factor).to(buf.dtype))


def average_(out: torch.Tensor, src: torch.Tensor, n: int) -> None:
    """``out = src / n`` with the reference's rounding; ``out`` may be
    ``src``.  XLA compiles the reference's ``out / n``
    (collectives.py:258-263) into a product by the reciprocal rounded to
    the payload's dtype for float64, float32 and float16, and keeps a
    true division for bfloat16 (seen on XLA's CPU backend: at n=3 a
    division differs from the compiled float32 average in a third of the
    values, the product in none).  Integers floor-divide.  At a power of
    two the reciprocal is exact, so the product is the division."""
    if src.dtype == torch.bfloat16 or src.is_complex():
        torch.div(src, n, out=out)
    elif src.is_floating_point():
        # the reciprocal rounded to the dtype, as a Python float
        torch.mul(src, torch.tensor(1.0 / n, dtype=src.dtype).item(),
                  out=out)
    else:
        torch.div(src, n, rounding_mode="floor", out=out)


def average(src: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`average_` into a new tensor."""
    out = torch.empty_like(src)
    average_(out, src, n)
    return out


def allreduce_(buf: torch.Tensor, op: ReduceOp, group, n: int, *,
               prescale: float = 1.0, postscale: float = 1.0,
               divide: bool = True) -> None:
    """Reduce the contiguous ``buf`` in place across the group.
    ``divide=False`` leaves an ``AVERAGE``'s division (and the postscale)
    to the caller, who folds it into the copy out of a fusion buffer."""
    import torch.distributed as dist
    if op is ReduceOp.ADASUM:
        # The reference's Adasum path takes no pre- or postscale.
        from .adasum import adasum_allreduce
        buf.copy_(adasum_allreduce(buf, group, n))
        return
    _scale_(buf, prescale)
    if op is ReduceOp.PRODUCT:
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=group)
        buf.copy_(torch.prod(torch.stack(parts), dim=0, dtype=buf.dtype))
    else:
        dist.all_reduce(buf, op=_dist_op(op), group=group)
    if not divide:
        return
    if op is ReduceOp.AVERAGE:
        average_(buf, buf, n)
    _scale_(buf, postscale)


def _gather_rows(t: torch.Tensor, group, n: int) -> list[int]:
    """Every rank's dim-0 length, in rank order."""
    import torch.distributed as dist
    mine = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(counts, mine, group=group)
    return [int(c) for c in torch.cat(counts).tolist()]


def allgather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 († ``MPI_Allgatherv``:
    dim-0 lengths may differ between ranks; trailing dims and dtype may
    not).  A 0-d tensor gathers as one row."""
    import torch.distributed as dist
    if t.dim() == 0:
        t = t.reshape(1)
    t = t.contiguous()
    rows = _gather_rows(t, group, n)
    maxr = max(rows)
    if maxr != t.shape[0]:
        pad = t.new_zeros((maxr - t.shape[0],) + tuple(t.shape[1:]))
        t = torch.cat([t, pad])
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat([p[:r] for p, r in zip(parts, rows)])


def broadcast_(buf: torch.Tensor, root_global: int, group) -> None:
    """Every rank's contiguous ``buf`` becomes the root's."""
    import torch.distributed as dist
    dist.broadcast(buf, src=root_global, group=group)


def alltoall(t: torch.Tensor, splits: Optional[Sequence[int]], group,
             n: int, me: int) -> torch.Tensor:
    """Rank ``me`` sends ``splits[j]`` rows of ``t`` to rank ``j`` and
    returns the rows every rank sent it, in rank order († ``MPI_Alltoallv``).
    Without ``splits`` the rows divide evenly among the ranks."""
    import torch.distributed as dist
    t = t.contiguous()
    rows = t.shape[0] if t.dim() else 0
    if splits is None:
        if t.dim() == 0 or rows % n:
            raise ValueError(
                f"alltoall rows ({rows}) not divisible by ranks ({n}); "
                "pass explicit splits")
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out
    splits = [int(s) for s in splits]
    if len(splits) != n or min(splits) < 0 or sum(splits) != rows:
        raise ValueError(f"splits {splits} must be {n} non-negative row "
                         f"counts summing to rows ({rows})")
    # Every rank learns the full [n, n] send matrix, then receives column
    # ``me`` of it.
    mine = torch.tensor(splits, dtype=torch.int64, device=t.device)
    mats = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(mats, mine, group=group)
    recv = [int(m[me]) for m in mats]
    out = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
    dist.all_to_all_single(out, t, output_split_sizes=recv,
                           input_split_sizes=splits, group=group)
    return out


def reducescatter(t: torch.Tensor, op: ReduceOp, group,
                  n: int) -> torch.Tensor:
    """Reduce across ranks, then rank *i* keeps the *i*-th of ``n`` equal
    dim-0 slices.  ``SUM`` and ``AVERAGE`` only, as in the reference."""
    import torch.distributed as dist
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise NotImplementedError(
            f"reducescatter supports SUM/AVERAGE, got {op}")
    if t.dim() < 1 or t.shape[0] % n:
        raise ValueError(
            f"reducescatter dim 0 ({tuple(t.shape)}) must exist and "
            f"divide {n}")
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    dist.reduce_scatter(out, list(t.chunk(n)), op=dist.ReduceOp.SUM,
                        group=group)
    if op is ReduceOp.AVERAGE:
        average_(out, out, n)
    return out
