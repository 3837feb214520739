"""The chunked schedule as eager functions over a process group.

The port of ``horovod_tpu/ops/sched/in_context.py``:
``overlap_allreduce``, ``overlap_reducescatter`` and
``matmul_reducescatter``.  The reference writes them inside a mapped
region and leaves the overlap to XLA's scheduler; here they run eagerly,
one ``torch.distributed`` call per step, on the current stream.  The
units are the executor's, so a chunk reduces to the same bits on both
paths.  :func:`run_in_context` interprets a whole-buffer schedule (the
two-tier family) over a group an axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import collectives as C
from .. import reduction as R
from .executor import ag_fp32, rs_fp32
from .ir import Schedule
from .lower import chunk_layout


def overlap_allreduce(x: torch.Tensor, group=None, *, average: bool = True,
                      mode: str = "fp32", chunks: int = 2,
                      block: int = 512) -> torch.Tensor:
    """Chunked reduce-scatter/allgather allreduce of one tensor over
    ``group``, each chunk an ``[encode] -> reduce_scatter -> combine ->
    all_gather [-> decode]`` chain.  ``x`` itself at one rank; a new
    tensor of ``x``'s shape and dtype otherwise."""
    n = dist.get_world_size(group)
    if n <= 1:
        return x
    quant = mode in R.QUANT_MODES
    cast = mode in R.CAST_MODES
    flat = (x.float() if quant else x).reshape(-1)
    numel = flat.numel()
    layout = chunk_layout(numel, n, max(1, chunks), mode, block)
    outs = []
    for ch in R._pad(flat, sum(layout)).split(layout):
        if quant:
            acc, scale, _ = R.quant_reduce_scatter(ch, mode, group, n,
                                                   block)
            w2, s2 = R.quant_combine(acc, scale, mode, block, n, average)
            outs.append(R.quant_all_gather(w2, s2, mode, group, n, block))
        elif cast:
            alg = R.algebra_for(mode)
            sh, _ = rs_fp32(alg.wire_encode(ch)[0], group, n)
            g = alg.wire_decode(ag_fp32(sh, group, n), None)
            outs.append(g * R.f32_recip(n) if average else g)
        else:
            sh, _ = rs_fp32(ch, group, n)
            outs.append(ag_fp32(C.average(sh, n) if average else sh, group,
                                n))
    out = (outs[0] if len(outs) == 1 else torch.cat(outs))[:numel]
    return out.view(x.shape).to(x.dtype)


def overlap_reducescatter(flat: torch.Tensor, group=None, *, layout,
                          average: bool = True, mode: str = "fp32",
                          block: int = 512) -> torch.Tensor:
    """The :func:`overlap_allreduce` chain stopped at the shard, the
    ZeRO-1 half: per chunk ``[encode] -> reduce_scatter -> combine`` and
    no allgather.  ``flat`` is already padded to ``sum(layout)``;
    :func:`~.lower.chunk_layout` makes every entry divide by ``n`` (by
    ``n * block`` for the quantized modes).  Returns this rank's
    ``sum(layout) / n`` shard in chunk-major order (``flat`` itself at
    one rank), fp32 for a quantized mode.

    The quantized shard replays the requantization round trip the dense
    chain puts on the wire for its allgather, so every element is
    bit-identical to :func:`overlap_allreduce`'s."""
    n = dist.get_world_size(group)
    if n <= 1:
        return flat
    quant = mode in R.QUANT_MODES
    outs = []
    for ch in flat.split(list(layout)):
        if quant:
            acc, scale, _ = R.quant_reduce_scatter(ch, mode, group, n,
                                                   block)
            w2, s2 = R.quant_combine(acc, scale, mode, block, n, average)
            outs.append(R.algebra_for(mode).wire_decode(
                w2.view(-1, block), s2).view(-1))
        else:
            sh, _ = rs_fp32(ch, group, n)
            outs.append(C.average(sh, n) if average else sh)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, group=None, *,
                         chunks: int = 2) -> torch.Tensor:
    """The row-parallel projection ``all_reduce(x @ w)`` over ``group``
    (the tp group) as chunked partial products, each reduce-scattered
    over its columns and all-gathered back, so a chunk's reduce-scatter
    can run under the next chunk's product.

    ``x`` ``[..., K_local]`` (the contraction dim sharded over the
    group), ``w`` ``[K_local, D]``.  The output's D columns split into
    ``chunks`` slices; the sums are the all-reduce's, elementwise.  When
    D does not split into ``n * chunks`` (or at one rank, or one chunk)
    it is the plain all-reduce.  Eager, on the current stream."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    d = w.shape[-1]
    if n <= 1 or chunks <= 1 or d % (n * chunks):
        y = torch.matmul(x, w)
        if n > 1:
            dist.all_reduce(y, group=group)
        return y
    csz = d // chunks
    outs = []
    for c in range(chunks):
        pc = torch.matmul(x, w[..., c * csz:(c + 1) * csz])  # [..., csz]
        cols = pc.movedim(-1, 0).contiguous()
        sh = cols.new_empty((csz // n,) + tuple(cols.shape[1:]))
        R.reduce_scatter_flat(sh, cols, group)
        full = torch.empty_like(cols)
        R.all_gather_flat(full, sh, group)
        outs.append(full.movedim(0, -1))
    return torch.cat(outs, dim=-1)


def run_in_context(schedule: Schedule, x: torch.Tensor, groups: dict, *,
                   average: bool = False) -> torch.Tensor:
    """Interpret a single-chunk schedule on this rank's ``x`` over
    ``groups`` (axis name -> (process group, size)), the reference's
    in-graph interpreter as eager calls: a reduce-scatter step pads the
    flat buffer to its tier's size and scatters over it, ``all_reduce``
    reduces the shard, ``combine`` divides by every tier reduced so far
    for an AVERAGE, ``all_gather`` gathers over its tier.  The two-tier
    allreduce (``ops/hierarchical.py``) rides it.  A new tensor of
    ``x``'s shape and dtype."""
    flat = x.reshape(-1)
    numel = flat.numel()
    denom = 1
    for s in schedule.interleaved_order():
        if s.kind == "reduce_scatter":
            group, n = groups[s.axis]
            denom *= n
            flat, _ = rs_fp32(R._pad(flat, -(-flat.numel() // n) * n),
                              group, n)
        elif s.kind == "all_reduce":
            group, n = groups[s.axis]
            denom *= n
            flat = flat.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(flat, group=group)
        elif s.kind == "combine":
            if average and denom > 1:
                flat = C.average(flat, denom)
        elif s.kind == "all_gather":
            group, n = groups[s.axis]
            flat = ag_fp32(flat, group, n)
        # chunk/concat/barrier/encode/decode: no-ops for this family.
    return flat[:numel].view(x.shape)
