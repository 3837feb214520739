"""Collectives over mesh axes, with the gradients the model needs.

The port's counterpart of what GSPMD inserts in the reference's sharded
model: each op is an ``autograd.Function`` with an explicit forward and
backward, Megatron style:

- :func:`copy_to` — identity forward, all-reduce backward (the input of a
  column-parallel product: the ranks' partial input gradients sum);
- :func:`reduce_from` — all-reduce forward, identity backward (the output
  of a row-parallel product; each rank's copy of the sum takes the whole
  gradient);
- :func:`all_gather` — all-gather forward, reduce-scatter backward (a
  ZeRO-3 weight gathered for ranks that hold different data);
- :func:`scatter` — this rank's slice forward, all-gather backward (a
  replicated tensor split over the ranks);
- :func:`all_to_all` — block ``i`` of dim 0 to rank ``i`` forward, the
  inverse exchange backward (:func:`all_to_all_group` over a process
  group, DLRM's embedding exchange);
- :func:`mean_across_group` — the mean over a process group both ways
  (the ResNet's synchronized batch statistics);
- :func:`pipeline_handoff` — a GPipe tick's activation to the next
  pipeline stage forward, its cotangent to the previous stage backward
  (:class:`PipelineHandoff`); :func:`from_last_stage` — the last stage's
  outputs on every stage forward, only the last stage's cotangent kept
  backward.

Each takes the mesh and a tuple of axes; the group is that of this rank
over those axes, ranks in row-major order.  On a group of one rank each
returns its input as it is, with no autograd node and no collective.
A group over several axes comes from those :func:`~.mesh.build_mesh`
made (creating a process group is collective, so it is never done in a
step); a group over one axis is the mesh's own.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import AXES
from .sharding import axis_sizes


def group_of(mesh, axes: Sequence[str]):
    """(process group, size) of this rank over ``axes`` of ``mesh``, the
    axes of size 1 dropped; ``(None, 1)`` when none is left."""
    if mesh is None:
        return None, 1
    sizes = axis_sizes(mesh)
    live = tuple(a for a in AXES if a in axes and sizes.get(a, 1) > 1)
    if not live:
        return None, 1
    n = 1
    for a in live:
        n *= sizes[a]
    if len(live) == 1:
        return mesh.get_group(live[0]), n
    groups = getattr(mesh, "hvd_axis_groups", {})
    if live not in groups:
        raise RuntimeError(f"no process group over axes {live}: build the "
                           f"mesh with parallel.build_mesh")
    return groups[live], n


def _all_gather_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    inp = x.movedim(dim, 0).contiguous()
    out = inp.new_empty((n * inp.shape[0],) + tuple(inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, group, n: int,
                        dim: int) -> torch.Tensor:
    inp = x.movedim(dim, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // n,) + tuple(inp.shape[1:]))
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out.movedim(0, dim)


def _slice_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    step = x.shape[dim] // n
    me = dist.get_rank(group)
    return x.narrow(dim, me * step, step).contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    inp = x.contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _all_gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.group, ctx.n, ctx.dim), None, \
            None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _slice_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, ctx.group, ctx.n, ctx.dim), None, None, \
            None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def copy_to(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``axes``."""
    group, n = group_of(mesh, axes)
    return x if n == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum over ``axes`` forward; the gradient passed as it is."""
    group, n = group_of(mesh, axes)
    return x if n == 1 else _ReduceFrom.apply(x, group)


def all_gather(x: torch.Tensor, mesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    gradient reduce-scattered back to this rank's slice."""
    group, n = group_of(mesh, axes)
    return x if n == 1 else _AllGather.apply(x, group, n, dim)


def scatter(x: torch.Tensor, mesh, axes: Sequence[str],
            dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``; the gradient all-gathered
    back to ``x``'s shape."""
    group, n = group_of(mesh, axes)
    return x if n == 1 else _Scatter.apply(x, group, n, dim)


def all_to_all(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Block ``i`` of dim 0 to rank ``i``; block ``i`` of the result came
    from rank ``i``.  The gradient takes the inverse exchange (the same
    one, the blocks being equal)."""
    group, n = group_of(mesh, axes)
    return x if n == 1 else _AllToAll.apply(x, group)


def all_reduce_max(x: torch.Tensor, mesh, axes: Sequence[str]
                   ) -> torch.Tensor:
    """The elementwise maximum over ``axes`` (no gradient)."""
    group, n = group_of(mesh, axes)
    if n == 1:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_reduce_sum_(x: torch.Tensor, mesh, axes: Sequence[str]
                    ) -> torch.Tensor:
    """Sum ``x`` over ``axes`` in place (no gradient)."""
    group, n = group_of(mesh, axes)
    if n > 1:
        dist.all_reduce(x, group=group)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
    """The sum over ``axes``, this rank's slice of it along ``dim`` (no
    gradient)."""
    group, n = group_of(mesh, axes)
    return x if n == 1 else _reduce_scatter_dim(x.detach(), group, n, dim)


def gather_tensor(x: torch.Tensor, mesh, axes: Sequence[str],
                  dim: int) -> torch.Tensor:
    """:func:`all_gather` with no gradient."""
    group, n = group_of(mesh, axes)
    return x if n == 1 else _all_gather_dim(x.detach(), group, n, dim)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`reduce_from` over a process group (the pipeline's)."""
    return _ReduceFrom.apply(x, group)


class _MeanAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_reduce(x, group) / n

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group) / ctx.n, None, None


def mean_across_group(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over a process group (flax's ``pmean``), its
    gradient the mean of the ranks' cotangents: each rank's share of
    every rank's loss through the shared value."""
    n = dist.get_world_size(group)
    return x if n == 1 else _MeanAcross.apply(x, group, n)


def all_to_all_group(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all` over a process group (``None``: the world),
    issued even on a group of one rank."""
    return _AllToAll.apply(x, group)


class PipelineHandoff(torch.autograd.Function):
    """One GPipe tick's handoffs on a stage of a
    :class:`~.pipeline.GroupTransport`: forward, this tick's activation
    ``y`` to stage ``s + 1`` (when ``y`` is given) and the activation of
    stage ``s - 1`` received (when ``like``, a tensor of its shape, is
    given); backward, the received activation's cotangent to ``s - 1``
    and ``y``'s received from ``s + 1``.  A token ``tok`` goes in and a
    new one comes out: each tick's handoff takes the previous tick's, so
    a stage's backward runs every handoff's backward, last tick first,
    whether or not the activation it received is used (stage 0 receives
    none)."""

    @staticmethod
    def forward(ctx, tok, y, transport, like):
        s = transport.stage
        ctx.transport = transport
        ctx.y_like = None if y is None else torch.empty_like(y)
        ctx.received = like is not None
        got = transport.exchange(
            [(s + 1, y)] if y is not None else [],
            [(s - 1, like)] if like is not None else [])
        x = got[0] if got else tok.new_zeros(0)
        return x, tok.clone()

    @staticmethod
    def backward(ctx, gx, gtok):
        s = ctx.transport.stage
        got = ctx.transport.exchange(
            [(s - 1, gx)] if ctx.received else [],
            [(s + 1, ctx.y_like)] if ctx.y_like is not None else [])
        return gtok, (got[0] if got else None), None, None


def pipeline_handoff(y: Optional[torch.Tensor], tok: torch.Tensor,
                     transport, like: Optional[torch.Tensor]) -> tuple:
    """(received activation or an empty tensor, new token): see
    :class:`PipelineHandoff`."""
    return PipelineHandoff.apply(tok, y, transport, like)


class _FromLastStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, outs, tok, transport, shape, dtype):
        last = transport.n - 1
        ctx.last = transport.stage == last
        buf = outs if ctx.last else torch.empty(shape, dtype=dtype,
                                                device=tok.device)
        return transport.from_stage(buf, last)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None), torch.zeros((), dtype=torch.float32,
                                                      device=g.device), \
            None, None, None


def from_last_stage(outs: Optional[torch.Tensor], tok: torch.Tensor,
                    transport, shape, dtype) -> torch.Tensor:
    """The last stage's ``outs`` on every stage of ``transport`` (the
    reference's masked ``psum`` over pp, as a broadcast: the same bits).
    Backward: the last stage's cotangent goes to its ``outs``, the other
    stages' cotangents are dropped, so each stage's copy of a loss
    computed from the result seeds one loss, not ``n``; ``tok`` (the
    handoffs' token) gets a zero cotangent on every stage, which starts
    the backward of its handoffs."""
    return _FromLastStage.apply(outs, tok, transport, shape, dtype)
