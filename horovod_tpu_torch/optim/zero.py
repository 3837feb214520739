"""ZeRO-1 sharded optimizer on the reduce-scatter/allgather decomposition.

The port of ``horovod_tpu/optim/zero.py``.  The dense
:func:`~.distributed.DistributedOptimizer` allreduces every gradient and
keeps the whole optimizer state on every rank.
:class:`ZeroDistributedOptimizer` keeps the 1/n shard instead:

1. gradients go down the reduce-scatter chain and stop at the shard
   (:func:`~..ops.sched.in_context.overlap_reducescatter`; with
   ``sched_mode="monolithic"`` each gradient is allreduced whole, as the
   dense optimizer does, and the shard sliced out);
2. the inner optimizer steps the 1/n parameter shard, so its state
   (Adam's moments) is sharded n ways;
3. one parameter allgather a bucket closes the step.

The wire bytes are the dense path's (reduce-scatter + parameter
allgather = reduce-scatter + gradient allgather), and the state is 1/n of
the dense state plus the padding of :mod:`.partition`
(``hvd_zero_state_bytes``).

Memory.  The reference flattens the buckets inside jit, where XLA frees
the copies; eager, a flat gradient bucket and a flat parameter shard
beside the model's own tensors would add two copies of the model (about
2 x 13.5 GB for Llama-2-7B in bf16 at one rank).  So here:

- every gradient is a view into its bucket's flat gradient buffer: the
  wrapper sets ``p.grad`` to the view and keeps it, ``zero_grad`` zeroes
  the buffers, and backward accumulates into them in place;
- the inner optimizer's parameters are *pieces*: views of the model's own
  parameters over this rank's slices of each bucket (plus small zero
  tensors where a slice covers padding), and their gradients are views of
  the reduced shard.  The inner optimizer updates the model's parameters
  in place, so the shard needs no copy of its own;
- the parameter allgather packs this rank's pieces (1/n of a bucket),
  gathers a bucket and copies it into the parameters.

At one rank the shard is the whole bucket and its pieces are the
parameters themselves: the gradients are already the sum and the average
of one rank, and the allgather is the identity, so neither collective is
issued, and the extra memory is the padding alone.

Parity (the reference's contract): parameters are bit-identical to the
dense ``DistributedOptimizer``'s at np=2 for the fp32 and int8 wires, and
within 2 ulp at np=4 — the dense optimizer reducing each gradient as its
own group, whose quant blocks start at the tensor as these do.

Restrictions: elementwise inner optimizers (Adam, SGD, AdamW: an
element's update depends only on its gradient, parameter and state);
``op`` AVERAGE or SUM (Adasum's projection needs the whole gradient);
stage ``partition=1``; the wrapped optimizer must not have stepped yet,
since its state is rebuilt over the shard.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import context
from ..obs import REGISTRY as _obs
from ..ops import collectives as C
from ..ops import reduction as R
from ..ops.compression import Compression, routes_engine_side
from . import partition as P

_g_state_bytes = _obs.gauge(
    "hvd_zero_state_bytes",
    "per-rank optimizer-state bytes under the ZeRO-1 sharded optimizer "
    "(sharded inner state; ~1/n of the dense footprint plus padding)")


def _leaf_modes(leaves, compression, cfg) -> list:
    """Each tensor's wire mode: the quantized mode for a quantized
    compressor, a float tensor and at least ``quant_min_bytes``; else
    fp32 (the dense path's rule)."""
    quant = routes_engine_side(compression)
    return [compression.wire_mode if (
        quant and t.is_floating_point()
        and t.numel() * t.element_size() >= cfg.quant_min_bytes) else "fp32"
        for t in leaves]


class ZeroDistributedOptimizer(torch.optim.Optimizer):
    """Wrap ``optimizer`` (a fresh ``torch.optim`` optimizer over the
    model's parameters) as a ZeRO-1 sharded optimizer (module docs).
    ``bucket_bytes`` overrides ``HVDTPU_BUCKET_BYTES`` (<= 0: one bucket
    per dtype and wire mode)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 partition: int = 1, *, op: C.ReduceOp = C.ReduceOp.AVERAGE,
                 compression=Compression.none,
                 bucket_bytes: Optional[int] = None) -> None:
        if partition != 1:
            raise NotImplementedError(
                f"ZeRO stage {partition} is not supported; only stage 1 "
                "(optimizer-state sharding) is implemented")
        if op not in (C.ReduceOp.AVERAGE, C.ReduceOp.SUM):
            raise ValueError(
                f"ZeroDistributedOptimizer supports AVERAGE/SUM, got {op}")
        if optimizer.state:
            raise ValueError(
                "wrap an optimizer that has not stepped yet: its state is "
                "rebuilt over this rank's shard")
        state = context.global_state()
        if not state.initialized:
            raise context.NotInitializedError()
        cfg = state.config
        self._n, self._me = state.size, state.rank
        self.op, self._compression = op, compression
        self._outer = optimizer
        params, group_of = [], []
        for gi, group in enumerate(optimizer.param_groups):
            for p in group["params"]:
                if p.requires_grad:
                    if not p.is_contiguous():
                        raise ValueError("ZeRO-1 needs contiguous parameters")
                    params.append(p)
                    group_of.append(gi)
        self._params, self._group_of = params, group_of
        bb = cfg.bucket_bytes if bucket_bytes is None else bucket_bytes
        self._plan = P.build_plan(
            params, self._n, modes=_leaf_modes(params, compression, cfg),
            block=cfg.quant_block_size, chunks=max(1, cfg.sched_chunks),
            bucket_bytes=int(bb or 0))
        self._layouts = [P.bucket_layout(self._plan, b)
                         for b in self._plan.buckets]
        # The flat gradient buffers; every p.grad is a view into one.
        self._flat_g = []
        for b in self._plan.buckets:
            flat = torch.zeros(b.numel, dtype=b.dtype,
                               device=params[b.leaves[0].index].device)
            for idx, view in P.unflatten_bucket(b, flat):
                params[idx].grad = view
            self._flat_g.append(flat)
        # The inner optimizer over this rank's pieces of the parameters.
        self._pieces = [self._bucket_pieces(b, layout)
                        for b, layout in zip(self._plan.buckets,
                                             self._layouts)]
        groups = []
        for gi, group in enumerate(optimizer.param_groups):
            mine = [t for pieces in self._pieces for t, _, g in pieces
                    if g == gi]
            if mine:
                groups.append({**{k: v for k, v in group.items()
                                  if k != "params"}, "params": mine})
        self._inner = type(optimizer)(groups, **optimizer.defaults)

    def _bucket_pieces(self, bucket: P.BucketSpec, layout) -> list:
        """``[(tensor, shard offset, param group), ...]``: views of the
        parameters over this rank's slices of ``bucket``, zero tensors
        over padding, in shard order."""
        ranges: list = []
        for a, b in P.shard_ranges(layout, self._me, self._n):
            if ranges and ranges[-1][1] == a:     # adjacent (one rank)
                ranges[-1] = (ranges[-1][0], b)
            else:
                ranges.append((a, b))
        pieces, soff = [], 0
        for a, b in ranges:
            for spec in bucket.leaves:
                lo = max(a, spec.offset)
                hi = min(b, spec.offset + spec.padded)
                if lo >= hi:
                    continue
                p = self._params[spec.index]
                gi = self._group_of[spec.index]
                end = min(hi, spec.offset + spec.numel)
                if lo < end:
                    pieces.append((p.detach().view(-1)[lo - spec.offset:
                                                       end - spec.offset],
                                   soff + lo - a, gi))
                if max(lo, end) < hi:
                    start = max(lo, end)
                    pieces.append((p.new_zeros(hi - start),
                                   soff + start - a, gi))
            soff += b - a
        return pieces

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

    @property
    def plan(self) -> P.Plan:
        return self._plan

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Zero the flat gradient buffers (the gradients stay views into
        them whatever ``set_to_none`` says)."""
        for flat in self._flat_g:
            flat.zero_()
        self._rebind_grads()

    def _rebind_grads(self) -> None:
        """Point every ``p.grad`` back at its view (a caller may have
        replaced or dropped it), keeping what it held."""
        for b, flat in zip(self._plan.buckets, self._flat_g):
            for idx, view in P.unflatten_bucket(b, flat):
                p = self._params[idx]
                g = p.grad
                if g is None or g.data_ptr() != view.data_ptr():
                    if g is not None:
                        view.copy_(g)
                    else:
                        view.zero_()
                    p.grad = view

    def _reduce_shard(self, k: int) -> torch.Tensor:
        """Bucket ``k``'s reduced gradient shard."""
        from ..ops.sched import overlap_reducescatter
        b, layout, flat = self._plan.buckets[k], self._layouts[k], \
            self._flat_g[k]
        n, average = self._n, self.op is C.ReduceOp.AVERAGE
        cfg = context.global_state().config
        if n == 1:
            return flat             # the sum and the average of one rank
        comp = self._compression
        quant = b.mode in R.QUANT_MODES
        if cfg.sched_mode == "decomposed" and flat.is_floating_point() and \
                (routes_engine_side(comp) or not comp.wire_mode):
            src = flat.float() if quant else flat
            return overlap_reducescatter(
                src, None, layout=layout, average=average, mode=b.mode,
                block=self._plan.block).to(flat.dtype)
        # Monolithic: each gradient reduced whole, as the dense optimizer
        # reduces it, then this rank's shard sliced out.
        for _, g in P.unflatten_bucket(b, flat):
            if quant:
                g.copy_(R.quant_allreduce(g, self.op, b.mode, None, n,
                                          self._plan.block))
            elif comp.wire_mode and not routes_engine_side(comp):
                wire, ctx = comp.compress(g)
                wire = wire.contiguous()
                C.allreduce_(wire, self.op, None, n)
                g.copy_(comp.decompress(wire, ctx))
            else:
                C.allreduce_(g, self.op, None, n)
        return P.extract_shard(flat, self._me, layout, n)

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._rebind_grads()
        for k, pieces in enumerate(self._pieces):
            shard = self._reduce_shard(k)
            for t, soff, _ in pieces:
                t.grad = shard[soff:soff + t.numel()]
        self._inner.step()
        for t, _, _ in (t for pieces in self._pieces for t in pieces):
            t.grad = None
        if self._n > 1:
            for k in range(len(self._pieces)):
                self._allgather_params(k)
        _g_state_bytes.set(float(self.state_bytes()))
        return loss

    def _allgather_params(self, k: int) -> None:
        """The one parameter allgather of bucket ``k``."""
        b, layout, n = self._plan.buckets[k], self._layouts[k], self._n
        mine = torch.cat([t.reshape(-1) for t, _, _ in self._pieces[k]])
        gathered = mine.new_empty(mine.numel() * n)
        R.all_gather_flat(gathered, mine)
        full = P.assemble_from_shards(gathered, layout, n)
        with torch.no_grad():
            for idx, view in P.unflatten_bucket(b, full):
                self._params[idx].copy_(view)

    def state_bytes(self) -> int:
        """This rank's optimizer-state bytes (``hvd_zero_state_bytes``)."""
        return P.shard_bytes(v for st in self._inner.state.values()
                             for v in st.values()
                             if isinstance(v, torch.Tensor))

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, sd):
        return self._inner.load_state_dict(sd)


def from_config(optimizer: torch.optim.Optimizer, **kwargs):
    """``HVDTPU_ZERO`` dispatcher: :class:`ZeroDistributedOptimizer` when
    ``cfg.zero`` is set, the dense :func:`DistributedOptimizer`
    otherwise."""
    from .distributed import DistributedOptimizer
    if context.global_state().config.zero:
        kwargs.pop("named_parameters", None)
        kwargs.pop("backward_passes_per_step", None)
        return ZeroDistributedOptimizer(optimizer, **kwargs)
    kwargs.pop("bucket_bytes", None)
    kwargs.pop("partition", None)
    return DistributedOptimizer(optimizer, **kwargs)
