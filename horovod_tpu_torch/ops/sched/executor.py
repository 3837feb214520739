"""Engine-side schedule executor: the chunked reduce-scatter -> combine ->
allgather walk of one (possibly fused) allreduce.

The port of ``horovod_tpu/ops/sched/executor.py``: the flat ``rs_ag:<k>``
family and the chunked two-tier ``hier:<n_local>:<k>`` family
(:func:`_execute_hier_allreduce`).  Per chunk of ``rs_ag`` there are three
dispatch units: a *reduce-scatter* unit (the quantized wire's encode
folded in), a *combine* unit (the fp32
dequantize / average / requantize arithmetic; the AVERAGE's division for
an fp32 wire, none for an fp32 SUM) and an *allgather* unit (decode folded
in).  The walk follows :meth:`~.ir.Schedule.interleaved_order`: every
chunk's reduce-scatter first, then combine and allgather chunk by chunk.
Results are bit-identical to the monolithic path: an fp32 chunk does the
same per-element operations, and a quantized chunk has the same block
grid (:func:`~.lower.chunk_layout`), exact sums and per-block
requantization.

Streams.  The reduce-scatters are issued with ``async_op=True``.  On the
card ``ProcessGroupNCCL`` runs every collective on its own internal
stream, which waits for the issuing stream (the engine's) at issue; an
async collective leaves the engine's stream free until ``work.wait()``,
which makes that stream wait on the collective's completion without a
host synchronisation.  So combine(c) waits for reduce-scatter(c) only and
runs on the engine's stream while reduce-scatter(c+1..k-1) run on NCCL's:
the NCCL stream is the comm stream, the engine's stream the compute
stream, ordered by those events.  The allgathers are issued synchronously.
Over Gloo the async work runs on Gloo's thread and ``wait()`` blocks the
host.  (One card has no wire, so the overlap itself is not measured.)

Timeline.  Each unit opens a span on its own lane (``<tensor>/rs.c0``,
``/combine.c0``, ``/ag.c0``) when it is issued and closes it when its
consumer is issued: the unit's in-flight window.  Flow arrows link
RS -> COMBINE -> AG per chunk, and ``hvd_sched_overlap_fraction`` is the
share of the communication windows that compute windows overlap.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from ...obs import REGISTRY as _obs
from ...obs import perfmodel as _perf
from .. import reduction as R
from .lower import (chunk_layout, parse_compiled_descriptor,
                    parse_descriptor, parse_hier_descriptor)

_m_overlap = _obs.gauge(
    "hvd_sched_overlap_fraction",
    "fraction of communication-step in-flight time overlapped by "
    "compute-step in-flight time in the last decomposed collective "
    "(host dispatch windows; 0 = fully serialized schedule)")
_m_sched = _obs.counter(
    "hvd_sched_dispatches_total",
    "decomposed-schedule collective dispatches", ("schedule",))
_m_sched_d: dict = {}


def _m_sched_child(descriptor: str):
    child = _m_sched_d.get(descriptor)
    if child is None:
        child = _m_sched_d.setdefault(
            descriptor, _m_sched.labels(schedule=descriptor))
    return child


def _scaled(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x * factor`` in ``x``'s dtype, as ``collectives._scale_``: the
    factor rounded to that dtype, passed as a Python float (no host
    tensor enters a captured graph)."""
    if factor == 1.0:
        return x
    return x * torch.tensor(factor).to(x.dtype).item()


# ---------------------------------------------------------------------------
# fp32 units (the quantized ones are reduction.quant_*)
# ---------------------------------------------------------------------------

def rs_fp32(chunk: torch.Tensor, group, n: int, prescale: float = 1.0,
            async_op: bool = False):
    """Reduce-scatter unit of an unquantized chunk: ``(shard, work)``."""
    x = _scaled(chunk, prescale).contiguous()
    shard = x.new_empty(x.numel() // n)
    return shard, R.reduce_scatter_flat(shard, x, group, async_op=async_op)


def ag_fp32(shard: torch.Tensor, group, n: int,
            postscale: float = 1.0) -> torch.Tensor:
    """Allgather unit of an unquantized shard."""
    g = shard.new_empty(shard.numel() * n)
    R.all_gather_flat(g, shard.contiguous(), group)
    return _scaled(g, postscale)


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------

_UNIT_ACTIVITY = {"rs": "SCHED_RS", "combine": "SCHED_COMBINE",
                  "ag": "SCHED_AG", "cross": "SCHED_CROSS"}


def _overlap_fraction(comm: list, compute: list) -> float:
    """Fraction of total comm in-flight time covered by the union of
    compute in-flight windows (both lists of (t0, t1) host timestamps)."""
    total = sum(t1 - t0 for t0, t1 in comm)
    if total <= 0.0 or not compute:
        return 0.0
    merged: list = []
    for k0, k1 in sorted(compute):
        if merged and k0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], k1)
        else:
            merged.append([k0, k1])
    covered = 0.0
    for c0, c1 in comm:
        for k0, k1 in merged:
            lo, hi = max(c0, k0), min(c1, k1)
            if hi > lo:
                covered += hi - lo
    return min(1.0, covered / total)


def unit_order(k: int, has_combine: bool) -> list:
    """The dispatch order of the units, ``Schedule.interleaved_order`` for
    the rs_ag family: all reduce-scatters, then combine/allgather per
    chunk."""
    order = [(u, c) for c in range(k) for u in ("rs", "combine", "ag")
             if u != "combine" or has_combine]
    order.sort(key=lambda uc: (0 if uc[0] == "rs" else 1, uc[1],
                               0 if uc[0] == "combine" else 1))
    return order


def walk(chunk_bufs: Sequence[torch.Tensor], *, mode: str, group, n: int,
         block: int, average: bool, prescale: float = 1.0,
         postscale: float = 1.0, on_open=None, on_close=None) -> list:
    """The ``rs_ag`` walk over the padded chunks ``chunk_bufs`` (each a
    :func:`~.lower.chunk_layout` unit): per chunk reduce-scatter (issued
    async), combine, allgather, in :func:`unit_order`.  Returns each
    chunk's gathered result.  ``on_open(unit, c)`` and ``on_close(unit,
    c)`` see each unit issued and its consumer issued (the executor's
    spans); the compiled backend walks the same units with neither."""
    from ..collectives import average as _average
    quant = mode in R.QUANT_MODES
    k = len(chunk_bufs)
    vals: list = [None] * k           # per-chunk in-flight value(s)
    outs: list = [None] * k           # per-chunk gathered result
    opened = on_open or (lambda unit, c: None)
    closed = on_close or (lambda unit, c: None)
    has_combine = quant or average
    for unit, c in unit_order(k, has_combine):
        if unit == "rs":
            opened("rs", c)
            if quant:
                vals[c] = R.quant_reduce_scatter(
                    chunk_bufs[c], mode, group, n, block, prescale,
                    async_op=True)
            else:
                vals[c] = rs_fp32(chunk_bufs[c], group, n, prescale,
                                  async_op=True)
        elif unit == "combine":
            closed("rs", c)          # its consumer is now issued
            opened("combine", c)
            *v, work = vals[c]
            work.wait()
            vals[c] = (R.quant_combine(*v, mode, block, n, average)
                       if quant else (_average(v[0], n),))
        else:  # ag
            closed("combine" if has_combine else "rs", c)
            opened("ag", c)
            v = vals[c]
            if not has_combine:
                v[1].wait()
            outs[c] = (R.quant_all_gather(*v, mode, group, n, block,
                                          postscale)
                       if quant else ag_fp32(v[0], group, n, postscale))
    return outs


def check_wire(precision: str, what: str) -> str:
    """The walk's wire mode; a cast wire raises (resolve_schedule never
    admits one: running it would execute fp32 units while accounting
    cast savings)."""
    if precision in R.CAST_MODES:
        raise ValueError(
            f"{what} schedule does not support cast wire mode "
            f"{precision!r}; resolve_schedule should have fallen back")
    return precision or "fp32"


def execute_allreduce(xs: Sequence[torch.Tensor], op, *, descriptor: str,
                      group, n: int, precision: str = "fp32",
                      prescale: float = 1.0, postscale: float = 1.0,
                      block: int = 512, name: str = "allreduce",
                      timeline=None) -> list:
    """Run a fused allreduce group (this rank's tensors ``xs``, one dtype)
    through the ``rs_ag:<k>`` schedule over ``group`` of ``n`` ranks (a
    ``compiled:rs_ag:<k>`` descriptor goes to :mod:`.compiled`); one new
    result per input, in input order."""
    from ..collectives import ReduceOp
    if parse_compiled_descriptor(descriptor) is not None:
        from . import compiled
        return compiled.execute_allreduce(
            xs, op, descriptor=descriptor, group=group, n=n,
            precision=precision, prescale=prescale, postscale=postscale,
            block=block, name=name, timeline=timeline)
    chunks = parse_descriptor(descriptor)
    if chunks is None:
        if parse_hier_descriptor(descriptor) is not None:
            return _execute_hier_allreduce(
                xs, op, descriptor=descriptor, group=group, n=n,
                precision=precision, prescale=prescale,
                postscale=postscale, block=block, name=name,
                timeline=timeline)
        raise ValueError(f"unknown schedule descriptor {descriptor!r}")
    mode = check_wire(precision, "decomposed")
    average = op is ReduceOp.AVERAGE
    dtype = xs[0].dtype
    numels = [x.numel() for x in xs]
    total = sum(numels)
    layout = chunk_layout(total, n, chunks, mode, block)
    k = len(layout)
    if mode != "fp32":
        R.account_wire(mode, total * xs[0].element_size(), n, block,
                       itemsize=xs[0].element_size())
    _m_sched_child(descriptor).inc()

    tl_on = timeline is not None and timeline.enabled
    flat = (xs[0].reshape(-1) if len(xs) == 1
            else torch.cat([x.reshape(-1) for x in xs]))
    chunk_bufs = R._pad(flat, sum(layout)).split(layout)
    opened: dict = {}                 # (unit, c) -> (lane, t_open)
    windows: dict = {"comm": [], "compute": []}
    flows: dict = {}

    def _open(unit: str, c: int) -> None:
        lane = f"{name}/{unit}.c{c}"
        opened[(unit, c)] = (lane, time.monotonic())
        if tl_on:
            timeline.start_activity(lane, _UNIT_ACTIVITY[unit])
            if unit == "rs":
                flows[c] = timeline.new_flow()
                timeline.flow_start(lane, flows[c])
            elif c in flows:
                # Land the chunk's arrow here, then start the next one so
                # RS -> COMBINE -> AG stays connected.
                timeline.flow_end(lane, flows[c])
                if unit != "ag":
                    flows[c] = timeline.new_flow()
                    timeline.flow_start(lane, flows[c])

    def _close(unit: str, c: int) -> None:
        ent = opened.pop((unit, c), None)
        if ent is None:
            return
        lane, t0 = ent
        windows["comm" if unit in ("rs", "ag") else "compute"].append(
            (t0, time.monotonic()))
        if tl_on:
            timeline.end_activity(lane)

    outs = walk(chunk_bufs, mode=mode, group=group, n=n, block=block,
                average=average, prescale=prescale, postscale=postscale,
                on_open=_open, on_close=_close)
    out = (outs[0] if k == 1 else torch.cat(outs))[:total]
    results = [piece.view(x.shape).to(dtype)
               for piece, x in zip(out.split(numels), xs)]
    for c in range(k):
        _close("ag", c)
    _m_overlap.set(_overlap_fraction(windows["comm"], windows["compute"]))
    _perf.MODEL.observe_schedule(
        descriptor=descriptor, mode=mode,
        payload_bytes=total * xs[0].element_size(), n=n, chunks=k,
        comm_windows=windows["comm"], compute_windows=windows["compute"],
        block=block, itemsize=xs[0].element_size())
    return results



# ---------------------------------------------------------------------------
# Tiered units (hier:<n_local>:<k> — chunked and two-tier).  Three units a
# chunk over the (cross, local) tier groups of ops/hierarchical.py:
#
#   rs     — reduce-scatter of the chunk over the local tier (n_local);
#   cross  — allreduce of the 1/n_local shard over the cross tier
#            (n_cross), at its own wire mode, the combine (average,
#            dequantize and requantize) folded in;
#   ag     — allgather over the local tier back to the whole chunk.
#
# A quantized base mode stays bitwise equal to the flat quantized walk:
# the shared scale is a MAX over every rank (the flat MAX, max being
# associative), the codes sum exactly in the container under either
# grouping, and the per-block requantization sees the same blocks.  fp32
# changes the n-way sum's association (local, then cross): the reference's
# 2-ulp contract, as flat rs_ag at np >= 4.
# ---------------------------------------------------------------------------

def hier_rs_quant(chunk: torch.Tensor, mode: str, local, n_local: int,
                  block: int, prescale: float, async_op: bool = False):
    """Quantized base mode, the local half: the shared scale from the
    world's MAX of the raw absmax, the codes against it, a reduce-scatter
    of the container over the local tier.  ``(acc, my_scale, work)``."""
    import torch.distributed as dist
    alg = R.algebra_for(mode)
    x = chunk.float()
    if prescale != 1.0:
        x = x * prescale
    blocks = x.view(-1, block)
    amax = alg.block_absmax(blocks)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)          # both tiers
    shared = alg.scale_from_absmax(amax)
    q, _ = alg.wire_encode(blocks, shared_scale=shared)
    cont = q.view(-1).to(R.container_dtype(mode, dist.get_world_size()))
    acc = cont.new_empty(cont.numel() // n_local)
    work = R.reduce_scatter_flat(acc, cont, local, async_op=async_op)
    sbl = blocks.shape[0] // n_local
    me = dist.get_rank(local)
    return acc, shared[me * sbl:(me + 1) * sbl], work


def hier_cross_quant_acc(acc: torch.Tensor, scale: torch.Tensor, mode: str,
                         cross, n_cross: int, block: int, average: bool,
                         n_total: int):
    """Quantized base mode, the cross hop: finish the exact sum over the
    cross tier (reduce-scatter of the container), dequantize, average and
    requantize with local per-block scales, and gather the wire and the
    scales back across the tier: ``(wire, scales)`` of the local shard."""
    import torch.distributed as dist
    alg = R.algebra_for(mode)
    sbc = scale.numel() // n_cross
    acc2 = acc.new_empty(acc.numel() // n_cross)
    R.reduce_scatter_flat(acc2, acc.contiguous(), cross)
    me = dist.get_rank(cross)
    accf = alg.wire_decode(acc2.view(-1, block),
                           scale[me * sbc:(me + 1) * sbc])
    if average:
        accf = accf * R.f32_recip(n_total)
    w2, s2 = alg.wire_encode(accf)
    gw = w2.new_empty(w2.numel() * n_cross)
    gs = s2.new_empty(s2.numel() * n_cross)
    R.all_gather_flat(gw, w2.view(-1), cross)
    R.all_gather_flat(gs, s2, cross)
    return gw, gs


def hier_cross_fp32(shard: torch.Tensor, cross, average: bool,
                    n_total: int) -> torch.Tensor:
    """fp32 cross hop: allreduce of the local shard over the cross tier,
    the AVERAGE's division by the whole world on it."""
    from ..collectives import average as _average
    import torch.distributed as dist
    shard = shard.contiguous()
    dist.all_reduce(shard, group=cross)
    return _average(shard, n_total) if average else shard


def hier_cross_quant(shard: torch.Tensor, cross_mode: str, cross,
                     n_cross: int, block: int, average: bool,
                     n_total: int) -> torch.Tensor:
    """The cross hop at a quantized wire under an fp32 local tier (the
    EQuARX placement: the starved hop is where quantization pays): shared
    scales over the cross tier, an exact container reduce-scatter, the
    combine, a requantized allgather, decoded back to fp32."""
    import torch.distributed as dist
    alg = R.algebra_for(cross_mode)
    blocks = shard.float().view(-1, block)
    amax = alg.block_absmax(blocks)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=cross)
    shared = alg.scale_from_absmax(amax)
    q, _ = alg.wire_encode(blocks, shared_scale=shared)
    cont = q.view(-1).to(R.container_dtype(cross_mode, n_cross))
    gw, gs = hier_cross_quant_acc(cont, shared, cross_mode, cross, n_cross,
                                  block, average, n_total)
    return alg.wire_decode(gw.view(-1, block), gs).view(-1)


def resolve_cross_mode(mode: str, cfg) -> str:
    """Wire mode of the cross-tier hop, from synchronized config: a
    quantized base mode keeps its algebra end to end (its exact container
    must survive both tiers); an fp32 base mode takes
    ``hierarchical_cross_precision`` on the cross hop only."""
    if mode in R.QUANT_MODES:
        return mode
    cross = getattr(cfg, "hierarchical_cross_precision", "") or ""
    if cross in R.QUANT_MODES:
        return cross
    return "fp32"


def _union_seconds(windows: list) -> float:
    """Total covered time of a set of (t0, t1) host windows (their
    union: concurrently open spans count once)."""
    merged: list = []
    for t0, t1 in sorted(windows):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return sum(t1 - t0 for t0, t1 in merged)


def hier_unit_order(k: int) -> list:
    """Every chunk's local scatter first, then (cross, ag) per chunk:
    chunk c's cross hop in flight under chunk c+1's scatter."""
    order = [(u, c) for c in range(k) for u in ("rs", "cross", "ag")]
    order.sort(key=lambda uc: (0 if uc[0] == "rs" else 1, uc[1],
                               0 if uc[0] == "cross" else 1))
    return order


def _execute_hier_allreduce(xs: Sequence[torch.Tensor], op, *,
                            descriptor: str, group, n: int,
                            precision: str = "fp32", prescale: float = 1.0,
                            postscale: float = 1.0, block: int = 512,
                            name: str = "allreduce", timeline=None) -> list:
    """Run a fused allreduce group through the chunked two-tier
    ``hier:<n_local>:<k>`` schedule: per chunk a reduce-scatter over the
    local tier, an allreduce of the 1/n_local shard over the cross tier
    (at its own wire mode, :func:`resolve_cross_mode`) and an allgather
    back.  The local scatters are issued first (async), so chunk c's
    cross hop runs while chunk c+1's scatter is in flight; the overlap
    gauge reads the cross windows covered by local ones."""
    from ... import context
    from ..collectives import ReduceOp
    from ..hierarchical import created_tier_groups
    from .lower import parse_hier_descriptor
    n_local, chunks = parse_hier_descriptor(descriptor)
    mode = check_wire(precision, "tiered")
    if group is not None:
        raise ValueError("tiered schedule requires the global process set "
                         "(subgroup topology unknown)")
    if n % n_local or not (1 < n_local < n):
        raise ValueError(
            f"descriptor {descriptor!r} does not divide world size {n}")
    n_cross = n // n_local
    groups = created_tier_groups(n_cross, n_local)
    local, cross = groups["hvd_local"][0], groups["hvd_cross"][0]
    cfg = context.global_state().config
    cross_mode = resolve_cross_mode(mode, cfg)
    quant = mode in R.QUANT_MODES
    average = op is ReduceOp.AVERAGE
    dtype = xs[0].dtype
    itemsize = xs[0].element_size()
    numels = [x.numel() for x in xs]
    total = sum(numels)
    # Chunks cut at the world's unit, quantized when either tier is, so
    # the local shard is a whole number of n_cross * block units and the
    # cross hop scatters on the flat walk's block boundaries.
    mode_eff = mode if quant else cross_mode
    layout = chunk_layout(total, n, chunks, mode_eff, block)
    k = len(layout)
    if quant:
        R.account_wire(mode, total * itemsize, n_local, block,
                       itemsize=itemsize)
    if cross_mode in R.QUANT_MODES:
        R.account_wire(cross_mode, total * itemsize // n_local, n_cross,
                       block, itemsize=itemsize)
    _m_sched_child(descriptor).inc()

    tl_on = timeline is not None and timeline.enabled
    flat = (xs[0].reshape(-1) if len(xs) == 1
            else torch.cat([x.reshape(-1) for x in xs]))
    chunk_bufs = R._pad(flat, sum(layout)).split(layout)
    opened: dict = {}                 # (unit, c) -> (lane, t_open)
    windows: dict = {"local": [], "cross": []}
    flows: dict = {}

    def _open(unit: str, c: int) -> None:
        lane = f"{name}/{'local_' if unit != 'cross' else ''}{unit}.c{c}"
        opened[(unit, c)] = (lane, time.monotonic())
        if tl_on:
            timeline.start_activity(lane, _UNIT_ACTIVITY[unit])
            if unit == "rs":
                flows[c] = timeline.new_flow()
                timeline.flow_start(lane, flows[c])
            elif c in flows:
                timeline.flow_end(lane, flows[c])
                if unit != "ag":
                    flows[c] = timeline.new_flow()
                    timeline.flow_start(lane, flows[c])

    def _close(unit: str, c: int) -> None:
        ent = opened.pop((unit, c), None)
        if ent is None:
            return
        lane, t0 = ent
        windows["cross" if unit == "cross" else "local"].append(
            (t0, time.monotonic()))
        if tl_on:
            timeline.end_activity(lane)

    vals: list = [None] * k
    outs: list = [None] * k
    for unit, c in hier_unit_order(k):
        if unit == "rs":
            _open("rs", c)
            if quant:
                vals[c] = hier_rs_quant(chunk_bufs[c], mode, local, n_local,
                                        block, prescale, async_op=True)
            else:
                vals[c] = rs_fp32(chunk_bufs[c], local, n_local, prescale,
                                  async_op=True)
        elif unit == "cross":
            _close("rs", c)
            _open("cross", c)
            *v, work = vals[c]
            work.wait()
            if quant:
                vals[c] = hier_cross_quant_acc(*v, mode, cross, n_cross,
                                               block, average, n)
            elif cross_mode in R.QUANT_MODES:
                vals[c] = (hier_cross_quant(v[0], cross_mode, cross,
                                            n_cross, block, average, n),)
            else:
                vals[c] = (hier_cross_fp32(v[0], cross, average, n),)
        else:  # ag
            _close("cross", c)
            _open("ag", c)
            v = vals[c]
            if quant:
                outs[c] = R.quant_all_gather(*v, mode, local, n_local,
                                             block, postscale)
            else:
                outs[c] = ag_fp32(v[0], local, n_local, postscale)
    out = (outs[0] if k == 1 else torch.cat(outs))[:total]
    results = [piece.view(x.shape).to(dtype)
               for piece, x in zip(out.split(numels), xs)]
    for c in range(k):
        _close("ag", c)
    # Overlap here: the share of the cross tier's in-flight time hidden
    # under local-tier work.
    _m_overlap.set(_overlap_fraction(windows["cross"], windows["local"]))
    _perf.MODEL.observe_tiers(
        total * itemsize, n_local, n_cross,
        _union_seconds(windows["local"] + windows["cross"]),
        tier_seconds={"local": _union_seconds(windows["local"]),
                      "cross": _union_seconds(windows["cross"])},
        mode=mode, cross_mode=cross_mode, chunks=k, schedule=descriptor,
        block=block, itemsize=itemsize)
    return results
