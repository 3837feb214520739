"""Engine-side schedule executor: the chunked reduce-scatter -> combine ->
allgather walk of one (possibly fused) allreduce.

The port of ``horovod_tpu/ops/sched/executor.py``, the flat ``rs_ag:<k>``
family.  Per chunk there are three dispatch units: a *reduce-scatter*
unit (the quantized wire's encode folded in), a *combine* unit (the fp32
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
                  "ag": "SCHED_AG"}


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
            from . import _refuse
            raise _refuse(f"schedule {descriptor!r}")
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
