"""Compiled schedule: the ``rs_ag:<k>`` walk of one fused allreduce as
one CUDA graph.

The port of ``horovod_tpu/ops/sched/compiled.py``.  The reference lowers
the schedule into one jitted program so that the host issues one launch
instead of one per unit.  On the card the counterpart is a
``torch.cuda.CUDAGraph`` per schedule signature: the first dispatch of a
signature runs the walk once outside capture (NCCL has its communicator
and the allocator its blocks before capture, as the reference builds
outside its timing window), captures the whole walk on the engine's
stream — every chunk's reduce-scatter, combine and allgather, and for
int8/fp8 the MAX all-reduce, the quantize and the dequantize — and every
dispatch of the signature replays it.

Numerics: the graph replays :func:`.executor.walk`, so the chunk
boundaries (:func:`~.lower.chunk_layout`) and per-chunk arithmetic are
the dispatched ``rs_ag:<k>`` walk's and the result is bit-identical to
it, and for int8/fp8 also to the monolithic path (reference :17-30).

Buffers.  The fused group is new every cycle, so each dispatch copies it
into the graph's static input (zero padding written once, at capture),
replays, and clones the static output before it returns: the engine
never hands callers memory that the next replay overwrites.

Memory pool.  All graphs share one pool.  That is safe here because every
replay runs on the engine's one stream, so no two replays overlap, and a
graph's static outputs stay referenced for the graph's life, so no other
graph's temporaries ever alias them; the pool then holds the largest
signature's temporaries rather than the sum over signatures.
:func:`stats` reports the bytes the pool reserved.

On the CPU (Gloo) nothing can be captured: the same walk runs eagerly as
one function.  A capture or replay failure on CUDA raises; nothing gives
way to the dispatched walk.

``hvd_sched_compiled_dispatches_total{schedule}`` counts each dispatch,
as in the reference (:61-75); ``hvd_sched_dispatches_total`` never moves
on this path.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import torch

from ...obs import REGISTRY as _obs
from ...obs import perfmodel as _perf
from .. import reduction as R
from .executor import check_wire, walk
from .lower import chunk_layout, parse_compiled_descriptor

_m_compiled = _obs.counter(
    "hvd_sched_compiled_dispatches_total",
    "single-program compiled-schedule collective dispatches",
    ("schedule",))
_m_compiled_d: dict = {}


def _m_compiled_child(descriptor: str):
    child = _m_compiled_d.get(descriptor)
    if child is None:
        child = _m_compiled_d.setdefault(
            descriptor, _m_compiled.labels(schedule=descriptor))
    return child


class _Graph:
    """One captured signature: the graph, its static input (the padded
    flat payload) and its static output (the flat result)."""

    __slots__ = ("graph", "static_in", "static_out", "replays")

    def __init__(self, graph, static_in, static_out) -> None:
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.replays = 0


_lock = threading.Lock()
_graphs: dict = {}
_pool = None
_stats = {"captures": 0, "capture_s": 0.0, "pool_bytes": 0}


def stats() -> dict:
    """Graphs captured (one a signature), replays, seconds spent in
    warm-up and capture, and the bytes the shared pool reserved."""
    with _lock:
        return {"graphs": len(_graphs),
                "replays": sum(g.replays for g in _graphs.values()),
                "captures": _stats["captures"],
                "capture_s": _stats["capture_s"],
                "pool_bytes": _stats["pool_bytes"]}


def clear() -> None:
    """Drop every graph (their NCCL calls name the process group of the
    runtime that captured them); ``shutdown`` calls it."""
    global _pool
    with _lock:
        _graphs.clear()
        _pool = None
        _stats.update(captures=0, capture_s=0.0, pool_bytes=0)


def _run(flat: torch.Tensor, layout, **kw) -> torch.Tensor:
    """The whole walk as one function: padded ``flat`` in, the flat
    result (``sum(layout)`` elements) out."""
    outs = walk(flat.split(list(layout)), **kw)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _pack(xs: Sequence[torch.Tensor], dst: torch.Tensor) -> None:
    """The group's tensors, flattened and concatenated, into ``dst``."""
    if len(xs) == 1:
        dst.copy_(xs[0].reshape(-1))
    else:
        torch.cat([x.reshape(-1) for x in xs], out=dst)


def _capture(key, xs: Sequence[torch.Tensor], plen: int, total: int,
             layout, kw) -> _Graph:
    """Warm the signature up outside capture, then capture its walk on
    the current (the engine's) stream into the shared pool."""
    global _pool
    t0 = time.monotonic()
    dev, dtype = xs[0].device, xs[0].dtype
    stream = torch.cuda.current_stream(dev)
    static_in = torch.zeros(plen, dtype=dtype, device=dev)
    _pack(xs, static_in[:total])
    _run(static_in, layout, **kw)         # warm-up: communicator, blocks
    # Capture empties the allocator's cache first; do it here, so that
    # what the capture reserves shows as the pool's growth.
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    if _pool is None:
        _pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=_pool, stream=stream,
                          capture_error_mode="thread_local"):
        static_out = _run(static_in, layout, **kw)[:total].to(dtype)
    g = _Graph(graph, static_in, static_out)
    with _lock:
        _graphs[key] = g
        _stats["captures"] += 1
        _stats["capture_s"] += time.monotonic() - t0
        _stats["pool_bytes"] += max(
            0, torch.cuda.memory_reserved(dev) - reserved)
    return g


def execute_allreduce(xs: Sequence[torch.Tensor], op, *, descriptor: str,
                      group, n: int, precision: str = "fp32",
                      prescale: float = 1.0, postscale: float = 1.0,
                      block: int = 512, name: str = "allreduce",
                      timeline=None) -> list:
    """Run a fused allreduce group through the compiled backend named by
    ``descriptor`` (``"compiled:rs_ag:<k>"``); the call contract of
    :func:`.executor.execute_allreduce`."""
    from ..collectives import ReduceOp
    chunks = parse_compiled_descriptor(descriptor)
    if chunks is None:
        raise ValueError(
            f"unknown compiled schedule descriptor {descriptor!r}")
    mode = check_wire(precision, "compiled")
    dtype = xs[0].dtype
    numels = tuple(x.numel() for x in xs)
    shapes = tuple(tuple(x.shape) for x in xs)
    total = sum(numels)
    layout = tuple(chunk_layout(total, n, chunks, mode, block))
    plen = sum(layout)
    itemsize = xs[0].element_size()
    average = op is ReduceOp.AVERAGE
    kw = dict(mode=mode, group=group, n=n, block=block, average=average,
              prescale=float(prescale), postscale=float(postscale))
    if mode != "fp32":
        R.account_wire(mode, total * itemsize, n, block, itemsize=itemsize)
    _m_compiled_child(descriptor).inc()

    tl_on = timeline is not None and timeline.enabled
    lane = f"{name}/compiled"
    if tl_on:
        timeline.start_activity(lane, "SCHED_COMPILED")
    t0 = time.monotonic()
    if xs[0].is_cuda:
        # The reference's signature (:214), with the group and device.
        key = (descriptor, op, dtype, numels, shapes, mode, block,
               float(prescale), float(postscale), n, id(group),
               xs[0].device)
        with _lock:
            g = _graphs.get(key)
        if g is None:
            g = _capture(key, xs, plen, total, layout, kw)
        _pack(xs, g.static_in[:total])
        g.graph.replay()
        g.replays += 1
        out = g.static_out.clone()
    else:
        flat = (xs[0].reshape(-1) if len(xs) == 1
                else torch.cat([x.reshape(-1) for x in xs]))
        out = _run(R._pad(flat, plen), layout, **kw)[:total].to(dtype)
    t1 = time.monotonic()
    if tl_on:
        timeline.end_activity(lane)
    # One program, one window: the perf model's compiled arm supplies the
    # matching expectation (overlap is inside the graph).
    _perf.MODEL.observe_schedule(
        descriptor=descriptor, mode=mode, payload_bytes=total * itemsize,
        n=n, chunks=len(layout), comm_windows=[(t0, t1)],
        compute_windows=[], block=block, itemsize=itemsize)
    return [piece.view(shape) for piece, shape in
            zip(out.split(list(numels)), shapes)]
