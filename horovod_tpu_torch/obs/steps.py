"""Training-step spans: where the host's time goes in one step of
``DistributedOptimizer``.

While *armed* — a torch profiler records, or the Horovod timeline is
enabled — each optimizer step is one trace of the process's
:data:`~.trace.TRACER`, named for what the host was doing:

==========================  ==========================================
span                        from → to
==========================  ==========================================
``hvd.step`` (root)         ``zero_grad()`` (or the first gradient
                            hook when none was called) → the end of
                            ``step()``
``hvd.step.forward``        ``zero_grad()`` → the first gradient hook
``hvd.step.backward``       the first → the last gradient hook
``hvd.step.allreduce_wait`` ``synchronize()``
``hvd.step.optimizer``      the wrapped optimizer's ``step()``
``hvd.engine.cycle``        an engine cycle that carried entries, with
                            children ``hvd.engine.negotiate`` and
                            ``hvd.engine.dispatch`` (the engine's thread)
``hvd.gc``                  one pass of the garbage collector
``hvd.prof.tick``,          one tick of the host samplers
``hvd.tsdb.tick``           (:mod:`.prof`, :mod:`.tsdb`)
==========================  ==========================================

The root's attributes are the counters at its boundaries: gradients
enqueued, and the deltas of the engine's groups dispatched, tensors,
bytes and cycles, and of the collector's passes and their ms.  The
engine, gc and sampler spans are children of the step open in the
process, :data:`CURRENT`, which the optimizer sets; they run in other
threads, which a ``contextvars`` span would not reach.

Unarmed, every site is one test (``CURRENT is None``, or the optimizer's
own step reference): no span, no clock read, no ``record_function``, no
work a gradient.  Armed, every step is recorded (no sampling).  While a
torch profiler records, the training thread's spans (the root and its
four phases) are also entered as ``torch.profiler.record_function``
ranges of their names, so a profile with CPU activity shows them on the
host's rows (``hvd.step.backward``'s range runs from the first gradient
hook to ``synchronize()``).  The other threads' spans get none: a
profile started in the training thread records no range of another
thread.  An engine cycle's three spans are made at the cycle's end from
its clock reads, a collector pass's at the step's close, and no step
span is written to the flight recorder, whose ring they would flood.

Placing spans on a device timeline.  A finished trace gives
``t_start_unix`` and each span's offset, so every span's bounds in unix
seconds, the clock ``torch.profiler`` stamps its events with.  When a
step opens on a CUDA device it reads the wall clock into the root's
``marker_unix_s`` and then launches one marker kernel,
``torch.cuda._sleep(1)`` (``spin_kernel``), on the current stream: the
marker starts on the device no earlier than that host time, so over a
profile's steps the largest ``marker_unix_s`` less its marker's start is
the offset between the two clocks, exact to one launch's latency when a
marker meets an idle device.  CUDA loads a kernel's module at its first
launch, which delayed a first marker by 0.4-1.0 ms on an H100 and, inside
a profile, left a 2.2-2.6 ms gap on the device, so the optimizer loads
the kernel at the first step it does not record (:func:`load_marker`).  A
device whose first step is recorded launches it there, before the clock
read; that root's ``markers`` says so (2, else 1).

Stdlib-only at import, like the rest of ``obs``; torch is reached only
through modules the caller already imported.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Optional

from . import trace as _trace
from .registry import REGISTRY

#: the timeline rows: the training thread's phases, the engine's cycles,
#: the collector's passes and each sampler's ticks
STEP_LANE, ENGINE_LANE, GC_LANE = "hvd.step", "hvd.engine", "hvd.gc"

#: the open :class:`StepSpans` of this process, or None
CURRENT: Optional["StepSpans"] = None

# (attribute of the root, registry counter) read at the step's bounds
_COUNTERS = (("groups", "hvd_engine_dispatches_total"),
             ("tensors", "hvd_collectives_total"),
             ("bytes", "hvd_collective_bytes_total"),
             ("cycles", "hvd_engine_cycles_total"))

# CUDA devices (by index) on which the marker kernel has been launched
_LOADED: set = set()


def profiling() -> bool:
    """Whether a torch profiler records now: the flag of
    ``torch.autograd.profiler`` that a profile's start and stop flip."""
    p = sys.modules.get("torch.autograd.profiler")
    return p is not None and p._is_profiler_enabled


def armed(timeline) -> bool:
    """A step is recorded while a torch profiler records or while
    ``timeline`` (the runtime's Horovod timeline, or None) is enabled."""
    return profiling() or (timeline is not None and timeline.enabled)


def load_marker(device) -> None:
    """Launch the marker kernel on a CUDA ``device`` once, so CUDA loads
    it before a recorded step needs it."""
    if device.type == "cuda" and device.index not in _LOADED:
        torch = sys.modules["torch"]
        with torch.cuda.device(device):
            torch.cuda._sleep(1)
        _LOADED.add(device.index)


def _counters() -> dict:
    out = {}
    for key, metric in _COUNTERS:
        fam = REGISTRY.get(metric)
        out[key] = fam.total() if fam is not None else 0.0
    return out


class StepSpans:
    """One optimizer step's trace, open from :meth:`open` to :meth:`close`
    (the optimizer calls both, and :meth:`grad`, :meth:`waiting`,
    :meth:`waited` and :meth:`optimizer` in between)."""

    def __init__(self, timeline, device, at_zero_grad: bool) -> None:
        self.root = _trace.TRACER.start_trace(
            "hvd.step", lane=STEP_LANE, timeline=timeline, dense=True)
        # The training thread's open record_function ranges by name, or
        # None while no profiler records.
        self._rfs: Optional[dict] = {} if profiling() else None
        self._enter("hvd.step")
        if at_zero_grad:
            self._enter("hvd.step.forward")
        if device is not None and device.type == "cuda":
            self._marker(device)
        self._forward = at_zero_grad
        self._first: Optional[float] = None
        self._last: Optional[float] = None
        self._phase: Optional[_trace.Span] = None
        self.gradients = 0
        self._base = _counters()
        # Collector passes as (start, end, generation, collected): a gc
        # callback may run inside any lock (the tracer's too), so it only
        # appends, and the spans are made at close.
        self._gc: list = []
        self._gc_t0: Optional[float] = None
        gc.callbacks.append(self._on_gc)

    @classmethod
    def open(cls, timeline, device, at_zero_grad: bool) -> "StepSpans":
        """Open a step and make it :data:`CURRENT` (a step left open by
        an abandoned iteration is closed first)."""
        global CURRENT
        stale = CURRENT
        if stale is not None:
            stale.close(abandoned=True)
        CURRENT = cls(timeline, device, at_zero_grad)
        return CURRENT

    def _marker(self, device) -> None:
        """Read the wall clock, then launch the marker kernel (loaded
        first where no earlier step loaded it)."""
        loads = device.index not in _LOADED
        load_marker(device)
        self.root.attrs["markers"] = 1 + loads
        torch = sys.modules["torch"]
        with torch.cuda.device(device):
            self.root.attrs["marker_unix_s"] = time.time()
            torch.cuda._sleep(1)

    def _enter(self, name: str) -> None:
        if self._rfs is not None:
            rf = sys.modules["torch"].profiler.record_function(name)
            rf.__enter__()
            self._rfs[name] = rf

    def _exit(self, name: str) -> None:
        rf = self._rfs.pop(name, None) if self._rfs else None
        if rf is not None:
            rf.__exit__(None, None, None)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.monotonic()
        elif self._gc_t0 is not None:
            self._gc.append((self._gc_t0, time.monotonic(),
                             info.get("generation"), info.get("collected")))
            self._gc_t0 = None

    def grad(self, enqueued: bool) -> None:
        """A gradient hook fired (``enqueued``: it started an allreduce)."""
        t = time.monotonic()
        if self._first is None:
            self._first = t
            if self._forward:
                self.root.child_at("hvd.step.forward", self.root.t0, t)
            self._exit("hvd.step.forward")
            self._enter("hvd.step.backward")
        self._last = t
        self.gradients += enqueued

    def waiting(self, handles: int) -> None:
        """``synchronize()`` starts: the backward phase is over."""
        if self._first is not None:
            self.root.child_at("hvd.step.backward", self._first, self._last)
        self._exit("hvd.step.backward")
        self._begin("hvd.step.allreduce_wait", handles=handles)

    def waited(self) -> None:
        """``synchronize()`` returns (or raises)."""
        self._end()

    def optimizer(self) -> None:
        """The wrapped optimizer's ``step()`` starts; :meth:`close` ends
        it."""
        self._begin("hvd.step.optimizer")

    def _begin(self, name: str, **attrs) -> None:
        self._phase = self.root.child(name, **attrs)
        self._enter(name)

    def _end(self) -> None:
        span, self._phase = self._phase, None
        if span is not None:
            self._exit(span.name)
            span.end()

    def cycle(self, t0: float, negotiate: tuple,
              dispatch: Optional[tuple], **attrs) -> None:
        """An engine cycle under this step that started at ``t0``
        (``time.monotonic()``) and ends now, with the ``(start, end)``
        of its negotiation and of its dispatch (None when it failed
        before dispatching)."""
        c = self.root.child_at("hvd.engine.cycle", t0, time.monotonic(),
                               lane=ENGINE_LANE, **attrs)
        c.child_at("hvd.engine.negotiate", *negotiate, lane=ENGINE_LANE)
        if dispatch is not None:
            c.child_at("hvd.engine.dispatch", *dispatch, lane=ENGINE_LANE)

    def close(self, **attrs) -> None:
        global CURRENT
        try:
            gc.callbacks.remove(self._on_gc)
        except ValueError:
            pass
        self._end()
        passes = list(self._gc)
        for t0, t1, gen, collected in passes:
            self.root.child_at("hvd.gc", t0, t1, lane=GC_LANE,
                               generation=gen, collected=collected)
        now = _counters()
        self.root.end(gradients=self.gradients,
                      **{k: int(now[k] - self._base[k]) for k in now},
                      gc_passes=len(passes),
                      gc_ms=round(1e3 * sum(t1 - t0
                                            for t0, t1, _, _ in passes), 3),
                      **attrs)
        for name in ("hvd.step.backward", "hvd.step.forward", "hvd.step"):
            self._exit(name)
        if CURRENT is self:
            CURRENT = None
