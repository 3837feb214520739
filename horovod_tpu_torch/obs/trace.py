"""Request-scoped distributed tracing: spans, trace ids, causal chains.

The metrics plane (:mod:`horovod_tpu_torch.obs.registry`) answers "how is the
job doing in aggregate"; it cannot answer "*why was this request slow*".
Aggregate throughput systematically hides where per-request time goes
(Awan et al., arXiv:1810.11112) — a p99 TTFT histogram says *that* the
tail is long, not whether request 17 spent it queued, prefilling, or
waiting out someone else's fused collective.  This module adds the
missing causal layer:

- a **span** is one timed phase of one request (QUEUE, PREFILL, DECODE,
  ...) carrying a ``trace_id`` shared by every span of that request, a
  ``span_id``, and a ``parent_id`` — the standard distributed-tracing
  triple, dependency-free;
- the **current span** propagates through a ``contextvars.ContextVar``,
  so nested layers (the serving engine calling into the collective
  engine) can attach events to whichever request is being worked on
  without plumbing arguments through every signature;
- ended spans are emitted three ways: as Timeline-v2 complete events
  (one ``"X"`` slice per span on the request's lane, with ``s``/``f``
  flow arrows chaining QUEUE→PREFILL→DECODE so the request reads as one
  connected chain in Perfetto), into the flight recorder ring
  (:mod:`horovod_tpu_torch.obs.flightrec`) for postmortems, and into a bounded
  in-memory table exportable **per request as JSON**
  (:meth:`Tracer.export`);
- tracing is **sampled**: ``HOROVOD_TPU_TRACE_SAMPLE`` (0.0–1.0, default
  1.0) decides per trace at :meth:`Tracer.start_trace`; an unsampled
  trace costs one comparison — every span call on it is a no-op on the
  shared :data:`NULL_SPAN`;
- traces **cross process boundaries**: :meth:`Span.context` serializes
  the ``(trace_id, span_id, sampled)`` triple as a plain dict that rides
  any transport (frontdoor request payloads, the disagg migration
  manifest), and ``start_trace(parent=ctx)`` adopts it on the far side —
  same ``trace_id``, root parented under the remote span, and the
  ingress sampling decision honored verbatim (``sampled=False`` short-
  circuits to :data:`NULL_SPAN` with no local re-roll).  Span ids carry
  a per-process random salt so they stay unique fleet-wide, so a merged
  view can stitch cross-process flow arrows by ``(trace_id, span_id)``
  alone.

Stdlib-only, importable before (and without) torch, like the rest of
``obs``.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Optional

from .registry import REGISTRY

_m_traces = REGISTRY.counter(
    "hvd_traces_total", "request traces by sampling decision", ("sampled",))
_m_spans = REGISTRY.counter(
    "hvd_trace_spans_total", "spans ended across all sampled traces")

#: finished traces kept for JSON export (oldest evicted first)
DEFAULT_KEEP = 64

_current: contextvars.ContextVar = contextvars.ContextVar(
    "hvdtpu_current_span", default=None)


def _env(suffix: str) -> Optional[str]:
    for prefix in ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_"):
        v = os.environ.get(prefix + suffix)
        if v is not None:
            return v
    return None


def sample_rate_from_env() -> float:
    """``HVDTPU_/HOROVOD_TPU_/HOROVOD_ TRACE_SAMPLE`` in [0, 1];
    default 1.0 (trace everything — the serving bench holds the
    traced-on overhead under the 2% budget at this default)."""
    raw = _env("TRACE_SAMPLE")
    if raw is None:
        return 1.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 1.0


def current_span() -> Optional["Span"]:
    """The span the calling context is working under, or None.  Never
    returns :data:`NULL_SPAN` — callers can use the result truthily."""
    sp = _current.get()
    return sp if sp is not None and sp is not NULL_SPAN else None


class _TraceState:
    """Shared bookkeeping of one sampled trace (all spans point here)."""

    __slots__ = ("trace_id", "name", "lane", "timeline", "tracer",
                 "spans", "t_wall0", "t_mono0", "lock", "dense")

    def __init__(self, tracer: "Tracer", trace_id: str, name: str,
                 lane: str, timeline, dense: bool = False) -> None:
        self.tracer = tracer
        self.trace_id = trace_id
        self.name = name
        self.lane = lane
        self.timeline = timeline
        self.spans: list = []
        self.t_wall0 = time.time()
        self.t_mono0 = time.monotonic()
        self.lock = threading.Lock()
        self.dense = dense


class Span:
    """One timed phase of one trace.  End exactly once (``end()`` or the
    context-manager exit); ``child()`` opens a sub-span, ``after=`` draws
    a flow arrow from an already-ended sibling so sequential phases render
    as one connected chain."""

    __slots__ = ("_st", "span_id", "parent_id", "name", "t0", "t1",
                 "attrs", "events", "_after", "_ctx_token", "_root", "lane")

    def __init__(self, st: _TraceState, name: str,
                 parent_id: Optional[str], after: Optional["Span"] = None,
                 lane: Optional[str] = None, **attrs: Any) -> None:
        self._st = st
        self.span_id = f"{st.tracer._salt}-{st.tracer._next_id():x}"
        self.parent_id = parent_id
        self.name = name
        self.t0 = time.monotonic()
        self.t1: Optional[float] = None
        self.attrs = dict(attrs)
        self.events: list = []
        self._after = after
        self._ctx_token = None
        self._root = False
        # The timeline row this span renders on (None: its trace's lane).
        self.lane = lane

    # -- identity ---------------------------------------------------------
    @property
    def trace_id(self) -> str:
        return self._st.trace_id

    @property
    def sampled(self) -> bool:
        return True

    def context(self) -> dict:
        """The wire-format trace context: a JSON-ready dict carrying the
        ``(trace_id, span_id, sampled)`` triple.  Ship it in a request
        payload or migration manifest and pass it to
        ``start_trace(parent=...)`` on the receiving process."""
        return {"trace_id": self._st.trace_id,
                "span_id": self.span_id,
                "sampled": True}

    # -- recording --------------------------------------------------------
    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        """Zero-duration annotation inside this span (e.g. a collective
        the engine enqueued while working this request)."""
        self.events.append({"name": name,
                            "t_offset_s": round(
                                time.monotonic() - self._st.t_mono0, 6),
                            **({"attrs": attrs} if attrs else {})})

    def child(self, name: str, *, after: Optional["Span"] = None,
              lane: Optional[str] = None, **attrs: Any) -> "Span":
        """Sub-span of this one.  ``after=`` links a flow arrow from an
        ended sibling span (the previous phase) to this one; ``lane``
        renders it on its own timeline row (a span of another thread,
        which would not nest in its parent's row)."""
        return Span(self._st, name, self.span_id, after=after, lane=lane,
                    **attrs)

    def child_at(self, name: str, t0: float, t1: float, *,
                 lane: Optional[str] = None, **attrs: Any) -> "Span":
        """An already-finished sub-span from ``t0`` to ``t1``
        (``time.monotonic()`` values): a phase whose bounds are known
        only after the fact (the first and last of many events)."""
        sp = Span(self._st, name, self.span_id, lane=lane, **attrs)
        sp.t0, sp.t1 = t0, t1
        self._st.tracer._span_ended(sp)
        return sp

    def end(self, **attrs: Any) -> None:
        if self.t1 is not None:     # idempotent: error paths double-close
            return
        if attrs:
            self.attrs.update(attrs)
        self.t1 = time.monotonic()
        self._st.tracer._span_ended(self)

    @property
    def ended(self) -> bool:
        return self.t1 is not None

    # -- propagation ------------------------------------------------------
    def use(self) -> "_SpanContext":
        """``with span.use():`` makes this the context's current span, so
        nested layers can attach via :func:`current_span`."""
        return _SpanContext(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and "error" not in self.attrs:
            self.attrs["error"] = repr(exc)
        self.end()


class _SpanContext:
    __slots__ = ("_span", "_token")

    def __init__(self, span) -> None:
        self._span = span
        self._token = None

    def __enter__(self):
        self._token = _current.set(self._span)
        return self._span

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None


class _NullSpan:
    """Shared no-op span for unsampled traces: every method returns
    instantly, ``child()`` returns itself, so call sites never branch."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    name = ""
    attrs: dict = {}
    events: list = []
    sampled = False
    ended = True

    def set(self, **attrs):
        return self

    def context(self) -> dict:
        # The ingress said "don't sample"; downstream must honor it.
        return {"sampled": False}

    def event(self, name, **attrs):
        pass

    def child(self, name, *, after=None, **attrs):
        return self

    def end(self, **attrs):
        pass

    def use(self):
        return _NULL_CTX

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def __bool__(self) -> bool:
        # NULL_SPAN is falsy so `req.trace or ...` reads naturally, but
        # prefer `.sampled` in new code.
        return False


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return NULL_SPAN

    def __exit__(self, *exc):
        pass


NULL_SPAN = _NullSpan()
_NULL_CTX = _NullContext()


def _coerce_context(parent) -> Optional[dict]:
    """Normalize a ``parent=`` value to a context dict (or None).
    Accepts a :class:`Span`/:data:`NULL_SPAN` (uses its ``context()``),
    an already-serialized dict, or None.  Unrecognizable values are
    treated as absent — a malformed manifest field must degrade to a
    fresh local sampling decision, not a crash."""
    if parent is None:
        return None
    ctx = getattr(parent, "context", None)
    if callable(ctx):
        try:
            parent = ctx()
        except Exception:
            return None
    return parent if isinstance(parent, dict) else None


class Tracer:
    """Process-wide trace factory + bounded finished-trace table."""

    def __init__(self, *, sample_rate: Optional[float] = None,
                 keep: Optional[int] = None) -> None:
        self.sample_rate = (sample_rate_from_env()
                            if sample_rate is None else float(sample_rate))
        if keep is None:
            raw_keep = _env("TRACE_KEEP")
            try:
                keep = int(raw_keep) if raw_keep else DEFAULT_KEEP
            except ValueError:   # env typo must not break import
                keep = DEFAULT_KEEP
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._rng = random.Random(os.urandom(8))
        # Per-process salt on span ids: a trace that crosses processes
        # holds spans minted by several tracers whose counters all start
        # at 1, so bare counters would collide within one trace_id.
        self._salt = f"{self._rng.getrandbits(24):06x}"
        self._finished: "OrderedDict[str, _TraceState]" = OrderedDict()
        self.last_trace_id: Optional[str] = None

    def _next_id(self) -> int:
        with self._lock:
            return next(self._ids)

    def _should_sample(self) -> bool:
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < rate

    # -- trace lifecycle --------------------------------------------------
    def start_trace(self, name: str, *, lane: Optional[str] = None,
                    timeline=None, parent=None, dense: bool = False,
                    **attrs: Any):
        """Root span of a new trace, or :data:`NULL_SPAN` when the
        sampling decision says no.  ``lane`` names the Timeline-v2 row
        the trace's spans render on (defaults to the trace id);
        ``timeline`` is the :class:`~horovod_tpu_torch.utils.timeline.Timeline`
        sink (None = no timeline emission, JSON/flight-recorder only).

        ``parent`` joins an existing trace instead of opening a new one:
        pass a :class:`Span` or a :meth:`Span.context` dict (possibly
        deserialized on the far side of a transport).  The local root
        adopts the parent's ``trace_id`` and is parented under the remote
        ``span_id``; the parent's sampling decision is final — a
        ``sampled=False`` context returns :data:`NULL_SPAN` without
        consulting the local sample rate, so one ingress decision governs
        the whole distributed chain.

        ``dense`` is for a caller that records only while a profiler or
        the timeline watches, and then hundreds of spans a second
        (:mod:`.steps`): every such trace is kept whatever the sample
        rate, and its spans stay out of the flight recorder, whose ring
        they would flood."""
        ctx = _coerce_context(parent)
        if ctx is not None:
            if not ctx.get("sampled") or not ctx.get("trace_id"):
                _m_traces.labels(sampled="false").inc()
                return NULL_SPAN
            _m_traces.labels(sampled="true").inc()
            trace_id = str(ctx["trace_id"])
            parent_sid = ctx.get("span_id")
            parent_sid = str(parent_sid) if parent_sid else None
        else:
            if not dense and not self._should_sample():
                _m_traces.labels(sampled="false").inc()
                return NULL_SPAN
            _m_traces.labels(sampled="true").inc()
            with self._lock:
                trace_id = f"{self._rng.getrandbits(64):016x}"
            parent_sid = None
        st = _TraceState(self, trace_id, name,
                         lane or f"trace:{trace_id[:8]}",
                         timeline if timeline is not None
                         and getattr(timeline, "enabled", False) else None,
                         dense)
        sp = Span(st, name, parent_sid, **attrs)
        sp._root = True
        return sp

    def _span_ended(self, span: Span) -> None:
        st = span._st
        rec = {
            "trace_id": st.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "name": span.name,
            "t_offset_s": round(span.t0 - st.t_mono0, 6),
            "duration_s": round(span.t1 - span.t0, 6),
        }
        if span.attrs:
            rec["attrs"] = dict(span.attrs)
        if span.events:
            rec["events"] = list(span.events)
        with st.lock:
            st.spans.append(rec)
        _m_spans.inc()
        tl = st.timeline
        if tl is not None:
            tl.complete(span.lane or st.lane, span.name, span.t0, span.t1,
                        args={"trace_id": st.trace_id,
                              "span_id": span.span_id,
                              **span.attrs})
            prev = span._after
            if prev is not None and prev.ended and prev is not NULL_SPAN:
                fid = tl.new_flow()
                # Arrow from the tail of the previous phase's slice to
                # the head of this one: the QUEUE→PREFILL→DECODE chain.
                tl.flow_at(st.lane, fid, "s", prev.t1)
                tl.flow_at(st.lane, fid, "f", span.t0)
        if not st.dense:
            from . import flightrec
            # Attrs are caller-controlled: keys that collide with
            # record()'s own parameters must not turn span.end() into a
            # TypeError.
            reserved = ("kind", "name", "trace", "span", "dur_s")
            flightrec.RECORDER.record(
                "span", name=span.name, trace=st.trace_id,
                span=span.span_id, dur_s=rec["duration_s"],
                **{k: v for k, v in span.attrs.items()
                   if k not in reserved
                   and isinstance(v, (int, float, str, bool))})
        # Root ended -> trace finished.  An adopted root (remote parent)
        # has a non-None parent_id, hence the explicit flag.
        if span._root or span.parent_id is None:
            self._finish(st)

    def _finish(self, st: _TraceState) -> None:
        with self._lock:
            self._finished[st.trace_id] = st
            self._finished.move_to_end(st.trace_id)
            # export(None) == "most recently FINISHED": with overlapping
            # requests the last-started trace may still be open, so the
            # stamp belongs here, not in start_trace.
            self.last_trace_id = st.trace_id
            while len(self._finished) > self.keep:
                self._finished.popitem(last=False)

    # -- export -----------------------------------------------------------
    def export(self, trace_id: Optional[str] = None) -> Optional[dict]:
        """One finished trace as a plain JSON-ready dict (``None`` ==
        the most recently finished).  Returns None when unknown/evicted/
        unsampled."""
        with self._lock:
            tid = trace_id or self.last_trace_id
            st = self._finished.get(tid) if tid else None
        if st is None:
            return None
        with st.lock:
            spans = list(st.spans)
        return {
            "trace_id": st.trace_id,
            "name": st.name,
            "lane": st.lane,
            "t_start_unix": round(st.t_wall0, 6),
            "spans": spans,
        }

    def export_all(self) -> list:
        """Every finished trace still in the bounded table, oldest first
        — the per-rank publication unit for the fleet trace plane."""
        with self._lock:
            ids = list(self._finished)
        out = []
        for tid in ids:
            d = self.export(tid)
            if d is not None:
                out.append(d)
        return out

    def finished_ids(self) -> list:
        with self._lock:
            return list(self._finished)


#: the process-wide tracer every instrumented layer uses
TRACER = Tracer()


def start_trace(name: str, **kw):
    return TRACER.start_trace(name, **kw)


def export(trace_id: Optional[str] = None) -> Optional[dict]:
    return TRACER.export(trace_id)
