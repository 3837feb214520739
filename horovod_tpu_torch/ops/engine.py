"""Asynchronous collective engine: tensor queue + background fusion cycle.

The port of ``horovod_tpu/ops/engine.py``.  Reference architecture
(† ``horovod/common/operations.cc``): framework ops enqueue a
``TensorTableEntry`` and return immediately; a background thread
(``BackgroundThreadLoop`` → ``RunLoopOnce`` every ``HOROVOD_CYCLE_TIME``
ms) negotiates readiness across ranks, fuses ready tensors up to
``HOROVOD_FUSION_THRESHOLD`` bytes, executes one collective per fused
batch, and fires completion callbacks.  ``synchronize(handle)`` blocks the
caller († ``horovod/torch/mpi_ops_v2.cc HandleManager``).

Kept from the JAX engine: the cycle thread, the urgent nudge from
``synchronize``, duplicate-name rejection, fusion by (op, dtype, process
set, prescale, postscale) up to ``fusion_threshold``, negotiation through
a pluggable :class:`Negotiator` (the native controller across processes,
:mod:`.negotiator`), ``join()`` zero participation, stall attribution,
the timeline's QUEUE → NEGOTIATE → DISPATCH phases and the ``obs``
counters.  One rank's engine never skips its collective, not even alone:
at one rank it still issues every NCCL call.

What torch needs that JAX did not:

- **Streams.**  JAX ordered device work by its async dispatch; here the
  engine owns a CUDA stream.  ``enqueue`` records an event on the
  caller's current stream (the stream that produced the tensor), and the
  engine's stream waits on it before it reads the tensor.  The engine
  packs, reduces and unpacks on its own stream, records a completion
  event there, and :meth:`Handle.wait` makes the caller's current stream
  wait on that event: no host synchronisation of the device anywhere.
  Tensors the engine's stream touches but did not allocate are
  ``record_stream``-ed to it, so freeing one early (``zero_grad(
  set_to_none=True)``) cannot hand its memory to other work while the
  engine still reads it.
- **Fusion buffers.**  Where XLA folded the flatten and concat into the
  compiled program, a fused group here is packed into one flat buffer on
  the device (``torch.cat``), reduced by one collective and copied back
  out, the division of an ``AVERAGE`` folded into that copy.  A group of
  one runs in place with no copy.

- **Timing a dispatch.**  The performance model (:mod:`..obs.perfmodel`)
  is fed each group's achieved time, as in the JAX engine.  On the CPU
  over Gloo the collective is synchronous and its host window is that
  time; on the card the host window holds only the launch, so the group
  is timed by CUDA timing events around its work on the engine's stream
  and read in a later cycle once the work has finished, never by a
  synchronisation.  At one rank the model has no wire to time, so no
  event is created.

The online autotuner (:mod:`..utils.autotune`, ``config.autotune``)
scores each busy cycle's host window and commits the fusion threshold,
the cycle time and the bucket cap (``config.bucket_bytes``, which caps a
fused group like the threshold) to the live config.  Each rank tunes
from its own scores, so the caps of two ranks may differ: every entry's
negotiation meta carries its rank's cap, and every rank fuses a cycle by
the least cap among the metas the coordinator echoes, which are the same
on every rank.  (The JAX engine fuses by its own rank's knobs.)

Wire precision and schedule (:mod:`.reduction`, :mod:`.sched`).  Each
allreduce entry carries the wire mode (``precision``) and the schedule
descriptor (``schedule``) resolved at enqueue from values every rank
agrees on; both ride the negotiation meta (``wp``, ``sc``), a joined rank
builds its zeros at the same mode and schedule, a rank whose own
resolution differs adopts the coordinator's echoed values, and ``_fuse``
keys on both.  A group at a cast or quantized mode packs into the fusion
buffer and goes through :func:`.reduction.allreduce`; a group with a
schedule through :func:`.sched.executor.execute_allreduce`; an Adasum
entry, never fused, through :func:`.adasum.adasum_allreduce`
(:func:`.collectives.allreduce_`).  Under a valid hierarchical split
(:func:`.collectives.hier_route`) an fp32 SUM or float AVERAGE group goes
through the two tiers (:func:`.hierarchical.hierarchical_allreduce_`).
All of it runs on the engine's stream.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

from . import collectives as C
from . import reduction as R
from .sched.lower import known_descriptor
from .. import chaos
from ..context import HorovodInternalError
from ..obs import REGISTRY as _obs
from ..obs import flightrec as _frec
from ..obs import perfmodel as _perf
from ..obs import prof as _prof
from ..obs import steps as _steps
from ..obs import trace as _trace
from ..utils import logging as hvd_logging

log = hvd_logging.get_logger()

_m_collectives = _obs.counter(
    "hvd_collectives_total", "collectives dispatched by the engine",
    ("verb",))
_m_bytes = _obs.counter(
    "hvd_collective_bytes_total",
    "payload bytes through engine-dispatched collectives", ("verb",))
_m_errors = _obs.counter(
    "hvd_collective_errors_total",
    "collectives that completed with an error", ("verb",))
_m_fusion_batch = _obs.histogram(
    "hvd_fusion_batch_tensors", "tensors per fused allreduce dispatch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
_m_dispatches = _obs.counter(
    "hvd_engine_dispatches_total",
    "collective groups the engine issued to torch.distributed",
    ("backend",))
_m_cycles = _obs.counter(
    "hvd_engine_cycles_total",
    "engine cycles that negotiated at least one tensor")
_m_cycle = _obs.histogram(
    "hvd_cycle_seconds",
    "engine cycle wall time (drain -> negotiate -> fuse -> dispatch)")
_m_queue_depth = _obs.gauge(
    "hvd_engine_queue_depth",
    "entries left pending in the tensor queue after a cycle")

_VERBS = ("allreduce", "allgather", "broadcast", "alltoall", "reducescatter")
_m_coll_v = {v: _m_collectives.labels(verb=v) for v in _VERBS}
_m_bytes_v = {v: _m_bytes.labels(verb=v) for v in _VERBS}
_m_errors_v = {v: _m_errors.labels(verb=v) for v in _VERBS}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the dtype field of a
    negotiation meta, which a joined rank turns back with
    ``getattr(torch, name)``."""
    return str(dtype).rpartition(".")[2]


@dataclass
class TensorTableEntry:
    """† ``horovod/common/common.h TensorTableEntry`` (name, tensor,
    output, callback).  ``payload`` is this rank's tensor, detached;
    ``output`` is the tensor the result is written into (``payload``
    itself for the in-place verbs), or None for a result the engine
    allocates.  ``ready`` is the CUDA event recorded on the enqueueing
    stream after the payload was produced (None on the CPU)."""
    name: str
    verb: str                      # allreduce | allgather | broadcast | alltoall | reducescatter
    payload: Any
    output: Any = None
    op: C.ReduceOp = C.ReduceOp.AVERAGE
    root_rank: int = 0
    splits: Optional[Sequence[int]] = None
    prescale: float = 1.0
    postscale: float = 1.0
    process_set: Any = None
    # Wire mode ("" or "fp32" = full precision) and schedule descriptor
    # ("" = monolithic), resolved at enqueue (reduction.resolve_precision,
    # sched.resolve_schedule).
    precision: str = ""
    schedule: str = ""
    # The engine leaves its loop after the round that makes this ready.
    last: bool = False
    enqueue_time: float = field(default_factory=time.monotonic)
    ready: Any = field(default=None, compare=False)
    # Timeline phase currently open for this entry ("" | QUEUE | NEGOTIATE).
    tl_phase: str = field(default="", compare=False)
    # Timeline-v2 flow id linking the QUEUE span to the DISPATCH span.
    tl_flow: int = field(default=0, compare=False)
    # The enqueueing rank's group cap when it last negotiated the entry.
    cap: int = field(default=0, compare=False)

    def meta(self) -> str:
        """Serialized descriptor carried through negotiation so a joined
        rank can construct zero-payload participation († the Response's
        tensor metadata behind ``RequestType::JOIN``), plus the group cap
        (``fc``) every rank fuses the cycle by.  Only the cap for
        process-set entries, which a joined rank cannot rebuild."""
        if self.process_set is not None:
            return json.dumps({"fc": self.cap})
        m: dict = {"v": self.verb, "d": dtype_name(self.payload.dtype),
                   "s": list(self.payload.shape), "o": self.op.value}
        if self.root_rank:
            m["r"] = self.root_rank
        if self.splits is not None:
            m["sp"] = [int(s) for s in self.splits]
        if self.prescale != 1.0:
            m["ps"] = self.prescale
        if self.postscale != 1.0:
            m["po"] = self.postscale
        if self.precision and self.precision != "fp32":
            # A joined rank must build its zeros at the same wire mode.
            m["wp"] = self.precision
        if self.schedule:
            # ... and walk the same schedule, chunk count included.
            m["sc"] = self.schedule
        m["fc"] = self.cap
        return json.dumps(m, separators=(",", ":"))


def _joinable_entry(e: TensorTableEntry) -> bool:
    """Can a joined rank stand in for this entry with zeros?  Allreduce
    outside a process set only († reference join semantics); must agree
    with :func:`_parse_joinable_meta`, the joined ranks' half."""
    return e.verb == "allreduce" and e.process_set is None


def _parse_joinable_meta(meta: str) -> Optional[dict]:
    """Parse an echoed descriptor; None unless it fully describes a
    joinable (allreduce) entry, so :meth:`CollectiveEngine._zero_entry`
    is total on accepted metas."""
    if not meta:
        return None
    try:
        m = json.loads(meta)
        if m.get("v") != "allreduce":
            return None
        m["s"] = [int(d) for d in m["s"]]
        C.ReduceOp(m["o"])
        if not isinstance(getattr(torch, m["d"], None), torch.dtype):
            return None
        if m.get("wp", "") not in ("",) + R.MODES:
            return None     # a wire mode this build cannot run: skip
        if m.get("sc", "") and not known_descriptor(m["sc"]):
            return None     # a schedule this build cannot walk: skip
    except (ValueError, TypeError, KeyError):
        return None
    return m


def _agreed_cap(ready: list[TensorTableEntry], metas: dict,
                local: int) -> int:
    """The group cap of a cycle: the least ``fc`` among the ready
    entries' echoed metas.  The coordinator echoes one meta a name to
    every rank, so every rank fuses the cycle into the same groups even
    when their own caps differ (the autotuner commits them rank by
    rank).  ``local`` when no meta carries one (one rank)."""
    caps = []
    for e in ready:
        try:
            caps.append(int(json.loads(metas[e.name])["fc"]))
        except (KeyError, ValueError, TypeError):
            pass
    return min(caps) if caps else local


def _reconcile_metas(ready: list[TensorTableEntry], by_name: dict,
                     metas: dict) -> None:
    """Adopt the coordinator's echoed schedule and wire mode for ready
    entries of this rank whose own resolution differs († reference
    ``_reconcile_metas``).  Both are normally resolved alike on every
    rank; when they are not (skewed configs), every rank must still run
    the same collectives, and the coordinator echoes one meta a name to
    all of them, so each adopts the echoed values before fusing.  An
    unparseable meta keeps the local values (that peer skips the entry
    by :func:`_parse_joinable_meta`'s rule)."""
    for e in ready:
        if (e.verb != "allreduce" or e.process_set is not None
                or by_name.get(e.name) is not e):
            continue
        m = _parse_joinable_meta(metas.get(e.name, ""))
        if m is None:
            continue
        sc, wp = m.get("sc", ""), m.get("wp", "")
        if sc != e.schedule or wp != (
                e.precision if e.precision != "fp32" else ""):
            log.info(
                "adopting negotiated meta for %r: schedule %r -> %r, wire "
                "%r -> %r (peer resolutions differed)", e.name,
                e.schedule or "monolithic", sc or "monolithic",
                e.precision or "fp32", wp or "fp32")
            e.schedule, e.precision = sc, wp


class Handle:
    """Async completion handle († ``handle_manager.cc``: handle +
    ``synchronize``).  The host side completes when the engine has issued
    the collective; on the card ``_done`` is the event that marks the end
    of its device work."""

    __slots__ = ("_event", "_result", "_error", "_done", "_device", "_owned",
                 "name")

    def __init__(self, name: str) -> None:
        self.name = name
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._done = None
        self._device = None
        self._owned = False

    def _complete(self, result: Any = None,
                  error: Optional[BaseException] = None, done=None,
                  device=None, owned: bool = False) -> None:
        self._result = result
        self._error = error
        self._done = done
        self._device = device
        self._owned = owned
        self._event.set()

    def poll(self) -> bool:
        """Non-blocking completion check († ``hvd.poll``): issued, and on
        the card also finished there."""
        if not self._event.is_set():
            return False
        return self._done is None or self._done.query()

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Block until the collective is issued and return its output
        († ``hvd.synchronize``).  On the card the caller's current stream
        then waits on the collective's completion event; the host does
        not wait for the device."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"collective {self.name!r} still pending")
        if self._error is not None:
            raise HorovodInternalError(
                f"collective {self.name!r} failed: {self._error}"
            ) from self._error
        if self._done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._done)
            if self._owned:
                # Allocated on the engine's stream, used from here on.
                self._result.record_stream(stream)
        return self._result


@dataclass
class NegotiationOutcome:
    """One round's agreed result († ``Response`` list); the fields are the
    JAX engine's (ready order, stalled names, echoed metas, join state,
    join-covered names, stall attribution)."""
    ready: list[str]
    stalled: list[str] = field(default_factory=list)
    metas: dict = field(default_factory=dict)
    all_joined: bool = False
    last_join_rank: int = 0
    join_covered: set = field(default_factory=set)
    stall_info: dict = field(default_factory=dict)


class Negotiator:
    """Readiness protocol interface († ``Controller::ComputeResponseList``)."""

    # Distributed protocols are round barriers: every process checks in
    # every cycle, even with an empty queue.
    always_check_in = False

    def negotiate(self, entries: list[TensorTableEntry], *,
                  joined: bool = False) -> NegotiationOutcome:
        """Return the agreed ready set (ordered) for this cycle."""
        raise NotImplementedError

    def stall_attribution(self, name: str) -> Optional[str]:
        """Straggler attribution for a stalled tensor, when this protocol
        can know it; None otherwise."""
        return None

    def close(self) -> None:
        pass


class SingleControllerNegotiator(Negotiator):
    """One rank: everything is ready immediately."""

    def negotiate(self, entries: list[TensorTableEntry], *,
                  joined: bool = False) -> NegotiationOutcome:
        if entries:
            chaos.fire("negotiate")
        return NegotiationOutcome(ready=[e.name for e in entries])


class CollectiveEngine:
    """Background cycle thread owning the tensor queue; the only thread
    that issues collectives."""

    def __init__(self, state, negotiator: Optional[Negotiator] = None) -> None:
        self._state = state
        self._negotiator = negotiator or SingleControllerNegotiator()
        self._device = state.device
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._queue: list[tuple[TensorTableEntry, Handle]] = []
        self._names_pending: set[str] = set()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._urgent = False
        self._paused = False
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._cycle_count = 0
        self._last_cycle_ts = time.monotonic()
        self._last_stall_warn = 0.0
        self._join_requested = False
        self._join_result = -1
        self._join_event = threading.Event()
        # Set when a join finishes with no caller waiting; consumed by the
        # next join() call.
        self._join_pending_consume = False
        self._autotuner = None
        # Groups timed on the engine's stream, waiting for their work to
        # finish: (start event, end event, verb, payload bytes, itemsize,
        # ranks, wire mode).
        self._timed: list[tuple] = []

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name=_prof.ENGINE_THREAD, daemon=True)
        self._thread.start()
        if self._state.config.autotune:
            from ..utils.autotune import Autotuner
            self._autotuner = Autotuner(self._state)

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the cycle thread.  Across processes every rank first
        submits one tiny allreduce, ``hvd.shutdown``, and each engine
        leaves its loop right after the round that makes it ready
        († upstream's negotiated shutdown request): all ranks leave at
        the same round, so none is left blocked in a round its peers never
        join.  A peer that never shuts down (or is gone) costs
        ``timeout`` seconds, then the thread is abandoned."""
        if self.distributed and self.alive:
            zeros = torch.zeros(1, dtype=torch.int32, device=self._device)
            entry = TensorTableEntry(name="hvd.shutdown", verb="allreduce",
                                     payload=zeros, output=zeros,
                                     op=C.ReduceOp.SUM, last=True)
            self.enqueue(entry)
            self.nudge()
            if self._thread is not None:
                self._thread.join(timeout)
        with self._wake:
            self._running = False
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # Still blocked in a negotiation round whose peers have
                # stopped: closing the client under it would free what it
                # is using, so leave both to the process's exit.
                log.warning("engine thread still in a negotiation round "
                            "at shutdown; leaving it to exit with the "
                            "process")
                self._negotiator = SingleControllerNegotiator()
            self._thread = None
        self._negotiator.close()
        # Fail any stragglers so synchronize() callers don't hang.
        with self._lock:
            for entry, handle in self._queue:
                self._tl_close(entry)
                handle._complete(error=RuntimeError("engine shut down"))
            self._queue.clear()
            self._names_pending.clear()

    def _tl_close(self, e: TensorTableEntry) -> None:
        """End any open timeline span for an entry leaving on an error
        path, keeping Chrome-trace B/E events balanced."""
        if e.tl_phase:
            tl = self._state.timeline
            if tl is not None and tl.enabled:
                tl.end_activity(e.name)
            e.tl_phase = ""

    def nudge(self) -> None:
        """Request an immediate cycle (``synchronize`` does, so a blocking
        caller doesn't wait out the cycle time)."""
        with self._wake:
            self._urgent = True
            self._wake.notify_all()

    def pause(self) -> None:
        """Hold queue processing (deterministic tests)."""
        with self._wake:
            self._paused = True

    def resume(self) -> None:
        with self._wake:
            self._paused = False
            self._urgent = True
            self._wake.notify_all()

    # -- enqueue († EnqueueTensorAllreduce et al.) --------------------------
    def enqueue(self, entry: TensorTableEntry) -> Handle:
        return self.enqueue_many([entry])[0]

    def enqueue_many(self, entries: list[TensorTableEntry]) -> list[Handle]:
        """Enqueue several entries under one hold of the queue's lock, so
        they meet one cycle together on every rank (a grouped allreduce
        fuses into one buffer, as the reference's one program does)."""
        handles = [Handle(e.name) for e in entries]
        if self._stream is not None:
            # Marks the end of the work that produced the payloads, on the
            # stream that produced them; the engine's stream waits on it.
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._device))
            for entry in entries:
                entry.ready = ready
        with self._wake:
            for entry, handle in zip(entries, handles):
                self._enqueue_locked(entry, handle)
        return handles

    def _enqueue_locked(self, entry: TensorTableEntry,
                        handle: Handle) -> None:
        if not self._running:
            handle._complete(error=RuntimeError("engine not running"))
            return
        if entry.name in self._names_pending:
            # † TensorQueue rejects duplicate in-flight names.
            handle._complete(error=ValueError(
                f"a collective named {entry.name!r} is already pending"))
            return
        self._names_pending.add(entry.name)
        self._queue.append((entry, handle))
        sp = _trace.current_span()
        if sp is not None:
            sp.event("collective.enqueue", tensor=entry.name,
                     verb=entry.verb)
        tl = self._state.timeline
        if tl is not None and tl.enabled:
            tl.start_activity(entry.name, "QUEUE")
            entry.tl_phase = "QUEUE"
            entry.tl_flow = tl.new_flow()
            tl.flow_start(entry.name, entry.tl_flow)

    # -- background loop († RunLoopOnce) ------------------------------------
    def _loop(self) -> None:
        if self._stream is not None:
            torch.cuda.set_device(self._device)
        while True:
            with self._wake:
                if not self._running:
                    return
                if not self._urgent:
                    self._wake.wait(
                        timeout=self._state.config.cycle_time_ms / 1000.0)
                if not self._running:
                    return
                self._urgent = False
                if self._paused:
                    continue
                batch = self._queue
                self._queue = []
            try:
                self._run_cycle(batch)
            except Exception:  # pragma: no cover - defensive
                log.exception("engine cycle crashed")
            try:
                self._check_stalls()
            except HorovodInternalError as err:
                # Stall shutdown: fail every pending handle so all callers
                # raise († error Response to all ranks), then stop.
                with self._lock:
                    pending = self._queue
                    self._queue = []
                    self._names_pending.clear()
                    self._running = False
                for entry, handle in pending:
                    self._tl_close(entry)
                    handle._complete(error=err)
                log.error("engine stopped by stall shutdown: %s", err)
                _frec.RECORDER.record("stall_shutdown", error=str(err))
                _frec.RECORDER.maybe_dump(
                    "stall_shutdown",
                    stall=getattr(self._negotiator,
                                  "last_stall_info", None),
                    extra={"error": str(err),
                           "pending": [e.name for e, _ in pending]})
                return

    @property
    def distributed(self) -> bool:
        return self._negotiator.always_check_in

    @property
    def alive(self) -> bool:
        """Cycle thread running — the readiness half of ``/healthz``."""
        return bool(self._running and self._thread is not None
                    and self._thread.is_alive())

    @property
    def last_negotiation_age_s(self) -> float:
        """Seconds since the last completed negotiation (multi-process)
        or engine cycle (one rank)."""
        ts = getattr(self._negotiator, "last_negotiate_ts", None)
        return time.monotonic() - (ts if ts is not None
                                   else self._last_cycle_ts)

    def _run_cycle(self, batch: list[tuple[TensorTableEntry, Handle]]) -> None:
        self._cycle_count += 1
        self._last_cycle_ts = time.monotonic()
        tl = self._state.timeline
        if tl is not None:
            tl.mark_cycle()
        if not batch and not self._negotiator.always_check_in:
            return
        t0 = time.monotonic()
        entries = [e for e, _ in batch]
        # Under an open training step, the cycle's spans (obs/steps.py),
        # made at its end from these clock reads.
        step = _steps.CURRENT if entries else None
        handles = {id(e): h for e, h in batch}
        if entries:
            _m_cycles.inc()
        if tl is not None and tl.enabled:
            for e in entries:
                if e.tl_phase == "QUEUE":
                    tl.end_activity(e.name)
                    tl.start_activity(e.name, "NEGOTIATE")
                    e.tl_phase = "NEGOTIATE"
        join_req = self._join_requested
        cap = self._group_cap()
        for e in entries:
            e.cap = cap
        t_neg = time.monotonic() if step is not None else 0.0
        try:
            outcome = self._negotiator.negotiate(entries, joined=join_req)
        except Exception as err:
            if step is not None:
                step.cycle(t0, (t_neg, time.monotonic()), None,
                           error=repr(err))
            # Negotiation transport failure (controller died, TCP error):
            # fail every handle in the batch so waiters raise instead of
            # hanging († error Response to all ranks).
            for e, h in batch:
                with self._lock:
                    self._names_pending.discard(e.name)
                self._tl_close(e)
                e_err = err
                attr = self._negotiator.stall_attribution(e.name)
                if attr is not None:
                    try:
                        e_err = type(err)(
                            f"{err} [stalled tensor {e.name!r}: {attr}]")
                    except Exception:   # exotic ctor: keep the original
                        e_err = err
                h._complete(error=e_err)
            if join_req:
                with self._lock:
                    self._join_requested = False
                    self._join_result = -1
                    self._join_pending_consume = True
                self._join_event.set()
            log.error("negotiation failed; %d collectives errored: %s",
                      len(batch), err)
            _frec.RECORDER.record("round_abort", error=str(err))
            _frec.RECORDER.maybe_dump(
                "round_abort",
                stall=getattr(self._negotiator, "last_stall_info", None),
                extra={"error": str(err),
                       "entries": [e.name for e, _ in batch]})
            return
        neg = (t_neg, time.monotonic()) if step is not None else None
        by_name = {e.name: e for e in entries}
        ready: list[TensorTableEntry] = []
        errored: set[int] = set()
        for name in outcome.ready:
            e = by_name.get(name)
            if e is not None:
                if name in outcome.join_covered and not _joinable_entry(e):
                    # † Join supports allreduce only: zeros in an
                    # allgather/broadcast/alltoall would corrupt the
                    # result, so every rank errors the entry; the joined
                    # rank skips it by the same rule.
                    errored.add(id(e))
                    with self._lock:
                        self._names_pending.discard(e.name)
                    self._tl_close(e)
                    handles[id(e)]._complete(error=HorovodInternalError(
                        f"collective {name!r} ({e.verb}"
                        + (", process-set" if e.process_set is not None
                           else "")
                        + ") became ready through a joined rank, but only "
                        "allreduce supports join zero-participation "
                        "(† reference join semantics)"))
                    continue
                ready.append(e)
            elif join_req:
                # Another rank's tensor became ready because we joined:
                # participate with zeros († JoinOp) when the verb allows.
                meta = _parse_joinable_meta(outcome.metas.get(name, ""))
                if meta is None:
                    log.warning(
                        "join: skipping non-joinable ready tensor %r "
                        "(it errors on the ranks that submitted it)", name)
                    continue
                try:
                    e = self._zero_entry(name, meta)
                except Exception as err:  # never kill the cycle
                    log.error(
                        "join: failed to build zero participation for %r "
                        "(%s); skipping — peers may stall (stall inspector "
                        "will report)", name, err)
                    continue
                handles[id(e)] = Handle(e.name)  # result dropped
                ready.append(e)
        # Errored entries are consumed too: re-queueing them would
        # renegotiate a dead tensor every cycle.
        consumed_ids = {id(e) for e in ready} | errored
        deferred = [(e, h) for e, h in batch if id(e) not in consumed_ids]
        if deferred:
            with self._lock:
                self._queue = deferred + self._queue
        _reconcile_metas(ready, by_name, outcome.metas)
        t_disp = time.monotonic() if step is not None else 0.0
        groups = self._fuse(ready, _agreed_cap(ready, outcome.metas, cap))
        for group in groups:
            self._execute_group(group, handles)
        disp = (t_disp, time.monotonic()) if step is not None else None
        if any(e.last for e in ready):
            with self._lock:
                self._running = False
        _m_cycle.observe(time.monotonic() - t0)
        with self._lock:
            depth = len(self._queue)
        _m_queue_depth.set(depth)
        if tl is not None and tl.enabled:
            tl.counter("hvd.engine", {
                "queue_depth": depth,
                "collectives_total": _m_collectives.total(),
                "collective_bytes_total": _m_bytes.total(),
            })
        if join_req and outcome.all_joined:
            with self._lock:
                self._join_requested = False
                self._join_result = outcome.last_join_rank
                self._join_pending_consume = True
            self._join_event.set()
        if self._timed:
            self._observe_timed()
        if self._autotuner is not None:
            payload = sum(self._entry_bytes(e) for e in ready)
            self._autotuner.record_cycle(payload, time.monotonic() - t0)
        if step is not None:
            step.cycle(t0, neg, disp, tensors=len(ready), groups=len(groups),
                       bytes=sum(self._entry_bytes(e) for e in ready))

    # -- join († RequestType::JOIN, hvd.join()) ------------------------------
    def join(self, timeout: Optional[float] = None) -> int:
        """Signal this rank has no more input; participate as zeros in
        other ranks' allreduces until every rank joins.  Returns the last
        rank to join († ``horovod/torch/__init__.py join()``)."""
        if not self.distributed:
            raise RuntimeError(
                "engine.join() requires more than one rank; one rank "
                "joins by a barrier")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if self._join_pending_consume:
                return self._consume_join_locked()
            resuming = self._join_requested
        if not resuming:
            # Drain our own pending collectives first: JOIN is ordered
            # after every prior submission, as in the reference.
            while True:
                with self._lock:
                    if not self._queue and not self._names_pending:
                        break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        "join(): pending collectives never drained")
                self.nudge()
                time.sleep(0.005)
            self._join_event.clear()
            with self._wake:
                self._join_requested = True
                self._urgent = True
                self._wake.notify_all()
        remaining = None if deadline is None else \
            max(0.0, deadline - time.monotonic())
        if not self._join_event.wait(remaining):
            # The JOIN flag already sent is irrevocable: stay joined; a
            # later join() resumes this phase.
            raise TimeoutError(
                "join(): not all ranks joined in time (this rank remains "
                "joined; call join() again to keep waiting)")
        with self._lock:
            return self._consume_join_locked()

    def _consume_join_locked(self) -> int:
        self._join_pending_consume = False
        result = self._join_result
        self._join_result = -1
        self._join_event.clear()
        if result < 0:
            raise HorovodInternalError("join(): failed mid-join (see log)")
        return result

    def _zero_entry(self, name: str, m: dict) -> TensorTableEntry:
        """The zero payload a joined rank contributes († JoinOp: zeros of
        the same shape and dtype; ``AVERAGE`` still divides by the whole
        world)."""
        zeros = torch.zeros(m["s"], dtype=getattr(torch, m["d"]),
                            device=self._device)
        e = TensorTableEntry(
            name=name, verb=m["v"], payload=zeros, output=zeros,
            op=C.ReduceOp(m["o"]), root_rank=m.get("r", 0),
            splits=m.get("sp"), prescale=m.get("ps", 1.0),
            postscale=m.get("po", 1.0), precision=m.get("wp", ""),
            schedule=m.get("sc", ""))
        if self._stream is not None:
            e.ready = torch.cuda.Event()
            e.ready.record(torch.cuda.current_stream(self._device))
        return e

    @staticmethod
    def _entry_bytes(e: TensorTableEntry) -> int:
        return e.payload.numel() * e.payload.element_size()

    def _group_cap(self) -> int:
        """This rank's group cap: the fusion threshold, capped by the
        bucket cap (``config.bucket_bytes``, which only the autotuner
        commits in the port) when one is set († the JAX engine's
        ``_fuse``)."""
        cfg = self._state.config
        if cfg.bucket_bytes > 0:
            return min(cfg.fusion_threshold, cfg.bucket_bytes)
        return cfg.fusion_threshold

    def _fuse(self, entries: list[TensorTableEntry],
              threshold: Optional[int] = None
              ) -> list[list[TensorTableEntry]]:
        """Group fusable entries; split at ``threshold`` bytes (this
        rank's :meth:`_group_cap` by default).

        † fusion_buffer_manager.cc: same dtype+op tensors share a fused
        dispatch up to ``fusion_threshold`` bytes.  Only allreduce fuses
        (other verbs execute per tensor)."""
        if threshold is None:
            threshold = self._group_cap()
        groups: dict[tuple, list[TensorTableEntry]] = {}
        order: list[tuple] = []
        singles: list[list[TensorTableEntry]] = []
        for e in entries:
            if e.verb == "allreduce" and e.op is not C.ReduceOp.ADASUM:
                # One wire mode and one schedule a fused buffer ("" is
                # fp32 / monolithic).
                key = ("allreduce", e.op, e.payload.dtype,
                       id(e.process_set), e.prescale, e.postscale,
                       e.precision or "fp32", e.schedule)
                if key not in groups:
                    groups[key] = []
                    order.append(key)
                groups[key].append(e)
            else:
                singles.append([e])
        fused: list[list[TensorTableEntry]] = []
        for key in order:
            current: list[TensorTableEntry] = []
            current_bytes = 0
            for e in groups[key]:
                nbytes = self._entry_bytes(e)
                if current and current_bytes + nbytes > threshold:
                    fused.append(current)
                    current, current_bytes = [], 0
                current.append(e)
                current_bytes += nbytes
            if current:
                fused.append(current)
        return fused + singles

    def _execute_group(self, group: list[TensorTableEntry],
                       handles: dict[int, Handle]) -> None:
        tl = self._state.timeline
        try:
            if tl is not None and tl.enabled:
                for e in group:
                    if e.tl_phase == "NEGOTIATE":
                        tl.end_activity(e.name)
                    tl.start_activity(e.name, "DISPATCH")
                    e.tl_phase = "DISPATCH"
                    if e.tl_flow:
                        tl.flow_end(e.name, e.tl_flow)
                        e.tl_flow = 0
            label = (group[0].name if len(group) == 1
                     else f"hvd.fused[{len(group)}].{group[0].name}")
            chaos.fire("dispatch")
            done = start = None
            # The model ignores one rank (no wire): time nothing there.
            timed = self._state.size > 1
            t_disp = time.monotonic()
            # The group's range on a profile's host rows, only while a
            # profiler records (entering one costs a few microseconds).
            rf = (torch.profiler.record_function(
                f"hvd.{group[0].verb}:{label}") if _steps.profiling()
                else contextlib.nullcontext())
            with rf:
                if self._stream is None:
                    results = self._dispatch(group)
                else:
                    with torch.cuda.stream(self._stream):
                        for e in group:
                            self._stream.wait_event(e.ready)
                            e.payload.record_stream(self._stream)
                        if timed:       # the group's own work, once ready
                            start = torch.cuda.Event(enable_timing=True)
                            start.record(self._stream)
                        results = self._dispatch(group)
                        done = torch.cuda.Event(enable_timing=timed)
                        done.record(self._stream)
            t_disp = time.monotonic() - t_disp
            _m_dispatches.labels(backend=self._state.backend).inc()
            if tl is not None and tl.enabled:
                for e in group:
                    tl.end_activity(e.name)
                    e.tl_phase = ""
            if group[0].verb == "allreduce":
                _m_fusion_batch.observe(len(group))
            # A decomposed group feeds the model from the executor.
            if timed and not group[0].schedule:
                nbytes = sum(self._entry_bytes(e) for e in group)
                itemsize = group[0].payload.element_size()
                mode = group[0].precision or "fp32"
                if start is None:
                    _perf.MODEL.observe(group[0].verb, nbytes,
                                        self._state.size, t_disp,
                                        itemsize=itemsize, mode=mode)
                else:
                    self._timed.append((start, done, group[0].verb,
                                        nbytes, itemsize, self._state.size,
                                        mode))
            _frec.RECORDER.record(
                "dispatch", name=label, verb=group[0].verb,
                tensors=len(group),
                bytes=sum(self._entry_bytes(e) for e in group))
            for e, r in zip(group, results):
                _m_coll_v[e.verb].inc()
                _m_bytes_v[e.verb].inc(self._entry_bytes(e))
                with self._lock:
                    self._names_pending.discard(e.name)
                # A result the engine allocated is "owned": the caller's
                # stream takes it over in Handle.wait.
                handles[id(e)]._complete(result=r, done=done,
                                         device=self._device,
                                         owned=e.output is None)
        except Exception as err:
            # † error Response delivered to every participating rank so
            # all raise rather than some hanging.
            _frec.RECORDER.record(
                "collective_error", name=group[0].name,
                verb=group[0].verb, error=repr(err))
            for e in group:
                (_m_errors_v.get(e.verb)
                 or _m_errors.labels(verb=e.verb)).inc()
                with self._lock:
                    self._names_pending.discard(e.name)
                self._tl_close(e)
                handles[id(e)]._complete(error=err)

    def _observe_timed(self) -> None:
        """Feed the performance model the groups whose work on the
        engine's stream has finished, in dispatch order; a group still
        running stops the walk (``query`` never blocks)."""
        n = 0
        for start, done, verb, nbytes, itemsize, ranks, mode in self._timed:
            if not done.query():
                break
            _perf.MODEL.observe(verb, nbytes, ranks,
                                start.elapsed_time(done) / 1000.0,
                                itemsize=itemsize, mode=mode)
            n += 1
        del self._timed[:n]

    def _group_of(self, e: TensorTableEntry) -> tuple[Any, int, int]:
        """(torch.distributed group, its size, this rank's index in it)."""
        ps, state = e.process_set, self._state
        if ps is None:
            return None, state.size, state.rank
        return ps.group, ps.size(), ps.rank_of(state.rank)

    def _dispatch(self, group: list[TensorTableEntry]) -> list:
        """Launch one group's collective (on the card, on the engine's
        stream, which already waits for the group's payloads); returns
        one result per entry: its ``output``, or a tensor the engine
        allocated when that is None."""
        e0 = group[0]
        pg, n, me = self._group_of(e0)
        if e0.verb == "allreduce":
            return self._allreduce(group, pg, n)
        assert len(group) == 1
        if e0.verb == "allgather":
            return [C.allgather(e0.payload, pg, n)]
        if e0.verb == "broadcast":
            root = (e0.process_set.ranks[e0.root_rank]
                    if e0.process_set is not None else e0.root_rank)
            return self._in_place(
                e0, lambda buf: C.broadcast_(buf, root, pg))
        if e0.verb == "alltoall":
            return [C.alltoall(e0.payload, e0.splits, pg, n, me)]
        if e0.verb == "reducescatter":
            return [C.reducescatter(e0.payload, e0.op, pg, n)]
        raise ValueError(f"unknown verb {e0.verb!r}")

    @staticmethod
    def _in_place(e: TensorTableEntry, fn) -> list:
        """Run ``fn(buf)`` on a contiguous buffer holding the payload:
        the caller's tensor itself for an in-place verb on a contiguous
        tensor (no copy), else a copy, written back for in-place verbs."""
        if e.output is not None and e.output.is_contiguous():
            fn(e.output)
            return [e.output]
        buf = e.payload.clone(memory_format=torch.contiguous_format)
        fn(buf)
        if e.output is None:
            return [buf]
        e.output.copy_(buf)
        return [e.output]

    @staticmethod
    def _take(results: list, group: list[TensorTableEntry]) -> list:
        """Results the reduction allocated, written into the in-place
        entries' outputs."""
        outs = []
        for r, e in zip(results, group):
            if e.output is None:
                outs.append(r)
            else:
                e.output.copy_(r)
                outs.append(e.output)
        return outs

    def _allreduce(self, group: list[TensorTableEntry], pg,
                   n: int) -> list:
        e0 = group[0]
        mode = e0.precision or "fp32"
        block = self._state.config.quant_block_size
        if e0.schedule:
            from .sched.executor import execute_allreduce
            label = (e0.name if len(group) == 1
                     else f"hvd.fused[{len(group)}].{e0.name}")
            return self._take(execute_allreduce(
                [e.payload for e in group], e0.op, descriptor=e0.schedule,
                group=pg, n=n, precision=mode, prescale=e0.prescale,
                postscale=e0.postscale, block=block, name=label,
                timeline=self._state.timeline), group)
        if mode != "fp32":
            nbytes = sum(self._entry_bytes(e) for e in group)
            itemsize = e0.payload.element_size()
            R.account_wire(mode, nbytes, n, block, itemsize=itemsize)
            flat = (e0.payload.reshape(-1) if len(group) == 1 else
                    torch.cat([e.payload.reshape(-1) for e in group]))
            out = R.allreduce(flat, e0.op, mode, pg, n, block=block,
                              prescale=e0.prescale, postscale=e0.postscale)
            return self._take(
                [p.view(e.payload.shape) for p, e in zip(
                    out.split([e.payload.numel() for e in group]), group)],
                group)
        kw = dict(prescale=e0.prescale, postscale=e0.postscale)
        split = C.hier_route(e0.op, e0.payload.dtype, e0.process_set)
        if split is not None:
            # The two tiers (reference _build_hier_allreduce), fused or
            # not: pack, reduce, unpack.
            from .hierarchical import hierarchical_allreduce_
            if len(group) == 1:
                return self._in_place(e0, lambda buf: hierarchical_allreduce_(
                    buf, e0.op, *split, **kw))
            flat = torch.cat([e.payload.reshape(-1) for e in group])
            hierarchical_allreduce_(flat, e0.op, *split, **kw)
            return self._take(
                [p.view(e.payload.shape) for p, e in zip(
                    flat.split([e.payload.numel() for e in group]), group)],
                group)
        if len(group) == 1:
            return self._in_place(
                e0, lambda buf: C.allreduce_(buf, e0.op, pg, n, **kw))
        # The fusion buffer: pack, one collective, unpack with the
        # AVERAGE's division and the postscale folded into the copy out.
        flat = torch.cat([e.payload.reshape(-1) for e in group])
        C.allreduce_(flat, e0.op, pg, n, divide=False, **kw)
        outs = []
        offset = 0
        for e in group:
            k = e.payload.numel()
            piece = flat[offset:offset + k].view(e.payload.shape)
            offset += k
            out = e.output if e.output is not None else torch.empty_like(
                piece)
            if e0.op is C.ReduceOp.AVERAGE:
                C.average_(out, piece, n)
            else:
                out.copy_(piece)
            C._scale_(out, e0.postscale)
            outs.append(out)
        return outs

    # -- stall inspector († stall_inspector.cc) ----------------------------
    def _check_stalls(self) -> None:
        cfg = self._state.config
        if not cfg.stall_check:
            return
        now = time.monotonic()
        if now - self._last_stall_warn < cfg.stall_warning_time_s:
            return
        with self._lock:
            stalled = [(e.name, now - e.enqueue_time)
                       for e, _ in self._queue
                       if now - e.enqueue_time > cfg.stall_warning_time_s]
        if not stalled:
            return
        self._last_stall_warn = now

        def _desc(n: str, age: float) -> str:
            attr = self._negotiator.stall_attribution(n)
            return (f"{n} ({age:.0f}s; {attr})" if attr
                    else f"{n} ({age:.0f}s)")
        desc = ", ".join(_desc(n, age) for n, age in stalled)
        _frec.RECORDER.record("stall_warning", desc=desc)
        log.warning(
            "Stall detected: collectives pending > %.0fs without "
            "completing negotiation: %s. One or more ranks may have "
            "diverged (e.g. rank-dependent conditionals).",
            cfg.stall_warning_time_s, desc)
        if cfg.stall_shutdown_time_s > 0:
            worst = max(age for _, age in stalled)
            if worst > cfg.stall_shutdown_time_s:
                raise HorovodInternalError(
                    f"stalled collectives exceeded shutdown time "
                    f"({cfg.stall_shutdown_time_s}s): {desc}")

    # -- stats --------------------------------------------------------------
    @property
    def cycle_count(self) -> int:
        """Cycles run, idle ones included."""
        return self._cycle_count
