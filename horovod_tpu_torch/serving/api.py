"""The serving front door: ``serve()`` → submit futures, stream tokens.

Wraps :class:`~horovod_tpu_torch.serving.engine.ServingEngine` with the
request-facing surface a client sees:

- ``submit(prompt, max_tokens) -> concurrent.futures.Future`` resolving
  to a :class:`RequestResult` (tokens + per-request metrics);
- optional per-token streaming callbacks, invoked in emission order;
- per-request metrics — TTFT, queue wait, decode tok/s — routed into the
  process metrics registry (:mod:`horovod_tpu_torch.obs`: TTFT/ITL
  histograms, request/token counters), logged through
  :mod:`horovod_tpu_torch.utils.logging` and traced as QUEUE (submit →
  first token, prefill included) → DECODE spans on
  :class:`horovod_tpu_torch.utils.timeline.Timeline` (one timeline row per
  request, the reference's per-tensor layout).

The loop can be driven synchronously (:meth:`ServingSession.drain` — the
deterministic mode tests and benchmarks use) or by a background thread
(:meth:`ServingSession.start`), with submissions safe from any thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ..context import HorovodInternalError
from ..obs import REGISTRY as _obs
from ..obs import flightrec as _frec
from ..utils import logging as hvd_logging
from ..utils.timeline import Timeline
from .engine import EngineConfig, ServingEngine
from .scheduler import Request

log = hvd_logging.get_logger()

# Request-level latency series (horovod_tpu_torch.obs).  TTFT and ITL are the
# two serving SLO primitives; queue-wait isolates the admission share of
# TTFT so "slow prefill" and "full pool" are distinguishable in one scrape.
_m_ttft = _obs.histogram(
    "hvd_serving_ttft_seconds",
    "submit -> first emitted token (queue wait + prefill)")
_m_itl = _obs.histogram(
    "hvd_serving_itl_seconds",
    "inter-token latency between consecutive emissions of one request")
_m_queue_wait = _obs.histogram(
    "hvd_serving_queue_wait_seconds", "submit -> admission")
_m_decode_rate = _obs.gauge(
    "hvd_serving_decode_tokens_per_s",
    "steady-state decode rate of the most recently finished request")
_m_requests = _obs.counter(
    "hvd_serving_requests_total", "requests by terminal outcome",
    ("outcome",))
_m_tokens = _obs.counter(
    "hvd_serving_tokens_generated_total",
    "tokens delivered by finished requests")


@dataclasses.dataclass
class RequestResult:
    """What a submit() future resolves to."""

    req_id: int
    prompt: np.ndarray
    tokens: list[int]          # the generated continuation
    metrics: dict              # ttft_s, queue_wait_s, decode_tokens_per_s…

    @property
    def full_sequence(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])


class ServingSession:
    """One live engine + its request-facing bookkeeping."""

    def __init__(self, engine: ServingEngine, *,
                 timeline: Optional[Timeline] = None,
                 own_timeline: bool = True,
                 recover: bool = True,
                 max_recoveries: int = 3,
                 recovery_pause_s: float = 0.0) -> None:
        self.engine = engine
        # own_timeline=False: the timeline is borrowed (the runtime's
        # global Timeline v2) and must survive this session's close().
        self._own_timeline = own_timeline
        self._timeline = timeline or Timeline(None)
        self._futures: dict[int, Future] = {}
        self._trace_ids: dict[int, str] = {}       # req_id -> trace id
        self._t_last_emit: dict[int, float] = {}   # req_id -> last token ts
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Graceful degradation: an engine-step failure aborts in-flight
        # requests (error finish_reason), holds the serving component
        # unready through the drain window, and resumes — instead of
        # dying.
        self._recover = recover
        self._max_recoveries = max_recoveries
        self._recovery_pause_s = recovery_pause_s
        self.recoveries = 0
        from ..context import set_component_health
        set_component_health("serving", True)

    # -- client surface --------------------------------------------------
    def submit(self, prompt: Sequence[int], max_tokens: int, *,
               eos_token: Optional[int] = None,
               stream_cb: Optional[Callable[[int, int], None]] = None,
               migrate_cb: Optional[Callable] = None,
               trace_ctx: Optional[dict] = None
               ) -> Future:
        """Queue a request; the future resolves to a
        :class:`RequestResult`.  ``stream_cb(req_id, token)`` fires once
        per generated token, in order.  ``migrate_cb`` makes this a
        prefill-only request (disaggregated serving): the future
        resolves after the prefill emission with
        ``finish_reason="migrated"`` and the callback receives the
        exported KV — see :mod:`horovod_tpu_torch.serving.disagg`.
        ``trace_ctx`` joins an upstream trace (a router ingress span's
        ``Span.context()`` dict, carried over the request transport)."""
        fut: Future = Future()
        with self._lock:
            req = self.engine.submit(prompt, max_tokens,
                                     eos_token=eos_token,
                                     stream_cb=stream_cb,
                                     migrate_cb=migrate_cb,
                                     trace_ctx=trace_ctx)
            self._futures[req.req_id] = fut
            if req.trace.sampled:
                self._trace_ids[req.req_id] = req.trace.trace_id
                # Bounded like the tracer's finished-trace table: once a
                # trace would be evicted there, its id here is dead
                # weight — don't leak one entry per request forever.
                from ..obs import trace as _trace
                while len(self._trace_ids) > _trace.TRACER.keep:
                    self._trace_ids.pop(next(iter(self._trace_ids)))
        return fut

    def import_migrated(self, manifest: dict, k_bytes: bytes,
                        v_bytes: bytes, *,
                        stream_cb: Optional[Callable[[int, int], None]]
                        = None) -> Future:
        """Resume a migrated request on this (decode-pool) session: the
        exported KV blocks attach to the local pool with zero
        re-prefill and the request joins the running decode batch.  The
        future resolves to the FULL generated continuation (the
        prefill-emitted token plus every decode token).  Raises
        ``OutOfBlocks``/``ValueError`` when this engine cannot take the
        request right now — the router retries another replica."""
        fut: Future = Future()
        with self._lock:
            req = self.engine.import_migrated(manifest, k_bytes, v_bytes,
                                              stream_cb=stream_cb)
            self._futures[req.req_id] = fut
            if req.trace.sampled:
                self._trace_ids[req.req_id] = req.trace.trace_id
        return fut

    def request_trace(self, req_id: int) -> Optional[dict]:
        """The finished request's trace as a JSON-ready dict (span chain
        with shared trace id), or None when the request was unsampled or
        its trace already evicted from the tracer's bounded table."""
        from ..obs import trace as _trace
        with self._lock:
            tid = self._trace_ids.get(req_id)
        return _trace.TRACER.export(tid) if tid else None

    def drain(self, max_steps: Optional[int] = None) -> None:
        """Synchronously step the engine until every request finished."""
        n = 0
        while self.engine.has_work():
            self._step_once()
            n += 1
            if max_steps is not None and n >= max_steps:
                break

    def start(self) -> "ServingSession":
        """Background serving thread (the example's interactive mode)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    with self._lock:
                        busy = self.engine.has_work()
                    if busy:
                        self._step_once()
                    else:
                        time.sleep(0.001)
                except Exception as e:  # engine died: fail every future
                    with self._lock:
                        futs = list(self._futures.values())
                        self._futures.clear()
                    for fut in futs:
                        if not fut.done():
                            fut.set_exception(e)
                    log.exception("serving thread stopped on engine error")
                    return

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="hvdtpu-serving")
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        if self._own_timeline:
            self._timeline.close()
        from ..context import set_component_health
        set_component_health("serving", None)

    def __enter__(self) -> "ServingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- engine pump -----------------------------------------------------
    def _step_once(self) -> None:
        try:
            with self._lock:
                emissions = self.engine.step()
                failed = self.engine.pop_failed()
        except Exception as e:
            self._handle_engine_failure(e)
            return
        for req, exc in failed:
            self._t_last_emit.pop(req.req_id, None)
            _m_requests.labels(outcome="failed").inc()
            fut = self._futures.pop(req.req_id, None)
            if fut is not None and not fut.done():
                fut.set_exception(exc)
        now = time.monotonic()
        for req, token in emissions:
            if req.t_first_token is None:
                req.t_first_token = now
                _m_ttft.observe(now - req.t_submit)
            else:
                last = self._t_last_emit.get(req.req_id)
                if last is not None:
                    _m_itl.observe(now - last)
            self._t_last_emit[req.req_id] = now
            if req.stream_cb is not None:
                req.stream_cb(req.req_id, token)
            if req.state.value == "finished":
                self._resolve(req)

    def _resolve(self, req: Request) -> None:
        self._t_last_emit.pop(req.req_id, None)
        m = req.metrics()
        # Registry routing of the per-request metrics dict (the log line
        # below stays — grep-ability is a feature, it is just no longer
        # the only consumer).  TTFT/ITL were observed at emission time;
        # the submit->admission share and the decode rate land here.
        _m_requests.labels(outcome="finished").inc()
        _m_tokens.inc(m["new_tokens"])
        _m_queue_wait.observe(m["queue_wait_s"])
        if m["decode_tokens_per_s"]:
            _m_decode_rate.set(m["decode_tokens_per_s"])
        log.info(
            "serving req=%d prompt=%d new=%d queue_wait=%.4fs ttft=%.4fs "
            "decode_tok_s=%s preemptions=%d trace=%s",
            m["req_id"], m["prompt_len"], m["new_tokens"],
            m["queue_wait_s"] or 0.0, m["ttft_s"] or 0.0,
            f"{m['decode_tokens_per_s']:.1f}"
            if m["decode_tokens_per_s"] else "n/a", m["preemptions"],
            m["trace_id"] or "-")
        fut = self._futures.pop(req.req_id, None)
        if fut is not None and not fut.done():
            fut.set_result(RequestResult(
                req_id=req.req_id, prompt=req.prompt,
                tokens=list(req.generated), metrics=m))

    # -- graceful degradation --------------------------------------------
    def _handle_engine_failure(self, exc: BaseException) -> None:
        """One engine-step failure, survived: abort in-flight requests
        with an ``error`` finish_reason (futures resolve to their
        partial results — streamed tokens are already delivered, not
        lied about), hold the ``serving`` component unready through the
        drain window, then resume serving.  Past ``max_recoveries`` the
        failure is re-raised (a permanently sick engine should die
        loudly, not flap).  After a collective failure
        (``HorovodInternalError``) a running runtime is re-initialized
        through the elastic path before serving resumes."""
        from ..context import is_initialized, set_component_health
        self.recoveries += 1
        log.error("serving: engine step failed (%s); aborting in-flight "
                  "requests and degrading (recovery %d/%d)",
                  exc, self.recoveries, self._max_recoveries)
        set_component_health("serving", False,
                             reason=f"engine step failed: {exc}")
        _frec.RECORDER.record("serving_abort", error=repr(exc),
                              recovery=self.recoveries)
        with self._lock:
            aborted = self.engine.abort_inflight(exc)
            futs = [(req, self._futures.pop(req.req_id, None))
                    for req in aborted]
        for req, fut in futs:
            self._t_last_emit.pop(req.req_id, None)
            _m_requests.labels(outcome="aborted").inc()
            if fut is not None and not fut.done():
                m = req.metrics()
                m["error"] = str(exc)
                fut.set_result(RequestResult(
                    req_id=req.req_id, prompt=req.prompt,
                    tokens=list(req.generated), metrics=m))
        if self.recoveries > self._max_recoveries or not self._recover:
            _frec.RECORDER.maybe_dump("serving_abort",
                                      extra={"error": repr(exc)})
            raise exc
        if self._recovery_pause_s:
            # The drain window: probes must see 503 long enough for a
            # router to pull this replica before traffic resumes.
            time.sleep(self._recovery_pause_s)
        if isinstance(exc, HorovodInternalError) and is_initialized():
            # Collective failure: the world itself is suspect — rejoin
            # through the elastic path (shutdown -> init -> republish)
            # so this replica re-rendezvouses instead of serving on a
            # dead world.
            try:
                from ..elastic.runner import _reinitialize
                _reinitialize()
            except Exception as e2:
                set_component_health(
                    "serving", False,
                    reason=f"re-rendezvous failed: {e2}")
                raise
        set_component_health("serving", True)
        log.warning("serving: recovered after engine failure (%d request"
                    "(s) aborted); accepting traffic again", len(futs))


def serve(params: Any, cfg, *, mesh=None,
          engine_cfg: Optional[EngineConfig] = None,
          timeline: Optional[Timeline] = None,
          recover: bool = True, max_recoveries: int = 3,
          recovery_pause_s: float = 0.0,
          draft_params: Any = None, draft_cfg=None, device=None,
          **engine_kw) -> ServingSession:
    """Build a serving session for a model.

    ``engine_cfg`` carries the pool/scheduler knobs; keyword overrides
    (``block_size=…``, ``num_blocks=…``, …) are applied on top::

        session = serve(params, cfg, num_blocks=256, max_active=16)
        fut = session.submit(prompt_ids, max_tokens=64)
        session.drain()
        print(fut.result().tokens)

    ``device`` is where the engine runs: the process's card
    (``cuda:<local_rank>``) by default, ``"cpu"`` when the caller asks for
    it.  Without a card and without ``device="cpu"`` this raises.  The
    parameters must already live on that device.

    ``recover``/``max_recoveries``/``recovery_pause_s`` configure the
    graceful-degradation loop: on an engine-step failure the session
    aborts in-flight requests with an ``error`` finish_reason, holds the
    ``serving`` component unready through the drain window
    (``recovery_pause_s``) and resumes — see
    :meth:`ServingSession._handle_engine_failure`.

    ``prefix_cache=True`` (with ``prefix_cache_max_blocks``) turns on the
    radix prefix cache: a prompt whose head matches a cached prefix
    prefills only its tail.  ``spec_k=k`` with ``draft_params``/
    ``draft_cfg`` (a dense model of the same vocabulary, its parameters on
    the same device) turns on speculative decoding: k draft tokens a
    round, verified in one target forward; ``spec_k`` without a draft
    raises ``ValueError``.  Both emit the tokens of plain greedy decoding.
    ``mesh=`` (a dp/fsdp/tp mesh of :func:`~horovod_tpu_torch.parallel.
    build_mesh`, ``params`` this rank's blocks from
    :func:`~horovod_tpu_torch.models.llama.shard_params` or
    ``init_params(mesh=)``) serves sharded: every rank builds the session
    and submits the same requests in the same order, and every rank's
    engine emits every request's tokens (see
    :mod:`horovod_tpu_torch.serving.engine`); sp, ep and pp raise
    ``NotImplementedError`` with the JAX package's message.
    """
    base = engine_cfg or EngineConfig()
    if engine_kw:
        base = dataclasses.replace(base, **engine_kw)
    own_timeline = True
    if timeline is None:
        # Request traces render into the runtime's timeline when one is
        # armed (HOROVOD_TIMELINE at init()).  Borrowed, so
        # session.close() must not close the runtime's writer.
        from ..context import global_state, is_initialized
        if is_initialized():
            state_tl = global_state().timeline
            if state_tl is not None and state_tl.enabled:
                timeline = state_tl
                own_timeline = False
    engine = ServingEngine(params, cfg, engine_cfg=base, mesh=mesh,
                           timeline=timeline, device=device,
                           draft_params=draft_params, draft_cfg=draft_cfg)
    return ServingSession(engine, timeline=timeline,
                          own_timeline=own_timeline, recover=recover,
                          max_recoveries=max_recoveries,
                          recovery_pause_s=recovery_pause_s)
