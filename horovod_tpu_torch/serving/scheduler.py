"""Continuous-batching request scheduler (policy, no device code).

Separation of concerns mirrors HiCCL's policy/transport split
(arXiv:2408.05962): this module decides WHAT runs each step — admission,
phase split, join/evict, preemption — and the engine owns HOW it runs on
the mesh.  Everything here is host-side Python over the
:class:`~horovod_tpu_torch.serving.kv_pager.KVPager` bookkeeping; it never
touches a tensor, so its invariants are testable without a device.

Policy:
- **FIFO admission** — strict arrival order, no head-of-line bypass, so
  long prompts cannot starve (fairness under mixed lengths is a test).
- **Prefill token budget** — at most ``prefill_token_budget`` prompt
  tokens enter prefill per step (always at least one request, so an
  over-budget prompt still runs — alone).  Bounding prefill work per step
  bounds the latency decode ticks see between tokens.
- **Join/evict per step** — finished requests leave and free their blocks
  before admission, so a drained slot is refilled the same step.
- **LIFO preemption on OOM** — when a growing request cannot get a block,
  the youngest running request is preempted: blocks freed, request
  re-queued at the FRONT with its generated tokens folded into the
  prompt.  Greedy decode is deterministic, so a preempted request resumes
  with an identical continuation.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..obs import REGISTRY as _obs
from ..obs import trace as _trace
from .kv_pager import KVPager, OutOfBlocks

_m_preemptions = _obs.counter(
    "hvd_serving_preemptions_total",
    "running requests evicted back to the queue on pool pressure")


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class Request:
    """One inference request and its lifecycle bookkeeping."""

    req_id: int
    prompt: np.ndarray                  # [P] int32 — original prompt
    max_new_tokens: int
    eos_token: Optional[int] = None
    stream_cb: Optional[Callable[[int, int], None]] = None
    state: RequestState = RequestState.WAITING
    #: why the request stopped: "stop" (eos), "length" (max_new_tokens),
    #: "error" (failed/aborted — the graceful-degradation contract: an
    #: engine failure finishes in-flight requests with this reason and
    #: their partial tokens instead of hanging them), "cancelled";
    #: None while live.
    finish_reason: Optional[str] = None
    #: tokens generated so far (grows per decode tick / prefill emit)
    generated: list[int] = dataclasses.field(default_factory=list)
    #: prompt actually prefilled (original + generated-before-preemption)
    prefill_tokens: Optional[np.ndarray] = None
    #: current context length in the pool (prefilled + generated there)
    context_len: int = 0
    #: prompt tokens satisfied from the prefix cache at admission (their
    #: K/V blocks were attached shared instead of prefilled); reset on
    #: preemption — re-admission re-matches
    cached_tokens: int = 0
    preemptions: int = 0
    # metrics timestamps (time.monotonic)
    t_submit: float = 0.0
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    #: last time the request (re-)entered the waiting queue — t_submit
    #: at first submit, the preemption time afterwards; the trace's
    #: per-QUEUE-span wait is measured from here (t_submit would charge
    #: a preempted request's whole prior lifetime to queueing).
    t_enqueued: Optional[float] = None
    #: disaggregated-serving hook: when set, the engine stops the request
    #: after its prefill emission, exports its KV blocks, and calls
    #: ``migrate_cb(manifest, k_bytes, v_bytes)`` — the request finishes
    #: locally with ``finish_reason="migrated"`` and a decode-pool
    #: replica continues it (see serving/disagg).  None = normal serving.
    migrate_cb: Optional[Callable] = None
    #: request-scoped trace (obs/trace): the root span of this request's
    #: causal chain (NULL_SPAN when unsampled/untraced) plus the open
    #: phase spans, keyed "queue"/"prefill"/"decode"; "prev" holds the
    #: last ended phase span so the next phase chains a flow arrow to it.
    trace: object = dataclasses.field(
        default=_trace.NULL_SPAN, compare=False, repr=False)
    spans: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def remaining_new(self) -> int:
        return self.max_new_tokens - len(self.generated)

    def metrics(self) -> dict:
        done = self.t_finished or time.monotonic()
        ttft = (self.t_first_token - self.t_submit
                if self.t_first_token is not None else None)
        decode_s = (done - self.t_first_token
                    if self.t_first_token is not None else None)
        return {
            "req_id": self.req_id,
            "prompt_len": int(self.prompt.shape[0]),
            "new_tokens": len(self.generated),
            "queue_wait_s": ((self.t_admitted or done) - self.t_submit),
            "ttft_s": ttft,
            "decode_tokens_per_s": (
                (len(self.generated) - 1) / decode_s
                if decode_s and len(self.generated) > 1 else None),
            "preemptions": self.preemptions,
            "cached_tokens": self.cached_tokens,
            "finish_reason": self.finish_reason,
            "trace_id": self.trace.trace_id,
        }

    # -- trace phases (one connected QUEUE->PREFILL->DECODE chain) -------
    def open_phase(self, name: str, **attrs) -> object:
        """Open a phase span chained (flow arrow) to the previously
        ended one; no-ops end-to-end on unsampled requests."""
        sp = self.trace.child(name.upper(), after=self.spans.get("prev"),
                              **attrs)
        self.spans[name] = sp
        return sp

    def close_phase(self, name: str, **attrs) -> None:
        sp = self.spans.pop(name, None)
        if sp is not None:
            sp.end(**attrs)
            self.spans["prev"] = sp

    def close_trace(self, outcome: str, **attrs) -> None:
        """End any open phase and the root span (terminal state)."""
        for phase in ("queue", "prefill", "decode"):
            self.close_phase(phase)
        self.trace.end(outcome=outcome, new_tokens=len(self.generated),
                       preemptions=self.preemptions, **attrs)


class Scheduler:
    """Admission queue + running set over a :class:`KVPager`.

    The engine drives it:  ``finish()``/``cancel()`` retire requests,
    ``admit()`` returns this step's prefill batch, ``grow()`` reserves
    decode blocks (preempting on OOM), ``running`` is the decode batch.
    """

    def __init__(self, pager: KVPager, *, max_active: int,
                 prefill_token_budget: int,
                 prefix_cache=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_active < 1:
            raise ValueError("max_active must be >= 1")
        self.pager = pager
        #: optional frontdoor.PrefixCache — admission matches prompts
        #: against it and pool pressure evicts from it before preempting
        self.prefix_cache = prefix_cache
        self.max_active = max_active
        self.prefill_token_budget = max(1, prefill_token_budget)
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        #: requests that can never run (prompt exceeds the whole pool) —
        #: the engine drains these and fails their futures; leaving them
        #: queued would livelock admission behind an unfillable head.
        self.failed: list[tuple[Request, Exception]] = []
        self._clock = clock

    def _fits_pool_at_all(self, n_tokens: int) -> bool:
        return (self.pager.cache.blocks_for(n_tokens + 1)
                <= self.pager.cache.num_blocks - 1)

    def _fail_terminal(self, req: Request, exc: Exception) -> None:
        """The one place a request reaches ``self.failed``: terminal
        bookkeeping shared by the waiting-queue and running-set failure
        paths so the contract cannot drift between them."""
        req.state = RequestState.CANCELLED
        req.finish_reason = "error"
        req.t_finished = self._clock()
        req.close_trace("failed", error=str(exc))
        self.failed.append((req, exc))

    def _fail(self, req: Request, why: str) -> None:
        self._fail_terminal(req, OutOfBlocks(why))

    # -- queue surface ---------------------------------------------------
    def submit(self, req: Request) -> None:
        req.t_submit = req.t_submit or self._clock()
        req.t_enqueued = req.t_submit
        req.state = RequestState.WAITING
        req.open_phase("queue", prompt_len=int(req.prompt.shape[0]))
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- per-step phases -------------------------------------------------
    def finish(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        req.t_finished = self._clock()
        self.running.remove(req)
        self.pager.release(req.req_id)
        m = req.metrics()
        req.close_trace("finished",
                        ttft_s=m["ttft_s"],
                        queue_wait_s=round(m["queue_wait_s"], 6),
                        decode_tokens_per_s=m["decode_tokens_per_s"])

    def cancel(self, req: Request) -> None:
        req.state = RequestState.CANCELLED
        req.finish_reason = "cancelled"
        req.t_finished = self._clock()
        req.close_trace("cancelled")
        if req in self.running:
            self.running.remove(req)
            self.pager.release(req.req_id)
        elif req in self.waiting:
            self.waiting.remove(req)

    def admit(self) -> list[Request]:
        """Admit waiting requests in FIFO order until the active-slot cap,
        block supply, or the prefill token budget stops the step.  Each
        admitted request gets its blocks allocated here (prompt + 1 slot
        for the token prefill emits)."""
        admitted: list[Request] = []
        budget = self.prefill_token_budget
        while self.waiting and len(self.running) < self.max_active:
            req = self.waiting[0]
            prefill = req.prefill_tokens if req.prefill_tokens is not None \
                else req.prompt
            n = int(prefill.shape[0])
            if not self._fits_pool_at_all(n):
                # Can never fit even in an empty pool: fail it rather
                # than livelock the strictly-FIFO queue behind it.
                self.waiting.popleft()
                self._fail(req, f"request {req.req_id} needs "
                           f"{self.pager.cache.blocks_for(n + 1)} blocks "
                           f"for its {n}-token prefill; the pool only has "
                           f"{self.pager.cache.num_blocks - 1}")
                continue
            if admitted and n > budget:
                break                    # budget spent; strictly FIFO
            # Longest cached prefix: its blocks attach shared (no
            # prefill, no free-list draw) and only the remainder needs
            # fresh blocks.  match() does not reserve, so the eviction
            # valve below must protect the matched blocks.
            cached, cached_blocks = (
                self.prefix_cache.match(prefill)
                if self.prefix_cache is not None else (0, []))
            need = (self.pager.cache.blocks_for(n + 1)
                    - len(cached_blocks))
            if need > self.pager.free_blocks:
                if self.prefix_cache is not None:
                    self.prefix_cache.evict(
                        need - self.pager.free_blocks,
                        protect=cached_blocks)
                if need > self.pager.free_blocks:
                    break                # no head-of-line bypass
            self.waiting.popleft()
            req.prefill_tokens = np.asarray(prefill, np.int32)
            self.pager.allocate(req.req_id, n + 1,
                                prefix_blocks=cached_blocks)
            req.cached_tokens = cached
            req.context_len = n
            req.state = RequestState.RUNNING
            req.t_admitted = req.t_admitted or self._clock()
            # Batch decision lands on the trace: which slot of this
            # step's prefill batch took the request, and what the
            # admission cost was.
            req.close_phase(
                "queue",
                queue_wait_s=round(
                    self._clock() - (req.t_enqueued
                                     if req.t_enqueued is not None
                                     else req.t_submit), 6),
                prefill_batch_slot=len(admitted),
                budget_left=budget - n)
            self.running.append(req)
            admitted.append(req)
            budget -= n
            if budget <= 0:
                break
        return admitted

    def fail_running(self, req: Request, exc: Exception) -> None:
        """Fail one RUNNING request that cannot continue (it cannot fit
        in the pool even alone) without disturbing the rest of the
        batch — a per-request capacity problem is not an engine
        failure, so it must not trip the session's degradation path."""
        self.running.remove(req)
        self.pager.release(req.req_id)
        self._fail_terminal(req, exc)

    def grow(self, req: Request, n: int = 1) -> None:
        """Reserve pool space for ``req``'s next ``n`` positions (one
        decode tick, or a whole speculative round), evicting cold cached
        prefixes and then preempting the youngest OTHER running request
        until the allocation fits."""
        while True:
            try:
                self.pager.extend(req.req_id, req.context_len + n)
                return
            except OutOfBlocks:
                # Pressure valve order: dropping a refcount-1 cached
                # block loses a possible future prefill skip; preempting
                # loses certain already-done work.  Cache first.
                if self.prefix_cache is not None \
                        and self.prefix_cache.evict(1):
                    continue
                victim = self._youngest_other(req)
                if victim is None:
                    raise OutOfBlocks(
                        f"pool too small for request {req.req_id} alone "
                        f"(context {req.context_len})")
                self.preempt(victim)

    def preempt(self, req: Request) -> None:
        """Evict a RUNNING request back to the queue front.  Its generated
        tokens fold into the prefill prompt, so on re-admission it
        re-prefills once and continues exactly where it stopped (greedy
        decode is deterministic)."""
        self.running.remove(req)
        self.pager.release(req.req_id)
        req.prefill_tokens = np.concatenate(
            [req.prompt, np.asarray(req.generated, np.int32)])
        req.context_len = 0
        req.cached_tokens = 0            # re-admission re-matches
        req.state = RequestState.WAITING
        req.preemptions += 1
        _m_preemptions.inc()
        # The eviction is part of the request's causal chain: close the
        # decode phase as preempted and re-enter the queue as a new span
        # (the chain reads QUEUE->PREFILL->DECODE->QUEUE->...).
        req.close_phase("decode", preempted=True)
        req.trace.event("preempt",
                        generated=len(req.generated),
                        refill_tokens=int(req.prefill_tokens.shape[0]))
        req.t_enqueued = self._clock()
        req.open_phase("queue", preemption=req.preemptions)
        self.waiting.appendleft(req)

    def _youngest_other(self, keep: Request) -> Optional[Request]:
        for req in reversed(self.running):
            if req is not keep:
                return req
        return None
