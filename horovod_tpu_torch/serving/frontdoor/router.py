"""Multi-replica request router: signal-driven placement + failover.

The router is the placement authority in front of N dp serving
replicas.  It holds no model state — placement runs entirely on the
signals the obs plane already publishes to the job KV store per rank
(queue depth, batch occupancy, TTFT p99, SLO burn rate, readiness), so
the router scrapes nothing and opens no new connections:

- **eligibility** — a replica takes new placements only when it is
  alive (membership present), READY (``hvd_replica_ready``, mirroring
  the replica's ``/healthz`` serving component), and its snapshot is
  FRESH by the shared 2x-publish-interval rule
  (:func:`horovod_tpu_torch.obs.aggregate.snapshot_is_stale`) — a frozen
  publisher is a crashed or wedged replica no matter what its last
  snapshot claimed;
- **prefix affinity** — requests whose prompts share a head stick to
  the replica that saw the head first, so its radix prefix cache
  (:mod:`.prefix_cache`) keeps hitting; affinity yields to eligibility
  (a dead favorite is re-hashed, not waited for);
- **least-loaded scoring** otherwise: queue depth + weighted TTFT p99
  + weighted SLO burn, smallest wins;
- **failover** — flights on a replica that goes dead resubmit to a
  survivor with their partial tokens DISCARDED (the survivor replays
  from the prompt; greedy decode makes the replay token-identical, and
  streaming consumers see at-least-once delivery).  ``finish_reason``
  semantics are preserved: the client sees the natural ``stop`` /
  ``length`` from whichever replica finished, never a synthetic one.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np

from ... import chaos
from ...obs import REGISTRY as _obs
from ...obs import trace as _trace
from ...utils import logging as hvd_logging
from ..api import RequestResult

log = hvd_logging.get_logger()

_m_placed = _obs.counter(
    "hvd_router_placed_total", "placements by replica", ("replica",))
_m_failovers = _obs.counter(
    "hvd_router_failovers_total",
    "flights resubmitted after their replica went dead or errored")
_m_affinity = _obs.counter(
    "hvd_router_affinity_hits_total",
    "placements that followed prefix affinity to a sticky replica")
_m_requests = _obs.counter(
    "hvd_router_requests_total", "router requests by terminal outcome",
    ("outcome",))
_m_healthy = _obs.gauge(
    "hvd_router_replica_healthy",
    "1 = alive+ready+fresh, eligible for new placements", ("replica",))
_m_pending = _obs.gauge(
    "hvd_router_pending",
    "submitted flights waiting for an eligible replica")


class NoReplicaAvailable(RuntimeError):
    """No replica is alive, ready, and fresh."""


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    #: placement attempts per request (1 initial + failovers) before its
    #: future fails
    max_attempts: int = 3
    #: prompt tokens hashed into the prefix-affinity key (0 disables
    #: stickiness)
    affinity_tokens: int = 16
    #: bounded affinity table (LRU) — old prefixes age out
    affinity_capacity: int = 1024
    #: scoring weights: score = queue_depth + ttft_weight * ttft_p99
    #: + burn_weight * slo_burn; the smallest score wins
    ttft_weight: float = 10.0
    burn_weight: float = 5.0
    #: drain() poll cadence
    poll_interval_s: float = 0.02
    #: an EXISTING flight fails over only after its replica has looked
    #: dead (not alive, or snapshot stale) for this long continuously —
    #: one missed publish interval (a replica busy compiling) must not
    #: strand work; dead-at-placement replicas are skipped immediately
    failover_grace_s: float = 1.5


@dataclasses.dataclass
class _Flight:
    fid: int
    prompt: np.ndarray
    max_tokens: int
    eos_token: Optional[int]
    stream_cb: Optional[Callable[[int, int], None]]
    future: Future
    affinity_key: Optional[tuple]
    trace: object
    replica: object = None
    handle: object = None
    attempts: int = 0
    delivered: int = 0            # streamed tokens relayed so far


class LocalReplica:
    """In-process replica over one
    :class:`~horovod_tpu_torch.serving.api.ServingSession` — the in-process
    twin of :class:`~.transport.KVReplicaClient` (same protocol), plus
    :meth:`kill` to simulate a crash: a killed replica stops stepping
    and goes dead in its signals, leaving its flights to failover."""

    def __init__(self, replica_id: str, session) -> None:
        self.replica_id = str(replica_id)
        self.session = session
        self.killed = False

    def kill(self) -> None:
        self.killed = True

    def drive(self) -> None:
        if not self.killed and self.session.engine.has_work():
            self.session._step_once()

    def signals(self) -> dict:
        if self.killed:
            from .transport import DEAD_SIGNALS
            return dict(DEAD_SIGNALS)
        eng = self.session.engine
        return {
            "alive": True, "stale": False, "ready": True,
            "queue_depth": float(len(eng.scheduler.waiting)),
            "occupancy": (len(eng.scheduler.running)
                          / eng.ecfg.max_active),
            "ttft_p99": None, "slo_burn": 0.0,
        }

    def submit(self, prompt, max_tokens: int, *,
               eos_token: Optional[int] = None,
               trace_ctx: Optional[dict] = None):
        tokens: list[int] = []
        fut = self.session.submit(
            prompt, max_tokens, eos_token=eos_token,
            stream_cb=lambda rid, t: tokens.append(int(t)),
            trace_ctx=trace_ctx)
        return (fut, tokens)

    def partial_tokens(self, handle) -> list[int]:
        return list(handle[1])

    def result(self, handle) -> Optional[dict]:
        fut = handle[0]
        if self.killed or not fut.done():
            return None
        try:
            res = fut.result()
        except Exception as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True, "tokens": list(res.tokens),
                "finish_reason": res.metrics.get("finish_reason"),
                "metrics": res.metrics}


class Router:
    """Placement + lifecycle over a set of replica handles
    (:class:`LocalReplica` in-process,
    :class:`~.transport.KVReplicaClient` across processes — any object
    with the same five-method protocol).

    Single-threaded by design: :meth:`submit` records the flight and
    tries to place it; :meth:`pump` is one non-blocking pass (drive
    local replicas, relay streams, resolve results, failover dead
    replicas' flights, place the pending queue); :meth:`drain` pumps
    until every flight resolves."""

    def __init__(self, replicas: Sequence,
                 cfg: RouterConfig = RouterConfig()) -> None:
        if not replicas:
            raise ValueError("router needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas = list(replicas)
        self.cfg = cfg
        self._flights: dict[int, _Flight] = {}     # placed, in flight
        self._pending: deque[_Flight] = deque()    # awaiting placement
        self._affinity: OrderedDict = OrderedDict()
        self._next_fid = 0
        self._unhealthy_since: dict[str, float] = {}
        self.failovers = 0

    # -- client surface --------------------------------------------------
    def submit(self, prompt, max_tokens: int, *,
               eos_token: Optional[int] = None,
               stream_cb: Optional[Callable[[int, int], None]] = None
               ) -> Future:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        key = (tuple(int(t) for t
                     in prompt[:self.cfg.affinity_tokens])
               if self.cfg.affinity_tokens > 0 else None)
        fl = _Flight(
            fid=self._next_fid, prompt=prompt, max_tokens=max_tokens,
            eos_token=eos_token, stream_cb=stream_cb, future=Future(),
            affinity_key=key,
            trace=_trace.TRACER.start_trace(
                "router.request", lane=f"fd{self._next_fid}",
                prompt_len=int(prompt.size), max_tokens=max_tokens))
        self._next_fid += 1
        sigs = self._signals()
        self._refresh_health(sigs)
        try:
            self._place(fl, sigs)
        except NoReplicaAvailable:
            # Queue rather than reject: a drain window (every replica
            # briefly unready) should delay requests, not drop them.
            self._pending.append(fl)
        _m_pending.set(float(len(self._pending)))
        return fl.future

    def pump(self) -> None:
        """One non-blocking router pass."""
        for rep in self.replicas:
            rep.drive()
        sigs = self._signals()
        self._refresh_health(sigs)
        now = time.monotonic()
        for rid, sig in sigs.items():
            if self._eligible(sig, for_placement=False):
                self._unhealthy_since.pop(rid, None)
            else:
                self._unhealthy_since.setdefault(rid, now)
        for fl in list(self._flights.values()):
            self._relay_stream(fl)
            res = fl.replica.result(fl.handle)
            if res is not None:
                self._settle(fl, res, sigs)
            elif self._dead_for_grace(fl.replica.replica_id, now):
                self._failover(fl, sigs, why="replica dead")
        while self._pending:
            fl = self._pending[0]
            try:
                self._place(fl, sigs)
            except NoReplicaAvailable:
                break
            self._pending.popleft()
        _m_pending.set(float(len(self._pending)))

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Pump until every flight resolved (or the deadline passes)."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        while self._flights or self._pending:
            self.pump()
            if not (self._flights or self._pending):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"router drain: {len(self._flights)} in flight, "
                    f"{len(self._pending)} pending at deadline")
            time.sleep(self.cfg.poll_interval_s)

    # -- internals -------------------------------------------------------
    def _signals(self) -> dict:
        return {rep.replica_id: rep.signals() for rep in self.replicas}

    def _dead_for_grace(self, rid: str, now: float) -> bool:
        since = self._unhealthy_since.get(rid)
        return (since is not None
                and now - since >= self.cfg.failover_grace_s)

    @staticmethod
    def _eligible(sig: dict, *, for_placement: bool = True) -> bool:
        """Placement needs alive+fresh+ready; an EXISTING flight only
        needs its replica alive and fresh — an unready replica is
        draining but may still finish what it holds."""
        ok = sig["alive"] and not sig["stale"]
        return ok and sig["ready"] if for_placement else ok

    def _refresh_health(self, sigs: dict) -> None:
        for rid, sig in sigs.items():
            _m_healthy.labels(replica=rid).set(
                1.0 if self._eligible(sig) else 0.0)

    def _place(self, fl: _Flight, sigs: dict) -> None:
        # Chaos site: one traversal per placement decision; err makes
        # this placement fail over (or queue), delay slows the router.
        chaos.fire("router")
        eligible = [rep for rep in self.replicas
                    if self._eligible(sigs[rep.replica_id])]
        if not eligible:
            raise NoReplicaAvailable(
                "no replica is alive, ready, and fresh")
        chosen = None
        sticky = (self._affinity.get(fl.affinity_key)
                  if fl.affinity_key is not None else None)
        if sticky is not None:
            for rep in eligible:
                if rep.replica_id == sticky:
                    chosen = rep
                    _m_affinity.inc()
                    break
        if chosen is None:
            # The router's own outstanding-flight count per replica
            # joins the published queue depth: snapshots lag by a
            # publish interval, so a burst of submits scored on the
            # snapshot alone would dogpile whichever replica last
            # published an idle view.
            outstanding: dict[str, int] = {}
            for other in self._flights.values():
                rid = other.replica.replica_id
                outstanding[rid] = outstanding.get(rid, 0) + 1

            def score(rep):
                s = sigs[rep.replica_id]
                return (s["queue_depth"] + s["occupancy"]
                        + outstanding.get(rep.replica_id, 0)
                        + self.cfg.ttft_weight * (s["ttft_p99"] or 0.0)
                        + self.cfg.burn_weight * s["slo_burn"])
            chosen = min(eligible, key=score)
        if fl.affinity_key is not None:
            self._affinity[fl.affinity_key] = chosen.replica_id
            self._affinity.move_to_end(fl.affinity_key)
            while len(self._affinity) > self.cfg.affinity_capacity:
                self._affinity.popitem(last=False)
        fl.attempts += 1
        fl.replica = chosen
        fl.delivered = 0
        # The ingress span's context rides the submit so the replica's
        # engine trace joins this flight's trace_id (one connected trace
        # across router and replica processes).
        fl.handle = chosen.submit(fl.prompt, fl.max_tokens,
                                  eos_token=fl.eos_token,
                                  trace_ctx=fl.trace.context())
        # Queue depth moves immediately so the next placement in this
        # same pass doesn't dogpile the replica that just looked idle.
        sigs[chosen.replica_id]["queue_depth"] += 1
        self._flights[fl.fid] = fl
        _m_placed.labels(replica=chosen.replica_id).inc()
        sp = fl.trace.child("ROUTE", replica=chosen.replica_id,
                            attempt=fl.attempts)
        sp.end()

    def _relay_stream(self, fl: _Flight) -> None:
        if fl.stream_cb is None:
            return
        toks = fl.replica.partial_tokens(fl.handle)
        for t in toks[fl.delivered:]:
            fl.stream_cb(fl.fid, int(t))
        fl.delivered = max(fl.delivered, len(toks))

    def _settle(self, fl: _Flight, res: dict, sigs: dict) -> None:
        if not res.get("ok") or res.get("finish_reason") == "error":
            # The replica aborted the request (engine failure mid
            # request) — same treatment as a dead replica: discard
            # partials, try a survivor.
            self._failover(fl, sigs,
                           why=res.get("error", "replica abort"))
            return
        tokens = [int(t) for t in res["tokens"]]
        if fl.stream_cb is not None:
            for t in tokens[fl.delivered:]:
                fl.stream_cb(fl.fid, t)
        del self._flights[fl.fid]
        _m_requests.labels(outcome="finished").inc()
        metrics = dict(res.get("metrics") or {})
        metrics["router_attempts"] = fl.attempts
        metrics["replica"] = fl.replica.replica_id
        fl.trace.end(outcome="finished",
                     finish_reason=res.get("finish_reason"),
                     attempts=fl.attempts)
        fl.future.set_result(RequestResult(
            req_id=fl.fid, prompt=fl.prompt, tokens=tokens,
            metrics=metrics))

    def _failover(self, fl: _Flight, sigs: dict, *, why: str) -> None:
        del self._flights[fl.fid]
        if fl.attempts >= self.cfg.max_attempts:
            _m_requests.labels(outcome="failed").inc()
            fl.trace.end(outcome="failed", attempts=fl.attempts,
                         error=why)
            fl.future.set_exception(NoReplicaAvailable(
                f"request {fl.fid} failed after {fl.attempts} "
                f"attempts (last: {why})"))
            return
        self.failovers += 1
        _m_failovers.inc()
        log.warning(
            "router: flight %d leaving replica %s (%s); resubmitting "
            "(attempt %d, partial tokens discarded — replay is "
            "at-least-once)", fl.fid, fl.replica.replica_id, why,
            fl.attempts + 1)
        fl.trace.event("failover", from_replica=fl.replica.replica_id,
                       why=why)
        # Partial tokens are discarded: the survivor re-decodes from
        # the prompt, and greedy determinism makes the replayed stream
        # identical to the lost one.
        fl.delivered = 0
        fl.replica = fl.handle = None
        try:
            self._place(fl, sigs)
        except NoReplicaAvailable:
            self._pending.append(fl)
