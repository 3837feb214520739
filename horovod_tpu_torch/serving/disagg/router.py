"""Pool-aware router: prefill placement, migration handoff, decode.

The :class:`DisaggRouter` is the placement authority over a
disaggregated fleet.  Every request moves through first-class router
states::

    queued -> prefilling -> migrating -> decoding -> (resolved)

- **prefill placement** scores the prefill pool on what prefill burns:
  queue depth + outstanding flights + weighted TTFT p99 + weighted SLO
  burn (smallest wins);
- **decode placement** scores the decode pool on what decode burns:
  batch occupancy + outstanding flights + weighted ITL p99;
- **migration handoff**: the prefill replica publishes the KV export
  under a router-assigned ``mig_id`` (one id per prefill attempt, so
  every publish is write-once); the router then places the import on a
  decode replica.  ``fd/mig`` manifests are the durable replay points:
- **failover at any stage replays token-identically** (greedy decode is
  deterministic) from the last durable point — a prefill replica dead
  *before* its manifest landed restarts from the prompt on a pool
  survivor; dead *after*, the flight proceeds straight to the decode
  pool with the published blocks; a decode replica dead mid-stream
  re-imports the same manifest elsewhere and re-decodes from the first
  token.  Streamed tokens are relayed past the high-water mark only, so
  clients see exactly-once delivery under replay.

``mixed``-pool replicas join both pools (the colocated baseline —
also what a fleet looks like mid-rollout).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np

from ... import chaos
from ...obs import REGISTRY as _obs
from ...obs import trace as _trace
from ...utils import logging as hvd_logging
from ..api import RequestResult
from ..frontdoor.router import NoReplicaAvailable
from ..frontdoor.transport import DEAD_SIGNALS
from ..kv_pager import OutOfBlocks
from . import transport as mig_transport
from .transport import MigrationUnavailable

log = hvd_logging.get_logger()

_m_placed = _obs.counter(
    "hvd_disagg_placed_total", "placements by pool and replica",
    ("pool", "replica"))
_m_requests = _obs.counter(
    "hvd_disagg_requests_total",
    "disaggregated requests by terminal outcome", ("outcome",))
_m_failovers = _obs.counter(
    "hvd_disagg_failovers_total",
    "stage replays after a replica died or errored", ("stage",))
_m_pool_replicas = _obs.gauge(
    "hvd_disagg_pool_replicas",
    "replicas of this pool currently eligible for placement (alive + "
    "ready + fresh)", ("pool",))
_m_flights = _obs.gauge(
    "hvd_disagg_flights", "in-flight requests by router state",
    ("state",))
_m_handoff_s = _obs.histogram(
    "hvd_disagg_handoff_seconds",
    "prefill emission -> decode import placed (the migration gap a "
    "request's ITL stream sees once)")


@dataclasses.dataclass(frozen=True)
class DisaggRouterConfig:
    #: total placement attempts per request across both stages (initial
    #: prefill + every replay) before its future fails
    max_attempts: int = 4
    #: prefill-pool scoring: queue_depth + outstanding
    #: + ttft_weight * ttft_p99 + burn_weight * slo_burn
    ttft_weight: float = 10.0
    burn_weight: float = 5.0
    #: decode-pool scoring: occupancy + outstanding
    #: + itl_weight * itl_p99 - prefix_weight * cached_fraction
    itl_weight: float = 10.0
    #: bonus for the decode replica whose radix cache already holds the
    #: migrated prompt's prefix (the import attaches those blocks shared
    #: — no payload write, no pool pressure).  Scaled by the fraction of
    #: the prompt cached; kept small so occupancy/ITL still dominate.
    prefix_weight: float = 0.5
    #: drain() poll cadence
    poll_interval_s: float = 0.02
    #: continuous-dead window before an existing flight fails over
    failover_grace_s: float = 1.5
    #: overall budget for one migration fetch on the decode side
    fetch_timeout_ms: int = 15000
    #: delete fd/mig blobs once the request resolves (keep False to
    #: post-mortem migrations in tests)
    cleanup: bool = True


@dataclasses.dataclass
class _Flight:
    fid: int
    prompt: np.ndarray
    max_tokens: int
    eos_token: Optional[int]
    stream_cb: Optional[Callable[[int, int], None]]
    future: Future
    trace: object
    state: str = "queued"         # queued|prefilling|migrating|decoding
    replica: object = None        # current-stage replica handle
    handle: object = None
    mig_id: Optional[str] = None
    attempts: int = 0             # placements across both stages
    prefill_attempts: int = 0     # distinct prefill runs (mig_id suffix)
    delivered: int = 0            # streamed tokens relayed so far
    t_prefill_done: Optional[float] = None
    spans: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)


class LocalDisaggReplica:
    """In-process disagg replica over one
    :class:`~horovod_tpu_torch.serving.api.ServingSession` plus a shared KV
    (usually :class:`~.transport.DictKV`) the migration blobs travel
    through — the in-process twin of the KV-transport replica, same
    protocol.  ``drive=False`` when the session's own background
    thread steps the engine."""

    def __init__(self, replica_id: str, session, kv, *,
                 pool: str = "mixed", drive: bool = True) -> None:
        self.replica_id = str(replica_id)
        self.session = session
        self.pool = pool
        self.kv = kv
        self._drive = drive
        self.killed = False

    def kill(self) -> None:
        self.killed = True

    def drive(self) -> None:
        if self._drive and not self.killed \
                and self.session.engine.has_work():
            self.session._step_once()

    def signals(self) -> dict:
        if self.killed:
            return dict(DEAD_SIGNALS, pool=self.pool)
        eng = self.session.engine
        return {
            "alive": True, "stale": False, "ready": True,
            "pool": self.pool,
            "queue_depth": float(len(eng.scheduler.waiting)),
            "occupancy": (len(eng.scheduler.running)
                          / eng.ecfg.max_active),
            "ttft_p99": None, "itl_p99": None, "slo_burn": 0.0,
        }

    def submit_prefill(self, prompt, max_tokens: int, *,
                       eos_token: Optional[int] = None, mig_id: str,
                       trace_ctx: Optional[dict] = None):
        tokens: list[int] = []

        def publish(manifest, k_bytes, v_bytes):
            mig_transport.publish_migration(
                self.kv, mig_id, manifest, k_bytes, v_bytes)

        fut = self.session.submit(
            prompt, max_tokens, eos_token=eos_token,
            stream_cb=lambda rid, t: tokens.append(int(t)),
            migrate_cb=publish, trace_ctx=trace_ctx)
        return (fut, tokens, mig_id)

    def cached_prefix(self, tokens) -> int:
        """Non-mutating probe: how many leading tokens this replica's
        radix cache already holds (feeds the router's decode-placement
        prefix bonus; see :meth:`PrefixCache.peek`)."""
        pc = self.session.engine.prefix_cache
        return 0 if pc is None else int(pc.peek(tokens))

    def submit_import(self, mig_id: str, *,
                      fetch_timeout_ms: int = 15000):
        manifest, k_bytes, v_bytes = mig_transport.fetch_migration(
            self.kv, mig_id, timeout_ms=fetch_timeout_ms)
        tokens: list[int] = [int(t) for t in manifest["generated"]]
        fut = self.session.import_migrated(
            manifest, k_bytes, v_bytes,
            stream_cb=lambda rid, t: tokens.append(int(t)))
        return (fut, tokens, mig_id)

    def partial_tokens(self, handle) -> list[int]:
        return list(handle[1])

    def result(self, handle) -> Optional[dict]:
        fut = handle[0]
        if self.killed or not fut.done():
            return None
        try:
            res = fut.result()
        except Exception as e:
            return {"ok": False, "error": str(e),
                    "error_kind": type(e).__name__,
                    "mig_id": handle[2]}
        return {"ok": True, "tokens": list(res.tokens),
                "finish_reason": res.metrics.get("finish_reason"),
                "metrics": res.metrics, "mig_id": handle[2]}


class DisaggRouter:
    """Placement + migration lifecycle over a disaggregated fleet.

    ``replicas`` are handles carrying a ``pool`` attribute and the
    disagg protocol (``signals``/``drive``/``submit_prefill``/
    ``submit_import``/``partial_tokens``/``result``) —
    :class:`LocalDisaggReplica` in-process,
    :class:`~horovod_tpu_torch.serving.frontdoor.transport.KVReplicaClient`
    across processes.  ``kv`` is the router's own view of the job KV
    store, used for the durable-point probe and blob cleanup.
    Single-threaded like the colocated Router: :meth:`pump` is one
    non-blocking pass, :meth:`drain` pumps until resolved."""

    def __init__(self, replicas: Sequence, kv,
                 cfg: DisaggRouterConfig = DisaggRouterConfig()) -> None:
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas = list(replicas)
        self.kv = kv
        self.cfg = cfg
        self.prefill_pool = [r for r in replicas
                             if r.pool in ("prefill", "mixed")]
        self.decode_pool = [r for r in replicas
                            if r.pool in ("decode", "mixed")]
        if not self.prefill_pool or not self.decode_pool:
            raise ValueError(
                "DisaggRouter needs at least one prefill-capable and one "
                f"decode-capable replica (pools: "
                f"{[r.pool for r in replicas]})")
        self._flights: dict[int, _Flight] = {}
        self._next_fid = 0
        self._unhealthy_since: dict[str, float] = {}
        self.failovers = 0

    # -- client surface --------------------------------------------------
    def submit(self, prompt, max_tokens: int, *,
               eos_token: Optional[int] = None,
               stream_cb: Optional[Callable[[int, int], None]] = None
               ) -> Future:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        fl = _Flight(
            fid=self._next_fid, prompt=prompt, max_tokens=max_tokens,
            eos_token=eos_token, stream_cb=stream_cb, future=Future(),
            trace=_trace.TRACER.start_trace(
                "disagg.request", lane=f"dg{self._next_fid}",
                prompt_len=int(prompt.size), max_tokens=max_tokens))
        self._next_fid += 1
        self._flights[fl.fid] = fl
        sigs = self._signals()
        self._refresh_pools(sigs)
        self._try_place_prefill(fl, sigs)
        return fl.future

    def pump(self) -> None:
        """One non-blocking router pass: drive replicas, advance every
        flight's state machine, refresh pool health."""
        for rep in self.replicas:
            rep.drive()
        sigs = self._signals()
        self._refresh_pools(sigs)
        now = time.monotonic()
        for rid, sig in sigs.items():
            if sig["alive"] and not sig["stale"]:
                self._unhealthy_since.pop(rid, None)
            else:
                self._unhealthy_since.setdefault(rid, now)
        for fl in list(self._flights.values()):
            if fl.state == "queued":
                self._try_place_prefill(fl, sigs)
            elif fl.state == "prefilling":
                self._pump_prefilling(fl, sigs, now)
            elif fl.state == "migrating":
                self._try_place_decode(fl, sigs)
            elif fl.state == "decoding":
                self._pump_decoding(fl, sigs, now)
        self._sample_flight_gauge()

    def drain(self, timeout_s: Optional[float] = None) -> None:
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        while self._flights:
            self.pump()
            if not self._flights:
                return
            if deadline is not None and time.monotonic() > deadline:
                states = {}
                for fl in self._flights.values():
                    states[fl.state] = states.get(fl.state, 0) + 1
                raise TimeoutError(
                    f"disagg drain: {len(self._flights)} unresolved at "
                    f"deadline (by state: {states})")
            time.sleep(self.cfg.poll_interval_s)

    # -- state machine ---------------------------------------------------
    def _pump_prefilling(self, fl: _Flight, sigs: dict,
                         now: float) -> None:
        res = fl.replica.result(fl.handle)
        if res is None:
            if self._dead_for_grace(fl.replica.replica_id, now):
                self._replay_prefill(fl, sigs, why="prefill replica dead")
            return
        if not res.get("ok") or res.get("finish_reason") == "error":
            self._replay_prefill(
                fl, sigs, why=res.get("error", "prefill abort"))
            return
        self._relay(fl, [int(t) for t in res["tokens"]])
        if res.get("finish_reason") == "migrated":
            fl.t_prefill_done = now
            self._close_span(fl, "prefill")
            fl.spans["migrate"] = fl.trace.child(
                "MIGRATE", after=fl.spans.get("_prev"),
                mig_id=fl.mig_id)
            fl.state = "migrating"
            self._try_place_decode(fl, sigs)
        else:
            # Finished inside prefill (eos or max_tokens=1): no
            # migration leg at all.
            self._settle(fl, res)

    def _pump_decoding(self, fl: _Flight, sigs: dict,
                       now: float) -> None:
        self._relay(fl, fl.replica.partial_tokens(fl.handle))
        res = fl.replica.result(fl.handle)
        if res is None:
            if self._dead_for_grace(fl.replica.replica_id, now):
                self._replay_decode(fl, sigs, why="decode replica dead")
            return
        if res.get("ok") and res.get("finish_reason") != "error":
            self._settle(fl, res)
            return
        kind = res.get("error_kind", "")
        if kind == "MigrationUnavailable":
            # The durable point itself is gone (torn/expired blob):
            # fall back one stage and re-prefill from the prompt.
            self._replay_prefill(
                fl, sigs, why=res.get("error", "migration unavailable"))
        elif kind in ("OutOfBlocks", "NotImplementedError"):
            # This decode replica cannot take the import right now —
            # the manifest is still durable, try a pool sibling.
            self._replay_decode(fl, sigs, why=res.get("error", kind))
        else:
            self._replay_decode(
                fl, sigs, why=res.get("error", "decode abort"))

    # -- placement -------------------------------------------------------
    def _try_place_prefill(self, fl: _Flight, sigs: dict) -> None:
        chaos.fire("router")
        eligible = [r for r in self.prefill_pool
                    if self._eligible(sigs[r.replica_id])]
        if not eligible:
            fl.state = "queued"
            return
        outstanding = self._outstanding()

        def score(rep):
            s = sigs[rep.replica_id]
            return (s["queue_depth"]
                    + outstanding.get(rep.replica_id, 0)
                    + self.cfg.ttft_weight * (s["ttft_p99"] or 0.0)
                    + self.cfg.burn_weight * s["slo_burn"])

        chosen = min(eligible, key=score)
        fl.attempts += 1
        fl.prefill_attempts += 1
        # One mig_id per prefill run: every publish is write-once, so a
        # replayed prefill can never splice chunks into a half-read
        # blob of its predecessor.
        fl.mig_id = f"{fl.fid}.{fl.prefill_attempts}"
        fl.replica = chosen
        try:
            # The ingress span's context rides the submit: the prefill
            # engine joins this flight's trace, and the migration
            # manifest then carries the same context on to decode.
            fl.handle = chosen.submit_prefill(
                fl.prompt, fl.max_tokens, eos_token=fl.eos_token,
                mig_id=fl.mig_id, trace_ctx=fl.trace.context())
        except Exception as e:
            log.warning("disagg: prefill submit to %s failed: %s",
                        chosen.replica_id, e)
            fl.state = "queued"
            return
        fl.state = "prefilling"
        sigs[chosen.replica_id]["queue_depth"] += 1
        _m_placed.labels(pool="prefill", replica=chosen.replica_id).inc()
        fl.spans["prefill"] = fl.trace.child(
            "PREFILL", after=fl.spans.get("_prev"),
            replica=chosen.replica_id, attempt=fl.attempts)

    def _cached_fraction(self, rep, prompt) -> float:
        """Fraction of ``prompt`` already resident in ``rep``'s radix
        cache, through the handle's optional non-mutating
        ``cached_prefix`` probe.  Handles without one (e.g. the
        cross-process KV client — a synchronous remote probe per scoring
        pass would cost more than it saves) contribute 0.0."""
        probe = getattr(rep, "cached_prefix", None)
        n = 0 if prompt is None else len(prompt)
        if probe is None or n == 0:
            return 0.0
        try:
            return min(1.0, max(0.0, probe(prompt) / float(n)))
        except Exception:
            return 0.0

    def _try_place_decode(self, fl: _Flight, sigs: dict) -> None:
        chaos.fire("router")
        eligible = [r for r in self.decode_pool
                    if self._eligible(sigs[r.replica_id])]
        if not eligible:
            return                       # stay migrating; retry next pump
        outstanding = self._outstanding()

        def score(rep):
            s = sigs[rep.replica_id]
            return (s["occupancy"]
                    + outstanding.get(rep.replica_id, 0)
                    + self.cfg.itl_weight * (s["itl_p99"] or 0.0)
                    - self.cfg.prefix_weight * self._cached_fraction(
                        rep, fl.prompt))

        chosen = min(eligible, key=score)
        fl.attempts += 1
        try:
            handle = chosen.submit_import(
                fl.mig_id, fetch_timeout_ms=self.cfg.fetch_timeout_ms)
        except MigrationUnavailable as e:
            self._replay_prefill(fl, sigs, why=str(e))
            return
        except (OutOfBlocks, NotImplementedError) as e:
            log.warning("disagg: decode import on %s refused: %s",
                        chosen.replica_id, e)
            # The attempt is charged (it was a placement); stay
            # migrating — another pool sibling may have room — unless
            # the budget is already spent.
            self._charge_attempt(fl, str(e))
            return
        except Exception as e:
            log.warning("disagg: decode import on %s failed: %s",
                        chosen.replica_id, e)
            self._charge_attempt(fl, str(e))
            return
        fl.replica = chosen
        fl.handle = handle
        fl.state = "decoding"
        sigs[chosen.replica_id]["occupancy"] = min(
            1.0, sigs[chosen.replica_id]["occupancy"] + 0.01)
        _m_placed.labels(pool="decode", replica=chosen.replica_id).inc()
        if fl.t_prefill_done is not None:
            _m_handoff_s.observe(time.monotonic() - fl.t_prefill_done)
        self._close_span(fl, "migrate")
        fl.spans["decode"] = fl.trace.child(
            "DECODE", after=fl.spans.get("_prev"),
            replica=chosen.replica_id, attempt=fl.attempts)

    # -- replay / settle -------------------------------------------------
    def _replay_prefill(self, fl: _Flight, sigs: dict, *,
                        why: str) -> None:
        """Prefill-stage failover.  Durable-point check first: when the
        dying replica already published the manifest, the export is
        complete and the flight proceeds to the decode pool instead of
        re-prefilling."""
        if fl.mig_id is not None and \
                mig_transport.migration_published(self.kv, fl.mig_id):
            log.warning(
                "disagg: flight %d lost its prefill replica (%s) but "
                "migration %s is durable; proceeding to decode",
                fl.fid, why, fl.mig_id)
            fl.trace.event("failover", stage="prefill", why=why,
                           durable=True)
            _m_failovers.labels(stage="prefill").inc()
            self.failovers += 1
            fl.t_prefill_done = fl.t_prefill_done or time.monotonic()
            self._close_span(fl, "prefill")
            if "migrate" not in fl.spans:
                fl.spans["migrate"] = fl.trace.child(
                    "MIGRATE", after=fl.spans.get("_prev"),
                    mig_id=fl.mig_id, recovered=True)
            fl.state = "migrating"
            self._try_place_decode(fl, sigs)
            return
        if not self._charge_attempt(fl, why):
            return
        _m_failovers.labels(stage="prefill").inc()
        self.failovers += 1
        log.warning(
            "disagg: flight %d replaying prefill from the prompt (%s), "
            "attempt %d", fl.fid, why, fl.attempts + 1)
        fl.trace.event("failover", stage="prefill", why=why,
                       durable=False)
        self._close_span(fl, "prefill")
        self._close_span(fl, "migrate")
        self._close_span(fl, "decode")
        fl.replica = fl.handle = None
        fl.state = "queued"
        self._try_place_prefill(fl, sigs)

    def _replay_decode(self, fl: _Flight, sigs: dict, *,
                       why: str) -> None:
        """Decode-stage failover: the manifest is the durable point —
        re-import it on a pool sibling and re-decode from the first
        token.  Already-relayed tokens are not re-delivered (the replay
        is token-identical, so the relay high-water mark still
        matches)."""
        if not self._charge_attempt(fl, why):
            return
        _m_failovers.labels(stage="decode").inc()
        self.failovers += 1
        log.warning(
            "disagg: flight %d re-importing migration %s (%s), "
            "attempt %d", fl.fid, fl.mig_id, why, fl.attempts + 1)
        fl.trace.event("failover", stage="decode", why=why)
        self._close_span(fl, "decode")
        fl.replica = fl.handle = None
        fl.state = "migrating"
        if "migrate" not in fl.spans:
            fl.spans["migrate"] = fl.trace.child(
                "MIGRATE", after=fl.spans.get("_prev"),
                mig_id=fl.mig_id, replay=True)
        self._try_place_decode(fl, sigs)

    def _charge_attempt(self, fl: _Flight, why: str) -> bool:
        """Attempt budget gate shared by both replay paths; failing the
        flight resolves its future with the terminal error."""
        if fl.attempts < self.cfg.max_attempts:
            return True
        del self._flights[fl.fid]
        _m_requests.labels(outcome="failed").inc()
        for name in ("prefill", "migrate", "decode"):
            self._close_span(fl, name)
        fl.trace.end(outcome="failed", attempts=fl.attempts, error=why)
        fl.future.set_exception(NoReplicaAvailable(
            f"disagg request {fl.fid} failed after {fl.attempts} "
            f"attempts (last: {why})"))
        return False

    def _settle(self, fl: _Flight, res: dict) -> None:
        tokens = [int(t) for t in res["tokens"]]
        self._relay(fl, tokens)
        del self._flights[fl.fid]
        migrated = fl.t_prefill_done is not None
        _m_requests.labels(outcome="finished").inc()
        mig_transport._m_migrations.labels(
            outcome="completed" if migrated else "prefill_only").inc()
        metrics = dict(res.get("metrics") or {})
        metrics["disagg_attempts"] = fl.attempts
        metrics["migrated"] = migrated
        metrics["mig_id"] = fl.mig_id
        for name in ("prefill", "migrate", "decode"):
            self._close_span(fl, name)
        fl.trace.end(outcome="finished",
                     finish_reason=res.get("finish_reason"),
                     attempts=fl.attempts, migrated=migrated)
        if self.cfg.cleanup and fl.mig_id is not None:
            mig_transport.delete_migration(self.kv, fl.mig_id)
        fl.future.set_result(RequestResult(
            req_id=fl.fid, prompt=fl.prompt, tokens=tokens,
            metrics=metrics))

    # -- shared helpers --------------------------------------------------
    def _relay(self, fl: _Flight, tokens: list) -> None:
        if fl.stream_cb is not None:
            for t in tokens[fl.delivered:]:
                fl.stream_cb(fl.fid, int(t))
        fl.delivered = max(fl.delivered, len(tokens))

    def _close_span(self, fl: _Flight, name: str) -> None:
        sp = fl.spans.pop(name, None)
        if sp is not None:
            sp.end()
            fl.spans["_prev"] = sp

    def _signals(self) -> dict:
        return {rep.replica_id: rep.signals() for rep in self.replicas}

    def _outstanding(self) -> dict:
        out: dict[str, int] = {}
        for other in self._flights.values():
            if other.replica is not None:
                rid = other.replica.replica_id
                out[rid] = out.get(rid, 0) + 1
        return out

    def _dead_for_grace(self, rid: str, now: float) -> bool:
        since = self._unhealthy_since.get(rid)
        return (since is not None
                and now - since >= self.cfg.failover_grace_s)

    @staticmethod
    def _eligible(sig: dict) -> bool:
        return sig["alive"] and not sig["stale"] and sig["ready"]

    def _refresh_pools(self, sigs: dict) -> None:
        for pool, members in (("prefill", self.prefill_pool),
                              ("decode", self.decode_pool)):
            n = sum(1 for r in members
                    if self._eligible(sigs[r.replica_id]))
            _m_pool_replicas.labels(pool=pool).set(float(n))

    def _sample_flight_gauge(self) -> None:
        counts = {"queued": 0, "prefilling": 0, "migrating": 0,
                  "decoding": 0}
        for fl in self._flights.values():
            counts[fl.state] = counts.get(fl.state, 0) + 1
        for state, n in counts.items():
            _m_flights.labels(state=state).set(float(n))
