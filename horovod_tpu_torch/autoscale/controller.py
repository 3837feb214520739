"""Autoscale actuator: poll cluster signals, decide, drive rendezvous.

A copy of ``horovod_tpu/autoscale/controller.py``.

Runs inside the elastic DRIVER process (one controller per launch round,
started from the driver's ``services_hook`` so it can reach the job's KV
store).  Each tick it

1. polls discovery through the driver (blacklist-aware capacity),
2. collects the merged ``/cluster`` families from the aggregator
   (``include_local=False`` — the driver is not a rank),
3. distills them into :class:`~horovod_tpu_torch.autoscale.policy.Signals`,
4. asks the policy, records the decision (``hvd_autoscale_*`` gauges and
   counters + a flight-recorder event on every action transition), and
5. acts: grow and voluntary shrink both set ``driver.target_np`` and
   bump the membership epoch — workers exit at their next commit
   boundary with the reserved restart code (cooperative retirement: the
   last ``state.commit()`` is already durable when they leave) and the
   driver relaunches on the resized assignment.

Anti-flap lives in the policy, not here: the per-direction cooldowns
throttle grow/shrink decisions, so the controller acts on every non-hold
decision it receives.  A bump that lands before a worker baselines its
notifier epoch is absorbed silently — but the gap then persists, the
cooldown lapses, the policy decides grow again, and the next bump takes;
the loop converges without controller-side retry state.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .policy import Decision, PolicyConfig, ScalePolicy, Signals
from ..obs import REGISTRY as _obs
from ..obs import flightrec as _frec
from ..obs import tsdb as _tsdb
from ..utils import logging as hvd_logging

log = hvd_logging.get_logger()

#: labeled by pool so disaggregated serving fleets scale their prefill
#: and decode pools independently; a whole-job controller (the elastic
#: training path) writes the "all" child, and single-child snapshots
#: keep reading ``samples[0]["value"]`` unchanged.
_m_target = _obs.gauge(
    "hvd_autoscale_target_np",
    "world size the autoscale policy currently wants", ("pool",))
_m_current = _obs.gauge(
    "hvd_elastic_current_np",
    "world size of the running assignment")
_m_capacity = _obs.gauge(
    "hvd_autoscale_capacity_np",
    "non-blacklisted slots discovery currently offers")
_m_decisions = _obs.counter(
    "hvd_autoscale_decisions_total",
    "policy decisions by action (hold included: every tick decides)",
    ("action",))
_m_bumps = _obs.counter(
    "hvd_autoscale_rendezvous_bumps_total",
    "membership-epoch bumps issued by the autoscaler")
_m_stale = _obs.counter(
    "hvd_autoscale_stale_polls_total",
    "ticks skipped because every rank snapshot was frozen")


#: queue-depth family names the forecast trends over (the same pair the
#: instantaneous queue signal reads).
_QUEUE_FAMILIES = ("hvd_engine_queue_depth", "hvd_serving_queue_depth")


def _forecast_from_store(store, *, horizon_s: float, fresh: set,
                         pool: Optional[str], now: float):
    """(queue_forecast, burn_forecast) off the controller's history.

    Per matching series, a Theil–Sen trend over a lookback of twice the
    horizon (floored at 60s — a forecast off two points is noise), then
    the max across series: the rank forecast to saturate first is the
    one capacity must land for.  Series from stale ranks don't vote,
    same as the instantaneous signals.
    """
    if store is None or horizon_s <= 0:
        return None, None
    lookback = max(60.0, 2.0 * horizon_s)

    def votes(labels) -> bool:
        r = labels.get("rank")
        if r is None:
            return pool is None
        return str(r) in fresh

    def best(name: str, matchers=None):
        out = None
        for labels, ser in store.select(name, matchers):
            if not votes(labels):
                continue
            pts = ser.points(now - lookback, now)
            v = _tsdb.forecast_points(pts, horizon_s, now=now)
            if v is not None:
                out = v if out is None else max(out, v)
        return out

    queue_fc = None
    for fam in _QUEUE_FAMILIES:
        v = best(fam)
        if v is not None:
            queue_fc = v if queue_fc is None else max(queue_fc, v)
    burn_fc = best("hvd_slo_burn_rate", {"window": "5m"})
    return queue_fc, burn_fc


def signals_from_families(families: list, *, current_np: int,
                          available_slots: int,
                          stale_after_s: float = 10.0,
                          pool: Optional[str] = None,
                          store=None,
                          forecast_horizon_s: float = 0.0,
                          now: Optional[float] = None) -> Signals:
    """Distill a merged ``/cluster`` snapshot into policy inputs.

    Rank-labeled samples from STALE ranks (snapshot age over
    ``stale_after_s``, e.g. the dead members of a previous epoch whose
    blobs linger in the KV store) are excluded — only fresh ranks vote.
    ``signal_age_s`` is the freshest rank's age: the policy goes no-op
    only when *everyone* is frozen, not when one rank lags.

    With ``pool`` set, only ranks whose ``hvd_serving_pool_info`` sample
    carries that pool label vote — a disaggregated fleet runs one
    controller per pool, and a prefill-pool SLO burn must never grow
    the decode pool (or vice versa).  Ranks that publish no pool tag
    (training workers, old replicas) are excluded from a pool-filtered
    view rather than voting in every pool.

    With a ``store`` (the controller's tsdb history of these snapshots)
    and ``forecast_horizon_s > 0``, ``queue_forecast``/``burn_forecast``
    carry the robust linear-trend prediction that many seconds ahead —
    the predictive-grow input (``ScalePolicy`` rule 5).
    """
    ages: dict[str, float] = {}
    pools: dict[str, str] = {}
    for fam in families:
        name = fam.get("name")
        if name == "horovod_tpu_rank_snapshot_age_seconds":
            for s in fam.get("samples", ()):
                r = s.get("labels", {}).get("rank")
                if r is not None:
                    ages[str(r)] = float(s.get("value", 0.0))
        elif name == "hvd_serving_pool_info":
            for s in fam.get("samples", ()):
                labels = s.get("labels", {})
                r, p = labels.get("rank"), labels.get("pool")
                if r is not None and p is not None:
                    pools[str(r)] = str(p)
    fresh = {r for r, a in ages.items() if a <= stale_after_s}
    if pool is not None:
        fresh = {r for r in fresh if pools.get(r) == pool}
        ages = {r: a for r, a in ages.items() if pools.get(r) == pool}
    age = min(ages.values()) if ages else float("inf")

    def fresh_samples(fam):
        for s in fam.get("samples", ()):
            r = s.get("labels", {}).get("rank")
            if r is None:
                # Unranked samples (a driver-local gauge) vote in the
                # whole-job view but not in any pool-filtered one.
                if pool is None:
                    yield s
            elif str(r) in fresh:
                yield s

    queue = 0.0
    stragglers: set = set()
    burn_fast = burn_slow = 0.0
    crit_by_rank: dict[str, float] = {}
    for fam in families:
        name = fam.get("name")
        if name in ("hvd_engine_queue_depth", "hvd_serving_queue_depth"):
            for s in fresh_samples(fam):
                queue = max(queue, float(s.get("value", 0.0)))
        elif name == "horovod_tpu_straggler":
            for s in fresh_samples(fam):
                if float(s.get("value", 0.0)) > 0:
                    stragglers.add(s.get("labels", {}).get("rank"))
        elif name == "hvd_trace_critical_phase_seconds":
            # Critical-path attribution from the fleet trace plane: the
            # per-(phase, rank) self seconds of recently merged traces.
            # The label the gauge is keyed on is the rank the time was
            # SPENT on, so sum per rank.
            for s in fresh_samples(fam):
                r = s.get("labels", {}).get("rank")
                if r is not None:
                    crit_by_rank[str(r)] = (crit_by_rank.get(str(r), 0.0)
                                            + float(s.get("value", 0.0)))
        elif name == "hvd_slo_burn_rate":
            for s in fresh_samples(fam):
                win = s.get("labels", {}).get("window")
                v = float(s.get("value", 0.0))
                if win == "5m":
                    burn_fast = max(burn_fast, v)
                elif win == "1h":
                    burn_slow = max(burn_slow, v)
    # A rank that owns the majority of the fleet's critical-path time is
    # a straggler whether or not the per-rank cycle gauge flagged it —
    # trace attribution sees cross-process waits the local view can't.
    total_crit = sum(crit_by_rank.values())
    if total_crit > 0 and len(crit_by_rank) > 1:
        for r, v in crit_by_rank.items():
            if v > 0.5 * total_crit:
                stragglers.add(r)
    queue_fc, burn_fc = _forecast_from_store(
        store, horizon_s=forecast_horizon_s, fresh=fresh, pool=pool,
        now=time.monotonic() if now is None else now)
    return Signals(current_np=current_np, available_slots=available_slots,
                   queue_depth=queue, stragglers=len(stragglers),
                   burn_fast=burn_fast, burn_slow=burn_slow,
                   signal_age_s=age, queue_forecast=queue_fc,
                   burn_forecast=burn_fc)


class AutoscaleController:
    """One launch round's sense->decide->act thread.

    ``collect`` returns merged snapshot families (a
    :class:`~horovod_tpu_torch.obs.aggregate.ClusterAggregator` bound to the
    job's KV store); ``bump`` signals a membership restart; ``capacity``
    returns the driver's current non-blacklisted slot total.  The driver
    itself is reached only through ``set_target`` so the controller is
    testable with plain fakes.
    """

    def __init__(self, policy: ScalePolicy, *,
                 current_np: int,
                 collect: Callable[[], list],
                 bump: Callable[[], None],
                 capacity: Callable[[], int],
                 set_target: Callable[[int], None] = lambda np: None,
                 prev_np: Optional[int] = None,
                 interval_s: float = 2.0,
                 pool: Optional[str] = None,
                 store: Optional[_tsdb.SeriesStore] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._policy = policy
        self._np = int(current_np)
        self._collect = collect
        self._bump = bump
        self._capacity = capacity
        self._set_target = set_target
        self._prev_np = prev_np
        self._interval = interval_s
        self._pool = pool
        self._m_target = _m_target.labels(pool=pool or "all")
        self._clock = clock
        # The controller keeps its own bounded history of every /cluster
        # snapshot it collects (timestamps on ITS clock, so ingest and
        # forecast eval agree) — predictive scaling works on the driver
        # even when the process-wide tsdb tier isn't armed there.
        self._store = store if store is not None else _tsdb.SeriesStore(
            interval_s=max(0.05, interval_s), name="autoscale")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_recorded: Optional[tuple] = None
        self.decisions: list[Decision] = []

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "AutoscaleController":
        _m_current.set(self._np)
        self._m_target.set(self._np)
        if self._prev_np is not None and self._np < self._prev_np:
            # The shrink already happened (preempted/blacklisted host —
            # the driver relaunched us smaller); account for it as a
            # decision so the closed loop's history is complete.
            self._record(Decision(
                self._np, "shrink",
                f"capacity loss: relaunched at np={self._np} "
                f"(was {self._prev_np})"))
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="hvdtpu-autoscale")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- one tick ---------------------------------------------------------
    def poll_once(self) -> Decision:
        cap = self._capacity()
        _m_capacity.set(cap)
        try:
            families = self._collect()
        except Exception as e:
            log.warning("autoscale: aggregator collect failed: %s", e)
            families = []
        now = self._clock()
        try:
            self._store.ingest(families, now)
        except Exception as e:
            log.warning("autoscale: tsdb ingest failed: %s", e)
        sig = signals_from_families(
            families, current_np=self._np, available_slots=cap,
            stale_after_s=self._policy.config.stale_after_s,
            pool=self._pool, store=self._store,
            forecast_horizon_s=self._policy.config.forecast_horizon_s,
            now=now)
        decision = self._policy.decide(sig)
        if sig.signal_age_s == float("inf"):
            _m_stale.inc()
        self._record(decision)
        self._act(decision)
        return decision

    def _record(self, d: Decision) -> None:
        self.decisions.append(d)
        _m_decisions.labels(action=d.action).inc()
        self._m_target.set(d.target_np if d.action != "hold"
                           else max(self._np, _read_gauge(self._m_target)))
        key = (d.action, d.target_np)
        if key != self._last_recorded:
            self._last_recorded = key
            _frec.RECORDER.record("autoscale_decision", name=d.action,
                                  target_np=d.target_np,
                                  current_np=self._np, reason=d.reason)
            if d.action != "hold":
                log.warning("autoscale: %s -> np=%d (%s)",
                            d.action, d.target_np, d.reason)

    def _act(self, d: Decision) -> None:
        # The policy's cooldowns are the rate limit; every non-hold
        # decision that actually changes np gets acted on.  If a bump is
        # absorbed (worker not yet baselined), the gap persists, the
        # cooldown lapses, and the policy re-decides — retry for free.
        if ((d.action in ("grow", "grow_predicted")
             and d.target_np > self._np)
                or (d.action == "shrink" and d.target_np < self._np)):
            self._set_target(d.target_np)
            self._bump_safe(d)

    def _bump_safe(self, d: Decision) -> None:
        try:
            self._bump()
            _m_bumps.inc()
            log.info("autoscale: bumped membership epoch for %s to "
                     "np=%d (%s)", d.action, d.target_np, d.reason)
        except Exception as e:
            log.warning("autoscale: epoch bump failed: %s", e)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except Exception as e:
                log.warning("autoscale: tick failed: %s", e)


def _read_gauge(g) -> float:
    try:
        return float(g.value)
    except Exception:
        return 0.0
