"""Scaling policy: a pure decision function over cluster signals.

A copy of ``horovod_tpu/autoscale/policy.py``.

No I/O, no sleeps, no globals — ``ScalePolicy.decide(signals)`` maps the
current signal vector to a target world size.  Everything time-dependent
(the two cooldowns) runs off an injectable monotonic clock, so the whole
decision surface unit-tests synchronously.

Decision rules (in order):

1. **Frozen signals are a no-op.**  A stale ``/cluster`` view (dead
   aggregator, wedged publishers) says nothing about load; acting on it
   would scale on noise.  ``signal_age_s > stale_after_s`` => hold.
2. **Capacity clamps the target** (blacklist-aware): the policy never
   targets more than the non-blacklisted slots discovery reports, nor
   less than ``min_np``, nor more than ``max_np``.
3. **Scale up** when there is load pressure: per-rank queue depth at or
   above ``queue_high``, OR the SLO error budget is burning on BOTH
   windows (``burn_fast`` AND ``burn_slow`` above ``burn_threshold`` —
   the Google-SRE multi-window gate: the fast window alone is noise, the
   slow window alone is stale history).  Gated by the scale-up cooldown.
4. **Scale down** when the job is demonstrably idle: queue depth at or
   below ``queue_low`` AND both burn rates under threshold AND no
   straggler in flight (a stall makes the idle reading unreliable).
   Gated by the (longer) scale-down cooldown; shrinks by
   ``shrink_divisor`` per decision, never below ``min_np``.
5. **Predictive scale-up** (``forecast_horizon_s > 0``): when the robust
   linear trend over the queue-depth history says ``queue_high`` will be
   crossed within the lookahead, grow *before* the instantaneous
   threshold trips (``action="grow_predicted"``) — capacity lands ahead
   of the load.  Shares the scale-up cooldown; a ramping queue also
   vetoes the idle shrink.
6. **Between ``queue_low`` and ``queue_high`` nothing happens** — the
   hysteresis band that keeps a borderline load from flapping the mesh.

Both cooldowns also gate the FIRST decision: policy construction stamps
the clock, so a freshly launched job gets a warmup grace — a worker
busy compiling reads as idle, and shrinking it on the first poll would
punish every cold start.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Knobs; surfaced as ``HVDTPU_AUTOSCALE_*`` (see config.py)."""

    min_np: int = 1
    max_np: int = 1 << 30
    #: per-rank engine queue depth at/above which load is "high".
    queue_high: float = 8.0
    #: ... at/below which load is "low"; between the two: hold.
    queue_low: float = 1.0
    #: burn > this on BOTH windows (fast AND slow) = SLO pressure.
    burn_threshold: float = 1.0
    scale_up_cooldown_s: float = 30.0
    scale_down_cooldown_s: float = 120.0
    #: freshest rank snapshot older than this => signals frozen, hold.
    stale_after_s: float = 10.0
    #: voluntary shrink halves by default (np -> np // 2).
    shrink_divisor: int = 2
    #: predictive scaling lookahead: grow when the forecast queue depth
    #: this many seconds ahead crosses ``queue_high`` even though the
    #: instantaneous reading hasn't.  0 = reactive only.  Shares the
    #: scale-up cooldown; hysteresis unchanged.
    forecast_horizon_s: float = 0.0


@dataclasses.dataclass
class Signals:
    """One poll's view of the cluster (see controller.signals_from_families)."""

    current_np: int
    #: non-blacklisted slots discovery reports (the driver's view).
    available_slots: int
    #: max per-rank ``hvd_engine_queue_depth`` over fresh ranks.
    queue_depth: float = 0.0
    #: ranks with a nonzero straggler gauge.
    stragglers: int = 0
    #: max ``hvd_slo_burn_rate{window="5m"}`` over fresh ranks/SLOs.
    burn_fast: float = 0.0
    #: max ``hvd_slo_burn_rate{window="1h"}`` over fresh ranks/SLOs.
    burn_slow: float = 0.0
    #: age of the FRESHEST rank snapshot; inf when nobody reports.
    signal_age_s: float = 0.0
    #: robust linear-trend forecast of queue depth ``forecast_horizon_s``
    #: ahead (None = no history / forecasting off).
    queue_forecast: "float | None" = None
    #: same forecast for the fast-window SLO burn rate.
    burn_forecast: "float | None" = None


@dataclasses.dataclass(frozen=True)
class Decision:
    target_np: int
    action: str    # "grow" | "grow_predicted" | "shrink" | "hold"
    reason: str


class ScalePolicy:
    """Stateful only in its cooldown stamps; everything else is pure."""

    def __init__(self, config: PolicyConfig, *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.config = config
        self._clock = clock
        # Construction counts as the most recent scale event in BOTH
        # directions: a job warming up (compiling, loading data) reads
        # as idle, and without this grace the first poll would shrink
        # it seconds after launch.
        self._last_up = self._last_down = clock()

    def decide(self, s: Signals) -> Decision:
        cfg = self.config
        now = self._clock()
        if s.signal_age_s > cfg.stale_after_s:
            return Decision(s.current_np, "hold",
                            f"signals stale ({s.signal_age_s:.1f}s > "
                            f"{cfg.stale_after_s:.0f}s)")
        # Blacklist-aware clamp: discovery minus blacklisted hosts is
        # what available_slots already reflects.
        cap = max(cfg.min_np, min(cfg.max_np, s.available_slots))
        burning = (s.burn_fast > cfg.burn_threshold
                   and s.burn_slow > cfg.burn_threshold)
        pressure = s.queue_depth >= cfg.queue_high or burning
        idle = (s.queue_depth <= cfg.queue_low and not burning
                and s.burn_fast <= cfg.burn_threshold
                and s.burn_slow <= cfg.burn_threshold)

        if pressure:
            target = cap
            if target > s.current_np:
                if now - self._last_up < cfg.scale_up_cooldown_s:
                    return Decision(
                        s.current_np, "hold",
                        "scale-up cooldown "
                        f"({now - self._last_up:.1f}s of "
                        f"{cfg.scale_up_cooldown_s:.0f}s)")
                self._last_up = now
                why = ("burn-rate fast+slow over threshold" if burning
                       else f"queue depth {s.queue_depth:.1f} >= "
                            f"{cfg.queue_high:.1f}")
                return Decision(target, "grow", why)
            return Decision(s.current_np, "hold",
                            "pressure but at capacity "
                            f"(np={s.current_np}, cap={cap})")

        # Predictive scale-up: the robust trend over the queue-depth
        # series says the high threshold will be crossed within the
        # lookahead — grow now so the capacity lands before the load
        # does, not after.  Same cooldown stamp as a reactive grow (one
        # scale-up per cooldown, whoever triggers it); a ramping queue
        # also vetoes the idle shrink below by construction (this branch
        # returns first).
        predicted = (cfg.forecast_horizon_s > 0
                     and s.queue_forecast is not None
                     and s.queue_forecast >= cfg.queue_high)
        if predicted:
            target = cap
            if target > s.current_np:
                if now - self._last_up < cfg.scale_up_cooldown_s:
                    return Decision(
                        s.current_np, "hold",
                        "scale-up cooldown (predicted breach waiting "
                        f"{now - self._last_up:.1f}s of "
                        f"{cfg.scale_up_cooldown_s:.0f}s)")
                self._last_up = now
                return Decision(
                    target, "grow_predicted",
                    f"queue forecast {s.queue_forecast:.1f} >= "
                    f"{cfg.queue_high:.1f} within "
                    f"{cfg.forecast_horizon_s:.0f}s "
                    f"(now {s.queue_depth:.1f})")
            return Decision(s.current_np, "hold",
                            "predicted pressure but at capacity "
                            f"(np={s.current_np}, cap={cap})")

        if idle:
            target = max(cfg.min_np, min(
                cap, s.current_np // max(1, cfg.shrink_divisor)))
            if target < s.current_np:
                if s.stragglers:
                    return Decision(
                        s.current_np, "hold",
                        f"{s.stragglers} straggler(s) in flight — idle "
                        "reading unreliable, not shrinking")
                if now - self._last_down < cfg.scale_down_cooldown_s:
                    return Decision(
                        s.current_np, "hold",
                        "scale-down cooldown "
                        f"({now - self._last_down:.1f}s of "
                        f"{cfg.scale_down_cooldown_s:.0f}s)")
                self._last_down = now
                return Decision(
                    target, "shrink",
                    f"idle (queue {s.queue_depth:.1f} <= "
                    f"{cfg.queue_low:.1f}, burn under threshold)")
            return Decision(s.current_np, "hold", "idle at min")

        # Between the thresholds (or a single burn window firing alone):
        # the hysteresis band — a borderline load must not flap the mesh.
        return Decision(s.current_np, "hold",
                        f"hysteresis band (queue {s.queue_depth:.1f} in "
                        f"({cfg.queue_low:.1f}, {cfg.queue_high:.1f}), "
                        f"burn fast/slow {s.burn_fast:.2f}/"
                        f"{s.burn_slow:.2f})")
