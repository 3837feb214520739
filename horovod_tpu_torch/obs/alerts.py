"""Declarative alerting over the time-series tier.

A copy of the JAX package's ``obs/alerts.py`` for the port.

``HVDTPU_ALERTS`` holds semicolon-separated rules in the same
shell-friendly grammar as ``HVDTPU_SLO``::

    HVDTPU_ALERTS="queue: avg_over_time(hvd_serving_queue_depth[1m]) > 8 for 30s : warn; \
                   burn: max_over_time(hvd_slo_burn_rate[5m]) >= 14.4 : page"

Each rule is ``name: <query-expr> <op> <threshold> [for <hold>] [:
severity]`` — the expression is any :mod:`.tsdb` query
(``rate``/``avg_over_time``/``max_over_time``/``min_over_time``/
``increase``/``quantile``/``forecast``/instant), the operator one of
``> >= < <= == !=``, the optional ``for`` clause a hold duration
(``30s``/``2m``/``1h``) the breach must sustain before firing, and the
trailing severity one of ``info|warn|crit|page`` (default ``warn``).

The :class:`AlertEngine` evaluates every rule against the local tsdb
store each tick and runs the Prometheus-style state machine per rule:
``inactive -> pending`` on first breach, ``pending -> firing`` once the
breach has held ``for`` seconds (straight to firing when the hold is 0),
``pending -> inactive`` if it clears early (a flap never fires), and
``firing -> inactive`` on clear with an ``alert_resolved`` event.  The
clock is injectable so the lifecycle is deterministic under a fake
clock.  Firing state is published as ``hvd_alerts_firing{alert,
severity}`` gauges, which ride the ordinary snapshot path — rank-labeled
on ``/cluster`` like every other per-rank sample — and transitions land
in the flight recorder, so a postmortem bundle shows which alerts were
live when the job died.  ``/alertz`` on the metrics server renders
:func:`status`.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from . import tsdb
from .registry import REGISTRY
from .tsdb import QueryError

SEVERITIES = ("info", "warn", "crit", "page")

_m_firing = REGISTRY.gauge(
    "hvd_alerts_firing",
    "1 while the alert rule is firing (0 pending/inactive)",
    ("alert", "severity"))
_m_fired = REGISTRY.counter(
    "hvd_alerts_fired_total", "pending->firing transitions", ("alert",))
_m_value = REGISTRY.gauge(
    "hvd_alert_value", "last evaluated value per alert rule", ("alert",))

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
}
_UNIT_S = {"s": 1.0, "m": 60.0, "h": 3600.0}

_RULE_RE = re.compile(
    r"^(?P<expr>.+?)\s*(?P<op>>=|<=|==|!=|>|<)\s*"
    r"(?P<thr>-?\d+(?:\.\d+)?(?:e-?\d+)?)"
    r"(?:\s+for\s+(?P<hold>\d+(?:\.\d+)?)\s*(?P<unit>[smh]))?\s*$",
    re.IGNORECASE)


@dataclass
class AlertRule:
    name: str
    expr: str
    plan: dict = field(repr=False)
    op: str = ">"
    threshold: float = 0.0
    for_s: float = 0.0
    severity: str = "warn"

    def breaches(self, value: float) -> bool:
        return _OPS[self.op](value, self.threshold)


def parse_rules(spec: str) -> List[AlertRule]:
    """Parse an ``HVDTPU_ALERTS`` value.  Raises :class:`QueryError`
    with the offending fragment on any malformed rule — bad alert specs
    fail loudly at arm time, not silently at 3am."""
    rules: List[AlertRule] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, rest = part.partition(":")
        if not sep or "(" in name or "[" in name:
            raise QueryError(
                f"alert rule {part!r} needs a 'name:' prefix")
        name = name.strip()
        if not re.match(r"^[\w.-]+$", name):
            raise QueryError(f"bad alert name {name!r}")
        # trailing ": severity" — split from the right so expressions
        # containing ':' (metric names may) stay intact
        severity = "warn"
        head, sep2, tail = rest.rpartition(":")
        if sep2 and tail.strip().lower() in SEVERITIES:
            severity = tail.strip().lower()
            rest = head
        m = _RULE_RE.match(rest.strip())
        if not m:
            raise QueryError(
                f"cannot parse alert rule {part!r} (want 'name: expr "
                f"OP value [for 30s] [: severity]')")
        plan = tsdb.parse_expr(m.group("expr"))   # validate eagerly
        hold = (float(m.group("hold")) * _UNIT_S[m.group("unit").lower()]
                if m.group("hold") else 0.0)
        if any(r.name == name for r in rules):
            raise QueryError(f"duplicate alert name {name!r}")
        rules.append(AlertRule(
            name=name, expr=m.group("expr").strip(), plan=plan,
            op=m.group("op"), threshold=float(m.group("thr")),
            for_s=hold, severity=severity))
    return rules


class _RuleState:
    __slots__ = ("state", "since", "value", "fired", "resolved")

    def __init__(self) -> None:
        self.state = "inactive"     # inactive | pending | firing
        self.since: Optional[float] = None
        self.value: Optional[float] = None
        self.fired = 0
        self.resolved = 0


class AlertEngine:
    """Evaluate rules against a store; deterministic given a clock.

    Drive with explicit ``tick(now)`` in tests or :meth:`start` a daemon
    thread in production (armed from ``hvd.init()`` when
    ``HVDTPU_ALERTS`` is set).
    """

    def __init__(self, rules: List[AlertRule], *,
                 store: Optional[tsdb.SeriesStore] = None,
                 tick_s: float = 5.0,
                 clock: Callable[[], float] = time.time) -> None:
        self.rules = list(rules)
        self._store = store
        self._tick_s = max(0.1, float(tick_s))
        self._clock = clock
        self._states = {r.name: _RuleState() for r in self.rules}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for r in self.rules:    # series exist from t0, visible on /cluster
            _m_firing.labels(alert=r.name, severity=r.severity).set(0)

    def _eval(self, rule: AlertRule, store, now: float):
        """Worst value across the expression's series, oriented by the
        comparison: ``>``/``>=`` alert on the max series, ``<``/``<=``
        on the min (one bad rank fires a fleet-wide rule either way)."""
        result = tsdb.eval_expr(store, dict(rule.plan), now=now)
        values = [s["value"] for s in result["series"]]
        if not values:
            return None
        if rule.op in ("<", "<="):
            return min(values)
        return max(values)

    def tick(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        store = self._store if self._store is not None \
            else tsdb.local_store()
        if store is None:
            return
        with self._lock:
            for rule in self.rules:
                st = self._states[rule.name]
                try:
                    value = self._eval(rule, store, now)
                except QueryError:
                    value = None
                st.value = value
                if value is not None:
                    _m_value.labels(alert=rule.name).set(value)
                breach = value is not None and rule.breaches(value)
                self._step(rule, st, breach, now)

    def _step(self, rule: AlertRule, st: _RuleState,
              breach: bool, now: float) -> None:
        from . import flightrec as _frec
        if st.state == "inactive":
            if breach:
                st.state, st.since = "pending", now
                if rule.for_s <= 0:
                    self._fire(rule, st, now)
        elif st.state == "pending":
            if not breach:
                st.state, st.since = "inactive", None   # flap: never fired
            elif now - st.since >= rule.for_s:
                self._fire(rule, st, now)
        elif st.state == "firing":
            if not breach:
                st.state, st.since = "inactive", None
                st.resolved += 1
                _m_firing.labels(alert=rule.name,
                                 severity=rule.severity).set(0)
                _frec.RECORDER.record(
                    "alert_resolved", name=rule.name,
                    severity=rule.severity, value=st.value)

    def _fire(self, rule: AlertRule, st: _RuleState, now: float) -> None:
        from . import flightrec as _frec
        st.state = "firing"
        st.fired += 1
        _m_fired.labels(alert=rule.name).inc()
        _m_firing.labels(alert=rule.name, severity=rule.severity).set(1)
        _frec.RECORDER.record(
            "alert_fired", name=rule.name, severity=rule.severity,
            value=st.value, expr=rule.expr, threshold=rule.threshold)

    def status(self, now: Optional[float] = None) -> dict:
        """The /alertz payload."""
        now = self._clock() if now is None else now
        with self._lock:
            alerts = []
            for rule in self.rules:
                st = self._states[rule.name]
                alerts.append({
                    "alert": rule.name,
                    "severity": rule.severity,
                    "state": st.state,
                    "expr": rule.expr,
                    "op": rule.op,
                    "threshold": rule.threshold,
                    "for_s": rule.for_s,
                    "value": st.value,
                    "since_s": (round(now - st.since, 3)
                                if st.since is not None else None),
                    "fired_total": st.fired,
                    "resolved_total": st.resolved,
                })
        return {"now": round(now, 3),
                "firing": sum(1 for a in alerts if a["state"] == "firing"),
                "alerts": alerts}

    # -- daemon -----------------------------------------------------------
    def start(self) -> "AlertEngine":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:
                    from ..utils import logging as hvd_logging
                    hvd_logging.get_logger().exception(
                        "alert engine tick failed")
                self._stop.wait(self._tick_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="hvdtpu-alerts")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def render_text(payload: dict) -> str:
    lines = [f"alerts: {payload['firing']} firing / "
             f"{len(payload['alerts'])} rules"]
    for a in payload["alerts"]:
        val = "n/a" if a["value"] is None else f"{a['value']:g}"
        hold = f" for {a['for_s']:g}s" if a["for_s"] else ""
        since = (f" since {a['since_s']:g}s"
                 if a["since_s"] is not None else "")
        lines.append(
            f"[{a['state']:>8}] {a['alert']} ({a['severity']}): "
            f"{a['expr']} {a['op']} {a['threshold']:g}{hold} "
            f"| value={val}{since}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# process-wide wiring
# ---------------------------------------------------------------------------

_engine: Optional[AlertEngine] = None
_wiring_lock = threading.Lock()


def arm(spec: str, *, tick_s: Optional[float] = None,
        store: Optional[tsdb.SeriesStore] = None) -> Optional[AlertEngine]:
    """Parse ``spec`` and start the process-wide engine over the local
    tsdb store (arming the tsdb first if it isn't).  Empty spec disarms.
    Re-entrant across elastic re-inits."""
    global _engine
    with _wiring_lock:
        if _engine is not None:
            _engine.stop()
            _engine = None
        if not (spec or "").strip():
            return None
        rules = parse_rules(spec)
        if store is None and tsdb.local_store() is None:
            tsdb.arm()      # alerts imply the time-series tier
        if tick_s is None:
            st = store or tsdb.local_store()
            tick_s = st.interval_s if st is not None else 5.0
        _engine = AlertEngine(rules, store=store, tick_s=tick_s).start()
        return _engine


def disarm() -> None:
    global _engine
    with _wiring_lock:
        if _engine is not None:
            _engine.stop()
            _engine = None


def engine() -> Optional[AlertEngine]:
    with _wiring_lock:
        return _engine


def status() -> Optional[dict]:
    eng = engine()
    return eng.status() if eng is not None else None
