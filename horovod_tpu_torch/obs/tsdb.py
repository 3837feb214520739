"""In-memory time-series tier: bounded history over the metrics registry.

A copy of the JAX package's ``obs/tsdb.py`` for the port, whole.

Every other observability tier — ``/metrics``, ``/cluster`` merges, SLO
burn, ``hvd_perf_efficiency`` — is a point-in-time snapshot; nothing can
answer "what did queue depth do over the last ten minutes", and the
autoscaler can only *react* to burn.  This module retains history, with
memory bounded by construction:

- a :class:`SeriesStore` holds one bounded series per (family, label
  set): a **raw ring** at the sample cadence (``HVDTPU_TSDB_INTERVAL``,
  default 5s; ~10 min retention by default) and a **downsampled ring**
  of 60s buckets (~2h) carrying last/min/max/sum/count per bucket, so
  long-window queries stay cheap and short-window queries stay exact;
- counters are stored cumulatively and differentiated on read with
  **reset-aware** ``rate()`` (a restart's counter drop contributes the
  post-reset value, the Prometheus ``increase`` convention); gauges are
  stored as-is; histograms keep a ring of cumulative bucket snapshots
  (the :class:`.slo._HistHistory` pattern) for windowed
  ``quantile()``, plus ``<name>_count`` / ``<name>_sum`` scalar series;
- a :class:`TsdbSampler` daemon samples the process registry at the
  interval (armed from ``hvd.init()``); any process that aggregates
  ``/cluster`` additionally appends each merged snapshot into a
  fleet-level **cluster store** (rank-labeled series), so rank 0 can
  answer longitudinal questions about the whole job;
- a small query layer — ``rate(m{label="x"}[1m])``, ``avg_over_time``,
  ``max_over_time``, ``min_over_time``, ``quantile(0.99, h[5m])``,
  ``forecast(m[5m], 60)`` and bare instant selectors — served as
  ``GET /query?expr=...`` on the existing :mod:`.server`
  endpoint (text / ``.json`` / ``.csv``);
- :func:`forecast_points` is the robust linear trend (Theil–Sen) the
  reference's autoscaler feeds on (the port's comes with ROADMAP section
  A 'Elastic and autoscale').

Stdlib-only, like the rest of ``obs``; never imports torch.
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional, Sequence

from .registry import REGISTRY, MetricRegistry

#: default seconds between registry samples (env HVDTPU_TSDB_INTERVAL).
DEFAULT_INTERVAL_S = 5.0
#: default raw-ring retention (env HVDTPU_TSDB_RETENTION).
DEFAULT_RETENTION_S = 600.0
#: downsampled-ring resolution and retention (fixed: one series costs
#: raw_len + ds_len small tuples, bounded whatever the process does).
DS_RESOLUTION_S = 60.0
DS_RETENTION_S = 7200.0
#: hard cap on distinct series per store; later series are dropped and
#: counted, never grown unboundedly (label-cardinality blowups included).
DEFAULT_MAX_SERIES = 2048
#: two ingests closer than this collapse into one sample (a driver that
#: both aggregates and autoscales must not double-count a tick).
MIN_STEP_S = 0.05

_m_samples = REGISTRY.counter(
    "hvd_tsdb_samples_total", "points appended into tsdb rings")
_m_dropped = REGISTRY.counter(
    "hvd_tsdb_series_dropped_total",
    "series rejected by the per-store series cap")
_m_series = REGISTRY.gauge(
    "hvd_tsdb_series", "live series per store", ("store",))


class QueryError(ValueError):
    """Unparseable /query expression or unsuitable series."""


# ---------------------------------------------------------------------------
# series
# ---------------------------------------------------------------------------

class _ScalarSeries:
    """Two-resolution ring for one counter/gauge child.

    Raw ring: ``(t, v)`` at the sample cadence.  Downsampled ring: one
    ``[bucket_last_t, last, min, max, sum, n]`` row per 60s bucket,
    finalized when the next bucket opens — so a window wider than the
    raw retention still has last/extremes/mean per minute.
    """

    __slots__ = ("kind", "raw", "ds", "_open")

    def __init__(self, kind: str, raw_len: int, ds_len: int) -> None:
        self.kind = kind
        self.raw: deque = deque(maxlen=raw_len)
        self.ds: deque = deque(maxlen=ds_len)
        self._open: Optional[list] = None   # current ds bucket

    def append(self, t: float, v: float) -> None:
        if self.raw and t - self.raw[-1][0] < MIN_STEP_S:
            return
        self.raw.append((t, v))
        bucket = math.floor(t / DS_RESOLUTION_S)
        if self._open is not None and self._open[0] != bucket:
            self.ds.append(tuple(self._open[1:]))
            self._open = None
        if self._open is None:
            self._open = [bucket, t, v, v, v, v, 1]
        else:
            o = self._open
            o[1], o[2] = t, v
            o[3] = min(o[3], v)
            o[4] = max(o[4], v)
            o[5] += v
            o[6] += 1

    def spans(self, t_from: float, t_to: float) -> list:
        """Per-span aggregates ``(t, last, min, max, sum, n)`` inside the
        window, downsampled rows first where the raw ring no longer
        reaches, raw points (as width-1 spans) after."""
        raw_start = self.raw[0][0] if self.raw else float("inf")
        out = []
        for row in self.ds:
            if t_from <= row[0] < min(t_to, raw_start):
                out.append(row)
        if self._open is not None and \
                t_from <= self._open[1] < min(t_to, raw_start):
            o = self._open
            out.append((o[1], o[2], o[3], o[4], o[5], o[6]))
        for t, v in self.raw:
            if t_from <= t <= t_to:
                out.append((t, v, v, v, v, 1))
        return out

    def points(self, t_from: float, t_to: float) -> list:
        """``(t, value)`` pairs in the window (the forecast input)."""
        return [(s[0], s[1]) for s in self.spans(t_from, t_to)]

    def latest(self) -> Optional[tuple]:
        if self.raw:
            return self.raw[-1]
        if self._open is not None:
            return (self._open[1], self._open[2])
        return self.ds[-1][:2] if self.ds else None

    def n_points(self) -> int:
        return len(self.raw) + len(self.ds) + (self._open is not None)


class _HistSeries:
    """Ring of cumulative bucket snapshots for one histogram child —
    the :class:`.slo._HistHistory` pattern, count-bounded
    here (no downsampled tier: bucket vectors are wide, the raw window
    is the quantile use case)."""

    __slots__ = ("edges", "snaps")

    def __init__(self, edges: Sequence[float], raw_len: int) -> None:
        self.edges = tuple(edges)
        self.snaps: deque = deque(maxlen=raw_len)

    def append(self, t: float, cum: Sequence[int]) -> None:
        if self.snaps and t - self.snaps[-1][0] < MIN_STEP_S:
            return
        self.snaps.append((t, tuple(cum)))

    def delta_since(self, t_from: float) -> Optional[list]:
        if not self.snaps:
            return None
        base = self.snaps[0]
        for snap in self.snaps:
            if snap[0] <= t_from:
                base = snap
            else:
                break
        now = self.snaps[-1]
        # Reset-aware: a restarted process's counts drop below the base;
        # the post-reset snapshot alone is then the window's traffic.
        delta = [n - b for n, b in zip(now[1], base[1])]
        if any(d < 0 for d in delta):
            delta = list(now[1])
        return delta

    def n_points(self) -> int:
        return len(self.snaps)


# ---------------------------------------------------------------------------
# reset-aware rate / robust forecast (pure functions, unit-tested)
# ---------------------------------------------------------------------------

def increase(points: Sequence[tuple]) -> Optional[float]:
    """Total counter increase over ``[(t, v), ...]``, reset-aware: a
    negative step means the counter restarted, and the post-reset value
    is the increase since (the Prometheus convention).  None with fewer
    than two points (no interval to measure)."""
    if len(points) < 2:
        return None
    total = 0.0
    prev = points[0][1]
    for _, v in points[1:]:
        d = v - prev
        total += v if d < 0 else d
        prev = v
    return total

def rate(points: Sequence[tuple]) -> Optional[float]:
    """Per-second rate of a cumulative counter over its sample span."""
    inc = increase(points)
    if inc is None:
        return None
    dt = points[-1][0] - points[0][0]
    return inc / dt if dt > 0 else None


def forecast_points(points: Sequence[tuple], horizon_s: float,
                    now: Optional[float] = None) -> Optional[float]:
    """Robust linear-trend forecast: value predicted ``horizon_s`` past
    ``now`` (default: the last sample's time).

    Theil–Sen estimator — slope is the median of pairwise slopes,
    intercept the median residual — so a single outlier sample (GC
    pause, scrape hiccup) cannot hijack the trend the autoscaler acts
    on.  Falls back to the last value with <3 points; None when empty.
    """
    pts = list(points)
    if not pts:
        return None
    if len(pts) < 3:
        return pts[-1][1]
    if len(pts) > 200:      # bound the O(n^2) pair sweep
        stride = len(pts) // 200 + 1
        pts = pts[::stride] + ([pts[-1]] if pts[-1] != pts[::stride][-1]
                               else [])
    slopes = []
    for i in range(len(pts)):
        t_i, v_i = pts[i]
        for j in range(i + 1, len(pts)):
            dt = pts[j][0] - t_i
            if dt > 0:
                slopes.append((pts[j][1] - v_i) / dt)
    if not slopes:
        return pts[-1][1]
    slope = _median(slopes)
    intercept = _median([v - slope * t for t, v in pts])
    t_pred = (pts[-1][0] if now is None else now) + float(horizon_s)
    return slope * t_pred + intercept


def _median(vals: list) -> float:
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------

class SeriesStore:
    """Bounded per-series history over registry-shaped snapshots.

    ``ingest(families)`` accepts the exact plain-data shape of
    :meth:`MetricRegistry.snapshot` *and* of
    :func:`.aggregate.merge_snapshots` — the same store
    class backs the per-rank local history and rank 0's fleet history.
    """

    def __init__(self, *, interval_s: float = DEFAULT_INTERVAL_S,
                 retention_s: float = DEFAULT_RETENTION_S,
                 max_series: int = DEFAULT_MAX_SERIES,
                 name: str = "local") -> None:
        self.interval_s = max(0.05, float(interval_s))
        self.retention_s = max(self.interval_s, float(retention_s))
        self.raw_len = max(2, int(round(self.retention_s
                                        / self.interval_s)) + 1)
        self.ds_len = max(2, int(DS_RETENTION_S / DS_RESOLUTION_S))
        self.max_series = int(max_series)
        self.name = name
        self._series: dict = {}     # (name, labelkey) -> series
        self._kinds: dict = {}      # family name -> kind
        self._lock = threading.Lock()

    # -- write ------------------------------------------------------------
    def ingest(self, families: Iterable[dict],
               now: Optional[float] = None) -> int:
        """Append one snapshot; returns points appended."""
        now = time.time() if now is None else float(now)
        n = 0
        with self._lock:
            for fam in families or ():
                kind = fam.get("type")
                name = fam.get("name")
                if not name:
                    continue
                for s in fam.get("samples", ()):
                    labels = s.get("labels") or {}
                    if kind == "histogram":
                        n += self._append_hist(name, labels, s, now)
                    else:
                        try:
                            v = float(s.get("value", 0.0))
                        except (TypeError, ValueError):
                            continue    # "NaN"/"+Inf" strings: skip
                        n += self._append(name, kind or "gauge",
                                          labels, now, v)
        if n:
            _m_samples.inc(n)
        _m_series.labels(store=self.name).set(len(self._series))
        return n

    def _key(self, name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    def _get_or_make(self, key, factory):
        ser = self._series.get(key)
        if ser is None:
            if len(self._series) >= self.max_series:
                _m_dropped.inc()
                return None
            ser = self._series[key] = factory()
        return ser

    def _append(self, name: str, kind: str, labels: dict,
                t: float, v: float) -> int:
        self._kinds.setdefault(name, kind)
        ser = self._get_or_make(
            self._key(name, labels),
            lambda: _ScalarSeries(kind, self.raw_len, self.ds_len))
        if ser is None or not isinstance(ser, _ScalarSeries):
            return 0
        before = len(ser.raw)
        ser.append(t, v)
        return int(len(ser.raw) != before or ser.raw[-1][0] == t)

    def _append_hist(self, name: str, labels: dict, sample: dict,
                     t: float) -> int:
        buckets = sample.get("buckets")
        if not buckets:
            return 0
        edges = tuple(e for e, _ in buckets
                      if isinstance(e, (int, float)) and math.isfinite(e))
        cum = [c for _, c in buckets]
        self._kinds.setdefault(name, "histogram")
        ser = self._get_or_make(
            self._key(name, labels),
            lambda: _HistSeries(edges, self.raw_len))
        if ser is None or not isinstance(ser, _HistSeries) \
                or ser.edges != edges:
            return 0
        ser.append(t, cum)
        n = ser.n_points()
        # Prometheus-convention scalar companions: windowed count/sum
        # rates without touching the bucket ring.
        self._append(name + "_count", "counter", labels, t,
                     float(sample.get("count", cum[-1])))
        self._append(name + "_sum", "counter", labels, t,
                     float(sample.get("sum", 0.0)))
        return int(ser.n_points() >= n)

    # -- read -------------------------------------------------------------
    def select(self, name: str, matchers: Optional[dict] = None) -> list:
        """``[(labels_dict, series), ...]`` for one family, filtered by
        exact label matchers."""
        matchers = matchers or {}
        out = []
        with self._lock:
            for (fam, labelkey), ser in self._series.items():
                if fam != name:
                    continue
                labels = dict(labelkey)
                if all(labels.get(k) == v for k, v in matchers.items()):
                    out.append((labels, ser))
        return out

    def kind_of(self, name: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(name)

    def n_series(self) -> int:
        with self._lock:
            return len(self._series)

    def n_points(self) -> int:
        """Total retained points — the bounded-memory assertion surface:
        never exceeds ``max_series * (raw_len + ds_len + 1)``."""
        with self._lock:
            return sum(s.n_points() for s in self._series.values())

    def flight_tail(self, names: Sequence[str],
                    max_points: int = 24) -> dict:
        """Recent raw tails for a curated metric set — the minutes
        *leading up to* a crash, embedded in flight-recorder bundles."""
        series = []
        with self._lock:
            for (fam, labelkey), ser in self._series.items():
                if fam not in names or not isinstance(ser, _ScalarSeries):
                    continue
                pts = list(ser.raw)[-max_points:]
                if pts:
                    series.append({
                        "name": fam, "labels": dict(labelkey),
                        "points": [[round(t, 3), v] for t, v in pts]})
        return {"interval_s": self.interval_s, "series": series}


# ---------------------------------------------------------------------------
# query language
# ---------------------------------------------------------------------------

#: range-vector functions over scalar series -> how they reduce spans.
_RANGE_FUNCS = ("rate", "increase", "avg_over_time", "max_over_time",
                "min_over_time")

_SELECTOR_RE = re.compile(
    r"^\s*(?P<name>[a-zA-Z_:][\w:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"(?:\[(?P<win>\d+(?:\.\d+)?)(?P<unit>[smh])\])?\s*$")
_LABEL_MATCH_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][\w]*)\s*=\s*"(?P<v>[^"]*)"\s*')
_WINDOW_S = {"s": 1.0, "m": 60.0, "h": 3600.0}


def _parse_selector(text: str, *, need_window: bool):
    m = _SELECTOR_RE.match(text)
    if not m:
        raise QueryError(f"cannot parse selector {text!r}")
    matchers = {}
    if m.group("labels"):
        pos = 0
        raw = m.group("labels")
        while pos < len(raw):
            lm = _LABEL_MATCH_RE.match(raw, pos)
            if not lm:
                raise QueryError(f"bad label matcher in {text!r}")
            matchers[lm.group("k")] = lm.group("v")
            pos = lm.end()
            if pos < len(raw):
                if raw[pos] != ",":
                    raise QueryError(f"bad label matcher in {text!r}")
                pos += 1
    window = (float(m.group("win")) * _WINDOW_S[m.group("unit")]
              if m.group("win") else None)
    if need_window and window is None:
        raise QueryError(
            f"{text!r} needs a range like [1m] for this function")
    if not need_window and window is not None:
        raise QueryError(f"instant selector {text!r} cannot take a range")
    return m.group("name"), matchers, window


def parse_expr(expr: str) -> dict:
    """One query expression -> plan dict (validated; evaluation-ready).

    Forms: ``m``, ``m{l="v"}``, ``rate(m[1m])``, ``increase(m[5m])``,
    ``avg_over_time(m[1m])``, ``max_over_time(m[1m])``,
    ``min_over_time(m[1m])``, ``quantile(0.99, h[5m])``,
    ``forecast(m[5m], 60)``.
    """
    expr = (expr or "").strip()
    m = re.match(r"^(?P<fn>[a-z_]+)\s*\((?P<args>.*)\)\s*$", expr,
                 re.DOTALL)
    if not m:
        name, matchers, _ = _parse_selector(expr, need_window=False)
        return {"fn": "instant", "name": name, "matchers": matchers,
                "expr": expr}
    fn, args = m.group("fn"), m.group("args")
    if fn in _RANGE_FUNCS:
        name, matchers, window = _parse_selector(args, need_window=True)
        return {"fn": fn, "name": name, "matchers": matchers,
                "window_s": window, "expr": expr}
    if fn == "quantile":
        q_txt, _, sel = args.partition(",")
        if not sel:
            raise QueryError("quantile(q, hist[win]) takes two arguments")
        try:
            q = float(q_txt)
        except ValueError:
            raise QueryError(f"bad quantile {q_txt!r}") from None
        if not 0.0 <= q <= 1.0:
            raise QueryError(f"quantile {q} out of [0, 1]")
        name, matchers, window = _parse_selector(sel, need_window=True)
        return {"fn": "quantile", "q": q, "name": name,
                "matchers": matchers, "window_s": window, "expr": expr}
    if fn == "forecast":
        sel, _, hz_txt = args.rpartition(",")
        if not sel:
            raise QueryError(
                "forecast(m[win], horizon_s) takes two arguments")
        try:
            horizon = float(hz_txt)
        except ValueError:
            raise QueryError(f"bad forecast horizon {hz_txt!r}") from None
        name, matchers, window = _parse_selector(sel, need_window=True)
        return {"fn": "forecast", "horizon_s": horizon, "name": name,
                "matchers": matchers, "window_s": window, "expr": expr}
    raise QueryError(
        f"unknown function {fn!r} (have: {', '.join(_RANGE_FUNCS)}, "
        "quantile, forecast, instant selectors)")


def eval_expr(store: SeriesStore, expr,
              now: Optional[float] = None) -> dict:
    """Evaluate a query (string or :func:`parse_expr` plan) against one
    store -> ``{"expr", "now", "series": [{"labels", "value"}, ...]}``.
    Series with no data in the window are omitted (not errors)."""
    plan = parse_expr(expr) if isinstance(expr, str) else expr
    now = time.time() if now is None else float(now)
    fn = plan["fn"]
    series_out = []
    for labels, ser in store.select(plan["name"], plan["matchers"]):
        v: Optional[float]
        if fn == "quantile":
            if not isinstance(ser, _HistSeries):
                raise QueryError(
                    f"{plan['name']} is not a histogram series")
            from . import slo as _slo
            delta = ser.delta_since(now - plan["window_s"])
            v = (None if delta is None
                 else _slo.quantile(ser.edges, delta, plan["q"]))
        elif isinstance(ser, _ScalarSeries):
            if fn == "instant":
                latest = ser.latest()
                v = latest[1] if latest else None
            else:
                t_from = now - plan["window_s"]
                if fn == "forecast":
                    v = forecast_points(ser.points(t_from, now),
                                        plan["horizon_s"], now=now)
                else:
                    spans = ser.spans(t_from, now)
                    if fn == "rate":
                        v = rate([(s[0], s[1]) for s in spans])
                    elif fn == "increase":
                        v = increase([(s[0], s[1]) for s in spans])
                    elif fn == "avg_over_time":
                        n = sum(s[5] for s in spans)
                        v = (sum(s[4] for s in spans) / n) if n else None
                    elif fn == "max_over_time":
                        v = max((s[3] for s in spans), default=None)
                    else:   # min_over_time
                        v = min((s[2] for s in spans), default=None)
        else:
            # histogram ring under a scalar function: the _count/_sum
            # companions are the queryable form
            raise QueryError(
                f"{plan['name']} is a histogram; query "
                f"{plan['name']}_count/_sum or quantile(q, "
                f"{plan['name']}[win])")
        if v is not None:
            series_out.append({"labels": labels, "value": v})
    series_out.sort(key=lambda s: sorted(s["labels"].items()))
    return {"expr": plan.get("expr", ""), "now": round(now, 3),
            "series": series_out}


def render_text(result: dict) -> str:
    """Prometheus-ish one-line-per-series text form of a query result."""
    lines = []
    for s in result["series"]:
        label_txt = ",".join(f'{k}="{v}"'
                             for k, v in sorted(s["labels"].items()))
        lines.append(f"{{{label_txt}}} {s['value']:g}" if label_txt
                     else f"{s['value']:g}")
    return "\n".join(lines) + "\n"


def render_csv(result: dict) -> str:
    lines = ["labels,value"]
    for s in result["series"]:
        label_txt = ";".join(f"{k}={v}"
                             for k, v in sorted(s["labels"].items()))
        lines.append(f'"{label_txt}",{s["value"]:g}')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# sampler daemon
# ---------------------------------------------------------------------------

class TsdbSampler:
    """Samples one registry into one store every ``interval_s``.  Drive
    manually (``tick(now)`` — deterministic tests) or as a daemon
    (:meth:`start`)."""

    def __init__(self, store: SeriesStore, *,
                 registry: Optional[MetricRegistry] = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.store = store
        self.registry = registry or REGISTRY
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self, now: Optional[float] = None) -> int:
        now = self._clock() if now is None else now
        return self.store.ingest(self.registry.snapshot(), now)

    def start(self) -> "TsdbSampler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:   # telemetry never kills the job
                    from ..utils import logging as hvd_logging
                    hvd_logging.get_logger().exception(
                        "tsdb sampler tick failed")
                self._stop.wait(self.store.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="hvdtpu-tsdb")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# process-wide wiring (context.init()/shutdown(); server /query routes)
# ---------------------------------------------------------------------------

#: curated flight-recorder tail: the series a stall/crash bundle should
#: show the minutes leading up to the event for.
FLIGHT_SERIES = ("hvd_engine_queue_depth", "hvd_serving_queue_depth",
                 "hvd_cycle_seconds_count", "hvd_cycle_seconds_sum",
                 "hvd_slo_burn_rate", "hvd_perf_efficiency",
                 "hvd_alerts_firing")

_sampler: Optional[TsdbSampler] = None
_cluster: Optional[SeriesStore] = None
_wiring_lock = threading.Lock()


def interval_from_env() -> float:
    for prefix in ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_"):
        raw = os.environ.get(prefix + "TSDB_INTERVAL")
        if raw:
            try:
                return float(raw)
            except ValueError:
                return DEFAULT_INTERVAL_S
    return DEFAULT_INTERVAL_S


def retention_from_env() -> float:
    for prefix in ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_"):
        raw = os.environ.get(prefix + "TSDB_RETENTION")
        if raw:
            try:
                return float(raw)
            except ValueError:
                return DEFAULT_RETENTION_S
    return DEFAULT_RETENTION_S


def arm(*, interval_s: Optional[float] = None,
        retention_s: Optional[float] = None) -> Optional[TsdbSampler]:
    """Start (or restart) the process-wide sampler + fleet store;
    ``interval_s <= 0`` disarms.  Re-entrant across elastic re-inits."""
    global _sampler, _cluster
    interval_s = interval_from_env() if interval_s is None else interval_s
    retention_s = (retention_from_env() if retention_s is None
                   else retention_s)
    with _wiring_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None
            _cluster = None
        if interval_s is None or interval_s <= 0:
            return None
        store = SeriesStore(interval_s=interval_s,
                            retention_s=retention_s, name="local")
        _cluster = SeriesStore(interval_s=interval_s,
                               retention_s=retention_s, name="cluster")
        _sampler = TsdbSampler(store).start()
        return _sampler


def disarm() -> None:
    global _sampler, _cluster
    with _wiring_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None
        _cluster = None


def local_store() -> Optional[SeriesStore]:
    with _wiring_lock:
        return _sampler.store if _sampler is not None else None


def cluster_store() -> Optional[SeriesStore]:
    with _wiring_lock:
        return _cluster


def sample_now(now: Optional[float] = None) -> int:
    """Force one sampler tick outside the cadence (smoke/tests; also
    handy right before a manual ``hvd.flight_record()``)."""
    with _wiring_lock:
        s = _sampler
    return s.tick(now) if s is not None else 0


def ingest_cluster(families: list) -> None:
    """Append one merged ``/cluster`` snapshot into the fleet history
    (no-op unless the tsdb is armed) — the hook
    :meth:`.aggregate.ClusterAggregator.collect` calls so
    every aggregation this process serves also extends its longitudinal
    fleet view."""
    store = cluster_store()
    if store is not None:
        try:
            store.ingest(families)
        except Exception:   # the scrape must not fail over history
            pass


def query(expr: str, *, source: str = "local",
          now: Optional[float] = None) -> dict:
    """Evaluate ``expr`` against the armed store (the /query route).

    ``source="local"`` is this process's sampled registry history;
    ``source="cluster"`` the fleet history appended per /cluster merge.
    """
    if source not in ("local", "cluster"):
        raise QueryError(f"unknown source {source!r} (local|cluster)")
    store = local_store() if source == "local" else cluster_store()
    if store is None:
        raise QueryError(
            "tsdb not armed on this process (hvd.init() arms it; "
            "HVDTPU_TSDB_INTERVAL<=0 disables)")
    return eval_expr(store, expr, now=now)


def flight_summary() -> dict:
    """The curated raw tail for flight-recorder bundles ({} unarmed)."""
    store = local_store()
    if store is None:
        return {}
    try:
        return store.flight_tail(FLIGHT_SERIES)
    except Exception:
        return {}
