"""Fleet-wide trace plane: per-rank publication, clock-aligned merge,
critical-path attribution.

A copy of the JAX package's ``obs/tracemerge.py`` for the port.  Every
rank of a job the port's launcher starts publishes through the same KV
store as :mod:`.aggregate`; ``hvd.init()`` arms it, and rank 0's
``/tracez`` serves the merged view.

:mod:`.trace` makes one request one trace *within* a
process, and a span context carried across processes
(``Span.context()``, ``start_trace(parent=...)``) keeps the trace_id
connected; but the span records themselves still live in per-process
tables, on per-process clocks.  This module is the collection half:

- every rank periodically publishes its ended-span table (and
  optionally the tail of its Timeline-v2 file) through the job KV store
  under ``fd/trace/<rank>``, the same control plane
  :mod:`.aggregate` already rides;
- the publisher doubles as a **clock echo responder**: the collector
  measures each rank's wall-clock offset with a ping/echo handshake
  over the same KV keys (offset = remote clock at the ping's midpoint),
  so the merged view is clock-aligned instead of trusting NTP;
- ``/tracez`` (rank 0, next to ``/cluster``) serves ONE
  Perfetto-loadable JSON: pid = rank (process_name carries the pool),
  tid = request lane or tensor row, remote span times rebased onto the
  collector's clock, and cross-process **flow arrows** stitching every
  parent→child edge that spans processes, so a handoff between ranks
  renders as one connected chain;
- a **critical-path analyzer** walks each merged trace bottom-up
  (self time = span duration minus time covered by its children) and
  names the dominant (phase, rank) — exported as
  ``hvd_trace_critical_phase_seconds{phase,rank}`` and as a
  "where the p99 went" report an autoscaler reads for straggler
  attribution.

Stdlib-only, like the rest of ``obs``; never imports torch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

from .registry import REGISTRY
from .trace import TRACER
from .aggregate import _kv_from_env

#: KV namespace for the trace plane (blobs at ``fd/trace/<rank>``,
#: clock handshake at ``fd/trace/ping|echo/<rank>``).
TRACE_PREFIX = "fd/trace/"

#: publish cadence default (same as the metrics snapshot plane)
DEFAULT_PUBLISH_INTERVAL_S = 2.0

#: how many trailing timeline events ride one publication
DEFAULT_TAIL_EVENTS = 2000

#: flow-arrow id namespace per rank in the merged output, far above any
#: per-process Timeline counter (mirrors utils.timeline's stride).
_FLOW_ID_STRIDE = 1 << 24

_m_publishes = REGISTRY.counter(
    "hvd_trace_publishes_total", "per-rank trace-blob publications",
    ("outcome",))
_m_collects = REGISTRY.counter(
    "hvd_trace_collects_total", "fleet trace merges served (/tracez)")
_m_crit = REGISTRY.gauge(
    "hvd_trace_critical_phase_seconds",
    "critical-path self time attributed to (phase, rank) across the "
    "traces in the latest merged fleet view", ("phase", "rank"))


# ---------------------------------------------------------------------------
# per-rank publication
# ---------------------------------------------------------------------------

def local_trace_blob(rank: int, *, pool: Optional[str] = None,
                     tracer=None, timeline_path: Optional[str] = None,
                     tail_events: int = DEFAULT_TAIL_EVENTS,
                     interval_s: float = DEFAULT_PUBLISH_INTERVAL_S
                     ) -> bytes:
    """This process's publication unit: every finished trace still in
    the tracer's bounded table, plus the tail of its timeline file when
    one is armed.  A crash-cut timeline tail is fine — the loader
    tolerates a missing closing bracket."""
    tracer = tracer or TRACER
    tail: list = []
    if timeline_path:
        try:
            from ..utils.timeline import load_trace_events
            evs = load_trace_events(timeline_path)
            # Keep metadata (clock_sync anchor, names) unconditionally;
            # bound only the data events.
            meta = [e for e in evs if e.get("ph") == "M"]
            data = [e for e in evs if e.get("ph") != "M"]
            tail = meta + data[-max(0, int(tail_events)):]
        except (OSError, ValueError):
            tail = []
    return json.dumps({
        "rank": int(rank),
        "pool": pool,
        "time": time.time(),
        "interval_s": float(interval_s),
        "traces": tracer.export_all(),
        "timeline_tail": tail,
    }).encode()


def decode_trace_blob(raw: bytes) -> dict:
    blob = json.loads(raw.decode())
    if not isinstance(blob, dict) or "rank" not in blob:
        raise ValueError("not a trace blob")
    blob.setdefault("traces", [])
    blob.setdefault("timeline_tail", [])
    return blob


class TracePublisher:
    """Daemon publisher of this rank's trace blob + clock-echo responder.

    One thread serves both duties: the loop wakes every ``echo_poll_s``
    to answer pending pings (keeping the clock handshake's asymmetry
    small) and republished the blob every ``interval_s``."""

    def __init__(self, rank: int, *, pool: Optional[str] = None,
                 interval_s: float = DEFAULT_PUBLISH_INTERVAL_S,
                 timeline_path: Optional[str] = None,
                 tracer=None, kv_factory: Callable = _kv_from_env,
                 echo_poll_s: float = 0.05) -> None:
        self.rank = int(rank)
        self.pool = pool
        self._interval = max(0.1, float(interval_s))
        self._echo_poll = max(0.005, float(echo_poll_s))
        self._timeline_path = timeline_path
        self._tracer = tracer or TRACER
        self._kv_factory = kv_factory
        self._kv = None
        self._kv_lock = threading.Lock()
        self._stop = threading.Event()
        self._warned = False
        self._last_nonce: Optional[str] = None
        self._thread = threading.Thread(
            target=self._loop, name="hvdtpu-trace-publish", daemon=True)

    def start(self) -> "TracePublisher":
        self._thread.start()
        return self

    def _loop(self) -> None:
        next_pub = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            if now >= next_pub:
                self.publish_now()
                next_pub = now + self._interval
            self.answer_ping()
            self._stop.wait(self._echo_poll)

    def _ensure_kv(self):
        if self._kv is None:
            self._kv = self._kv_factory()
        return self._kv

    def publish_now(self) -> bool:
        """One publish attempt; False (never an exception) on transport
        trouble — tracing must not take the job down."""
        from ..runner.api import kv_put_blob
        blob = local_trace_blob(
            self.rank, pool=self.pool, tracer=self._tracer,
            timeline_path=self._timeline_path,
            interval_s=self._interval)
        with self._kv_lock:
            try:
                if self._ensure_kv() is None:
                    return False
                kv_put_blob(self._kv, f"{TRACE_PREFIX}{self.rank}", blob,
                            deadline_s=max(0.25, self._interval / 2))
                _m_publishes.labels(outcome="ok").inc()
                return True
            except (ConnectionError, OSError, TimeoutError) as e:
                self._drop_kv()
                _m_publishes.labels(outcome="error").inc()
                if not self._warned:
                    self._warned = True
                    from ..utils import logging as hvd_logging
                    hvd_logging.get_logger().warning(
                        "obs: trace publish failed (%s); /tracez will "
                        "miss rank %d until the KV store returns",
                        e, self.rank)
                return False

    def answer_ping(self) -> bool:
        """Answer the collector's pending clock ping, if any: echo our
        wall clock under the ping's nonce.  The collector brackets the
        exchange with its own clock and midpoints the offset."""
        with self._kv_lock:
            try:
                if self._ensure_kv() is None:
                    return False
                raw = self._kv.get(f"{TRACE_PREFIX}ping/{self.rank}")
                if not raw:
                    return False
                ping = json.loads(raw.decode())
                nonce = str(ping.get("nonce"))
                if nonce == self._last_nonce:
                    return False
                self._kv.set(
                    f"{TRACE_PREFIX}echo/{self.rank}",
                    json.dumps({"nonce": nonce,
                                "t_remote_us": time.time() * 1e6}
                               ).encode())
                self._last_nonce = nonce
                return True
            except (ConnectionError, OSError, TimeoutError, ValueError):
                self._drop_kv()
                return False

    def _drop_kv(self) -> None:
        if self._kv is not None:
            try:
                self._kv.close()
            except OSError:
                pass
            self._kv = None

    def stop(self, *, retract: bool = True) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        with self._kv_lock:
            if retract and self._kv is not None:
                try:
                    self._kv.delete(f"{TRACE_PREFIX}{self.rank}/meta")
                except (ConnectionError, OSError):
                    pass
            self._drop_kv()


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------

def estimate_clock_offset(kv, rank: int, *, attempts: int = 3,
                          timeout_s: float = 1.0,
                          poll_s: float = 0.005) -> Optional[float]:
    """Wall-clock offset of ``rank`` relative to this process, in
    microseconds (positive = remote clock ahead), via a ping/echo
    handshake over the KV store.  Of ``attempts`` exchanges the one
    with the smallest round trip wins (its midpoint assumption is the
    least wrong).  None when the rank never echoes (not publishing, or
    an old publisher without the responder).

    Accuracy is bounded by half the echo round trip — the responder
    polls every ~50 ms, so offsets are meaningful for eyeballing
    cross-rank skew in merged traces, not for sub-millisecond claims
    (see docs/observability.md for the caveats)."""
    best_rtt, best_off = None, None
    for i in range(max(1, int(attempts))):
        nonce = f"{int(rank)}-{os.urandom(6).hex()}"
        t0 = time.time() * 1e6
        try:
            kv.set(f"{TRACE_PREFIX}ping/{rank}",
                   json.dumps({"nonce": nonce}).encode())
        except (ConnectionError, OSError, TimeoutError):
            return None
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                raw = kv.get(f"{TRACE_PREFIX}echo/{rank}")
            except (ConnectionError, OSError, TimeoutError):
                return None
            if raw:
                try:
                    echo = json.loads(raw.decode())
                except ValueError:
                    echo = {}
                if echo.get("nonce") == nonce:
                    t1 = time.time() * 1e6
                    rtt = t1 - t0
                    off = float(echo["t_remote_us"]) - (t0 + t1) / 2.0
                    if best_rtt is None or rtt < best_rtt:
                        best_rtt, best_off = rtt, off
                    break
            time.sleep(poll_s)
    return best_off


# ---------------------------------------------------------------------------
# collection + merge
# ---------------------------------------------------------------------------

def collect_trace_blobs(kv, *, timeout_ms: int = 500,
                        max_scan: int = 64) -> dict:
    """Sweep ``fd/trace/<r>`` for published blobs; returns {rank: blob}.
    Missing ranks are simply absent — a merge over a partial fleet is
    still a valid merge (the robustness tests pin this down)."""
    from ..runner.api import kv_get_blob
    out: dict = {}
    for r in range(max(1, int(max_scan))):
        try:
            if kv.get(f"{TRACE_PREFIX}{r}/meta") is None:
                continue
            blob = decode_trace_blob(
                kv_get_blob(kv, f"{TRACE_PREFIX}{r}", timeout_ms=timeout_ms))
        except (ValueError, TimeoutError):
            continue             # mid-rewrite or torn; next collect wins
        if int(blob["rank"]) == r:
            out[r] = blob
    return out


def _tail_epoch_us(tail: list) -> Optional[float]:
    for ev in tail:
        if ev.get("name") == "clock_sync" and ev.get("ph") == "M":
            e = ev.get("args", {}).get("epoch_us")
            if e is not None:
                return float(e)
    return None


def merge_fleet_trace(blobs: dict, *, offsets_us: Optional[dict] = None
                      ) -> dict:
    """One clock-aligned Perfetto JSON over per-rank trace blobs.

    ``blobs`` maps rank -> decoded blob; ``offsets_us`` maps rank -> its
    wall-clock offset relative to the collector (subtracted from every
    remote timestamp, so all ranks land on the collector's axis).
    Returns the Chrome JSON *object* format — ``traceEvents`` plus
    metadata keys (ranks, clock offsets) that Perfetto ignores —
    so one ``/tracez`` fetch is directly loadable.

    Layout: pid = rank (``process_name`` = "rank N [pool]"), tid = one
    row per request lane (span table) or tensor row (timeline tail),
    flow arrows for every parent→child span edge that crosses
    processes.  Events are emitted time-sorted per lane, so a lane read
    top to bottom is monotonic even under corrected skew."""
    offsets = {int(k): float(v)
               for k, v in (offsets_us or {}).items() if v is not None}
    events: list = []
    # (trace_id, span_id) -> placement of the emitted slice, for flow
    # stitching.  Span ids are salted per process (obs.trace), so one
    # key never refers to two slices.
    placed: dict = {}
    pending: list = []            # (child_key, parent_key)
    data_rows: dict = {}          # (pid, tid) -> [event, ...]

    base = None
    for r, blob in sorted(blobs.items()):
        off = offsets.get(int(blob["rank"]), 0.0)
        for tr in blob.get("traces", []):
            try:
                t0 = float(tr["t_start_unix"]) * 1e6 - off
            except (KeyError, TypeError, ValueError):
                continue
            base = t0 if base is None else min(base, t0)
        epoch = _tail_epoch_us(blob.get("timeline_tail", []))
        if epoch is not None:
            base = (epoch - off if base is None
                    else min(base, epoch - off))
    if base is None:
        base = 0.0

    for r, blob in sorted(blobs.items()):
        rank = int(blob["rank"])
        pid = rank
        off = offsets.get(rank, 0.0)
        pool = blob.get("pool")
        pname = f"rank {rank} [{pool}]" if pool else f"rank {rank}"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": pname}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": pid, "tid": 0,
                       "args": {"sort_index": rank}})
        events.append({"name": "clock_sync", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"rank": rank,
                                          "offset_us": round(off, 1)}})

        tids: dict = {}

        def lane_tid(name: str) -> int:
            tid = tids.get(name)
            if tid is None:
                tid = len(tids) + 1
                tids[name] = tid
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tid,
                               "args": {"name": name}})
            return tid

        for tr in blob.get("traces", []):
            tid_val = tr.get("trace_id")
            lane = tr.get("lane") or (
                f"trace:{str(tid_val)[:8]}" if tid_val else "trace")
            try:
                t_start = float(tr["t_start_unix"]) * 1e6 - off
            except (KeyError, TypeError, ValueError):
                continue
            tid = lane_tid(str(lane))
            for sp in tr.get("spans", []):
                try:
                    ts = t_start + float(sp["t_offset_s"]) * 1e6
                    dur = max(0.0, float(sp["duration_s"]) * 1e6)
                except (KeyError, TypeError, ValueError):
                    continue
                args = {"trace_id": tid_val, "span_id": sp.get("span_id"),
                        "rank": rank}
                if sp.get("parent_id"):
                    args["parent_id"] = sp["parent_id"]
                args.update(sp.get("attrs") or {})
                ev = {"name": sp.get("name", "span"), "ph": "X",
                      "pid": pid, "tid": tid,
                      "ts": round(ts - base, 1), "dur": round(dur, 1),
                      "args": args}
                data_rows.setdefault((pid, tid), []).append(ev)
                key = (tid_val, sp.get("span_id"))
                placed[key] = {"pid": pid, "tid": tid,
                               "ts": ts - base, "dur": dur}
                if sp.get("parent_id"):
                    pending.append((key, (tid_val, sp["parent_id"])))

        # Timeline tail: already Chrome events on this rank's monotonic
        # axis; rebase through the clock_sync epoch anchor.  Rows keep
        # their names through the shared lane map, so a tensor row and a
        # request lane can't collide on a tid.
        tail = blob.get("timeline_tail", [])
        epoch = _tail_epoch_us(tail)
        if epoch is None:
            continue
        t_off = (epoch - off) - base
        names = {int(e.get("tid", 0)): str(e.get("args", {}).get("name"))
                 for e in tail
                 if e.get("name") == "thread_name" and e.get("ph") == "M"}
        for ev in tail:
            ph = ev.get("ph")
            if ph == "M" or ev.get("name") == "trace_end":
                continue
            out = dict(ev)
            out["pid"] = pid
            raw_tid = int(ev.get("tid", 0))
            out["tid"] = lane_tid(names.get(raw_tid, f"t{raw_tid}"))
            if "ts" in out:
                try:
                    out["ts"] = round(float(out["ts"]) + t_off, 1)
                except (TypeError, ValueError):
                    continue
            if ph in ("s", "f", "t") and "id" in out:
                out["id"] = int(out["id"]) + (rank + 1) * _FLOW_ID_STRIDE
            data_rows.setdefault((pid, out["tid"]), []).append(out)

    # Cross-process flow arrows: parent slice tail -> child slice head,
    # only when the edge actually crosses a process boundary (intra-
    # process chains already carry their own per-rank arrows).
    fid = 0
    for child_key, parent_key in pending:
        par, chd = placed.get(parent_key), placed.get(child_key)
        if par is None or chd is None or par["pid"] == chd["pid"]:
            continue
        fid += 1
        s_ts = min(par["ts"] + par["dur"], chd["ts"])
        events.append({"name": "handoff", "cat": "trace", "ph": "s",
                       "id": fid, "pid": par["pid"], "tid": par["tid"],
                       "ts": round(s_ts, 1)})
        events.append({"name": "handoff", "cat": "trace", "ph": "f",
                       "bp": "e", "id": fid, "pid": chd["pid"],
                       "tid": chd["tid"], "ts": round(chd["ts"], 1)})

    # Per-lane monotonic emission order, even under corrected skew.
    for (pid, tid) in sorted(data_rows):
        events.extend(sorted(data_rows[(pid, tid)],
                             key=lambda e: e.get("ts", 0.0)))
    return {
        "traceEvents": events,
        "ranks": sorted(int(b["rank"]) for b in blobs.values()),
        "clock_offsets_us": {str(r): round(offsets.get(int(r), 0.0), 1)
                             for r in sorted(blobs)},
    }


# ---------------------------------------------------------------------------
# critical-path attribution
# ---------------------------------------------------------------------------

def critical_path_report(blobs: dict, *, offsets_us: Optional[dict] = None,
                         top: int = 5) -> dict:
    """Walk every merged trace and say where its time went.

    Self time = a span's duration minus the time covered by its direct
    children (clipped to the span's own window), attributed to
    ``(phase=span name, rank)``.  Per trace the dominant (phase, rank)
    is named; fleet-wide the slowest traces are ranked so the report
    answers "where did the p99 go".  Also sums the timeline tails'
    busy time per (op, rank) — the training-step collective view."""
    offsets = {int(k): float(v)
               for k, v in (offsets_us or {}).items() if v is not None}
    # Gather spans per trace_id across every rank's blob.
    traces: dict = {}
    for r, blob in sorted(blobs.items()):
        rank = int(blob["rank"])
        off = offsets.get(rank, 0.0)
        for tr in blob.get("traces", []):
            tid = tr.get("trace_id")
            if not tid:
                continue
            try:
                t_start = float(tr["t_start_unix"]) - off / 1e6
            except (KeyError, TypeError, ValueError):
                continue
            entry = traces.setdefault(
                tid, {"trace_id": tid, "name": tr.get("name"),
                      "spans": []})
            if tr.get("name") and not entry.get("name"):
                entry["name"] = tr.get("name")
            for sp in tr.get("spans", []):
                try:
                    t0 = t_start + float(sp["t_offset_s"])
                    t1 = t0 + max(0.0, float(sp["duration_s"]))
                except (KeyError, TypeError, ValueError):
                    continue
                entry["spans"].append({
                    "span_id": sp.get("span_id"),
                    "parent_id": sp.get("parent_id"),
                    "name": sp.get("name", "span"),
                    "rank": rank, "t0": t0, "t1": t1})

    per_trace: list = []
    fleet_phases: dict = {}
    for tid, entry in traces.items():
        spans = entry["spans"]
        if not spans:
            continue
        children: dict = {}
        for sp in spans:
            if sp["parent_id"]:
                children.setdefault(sp["parent_id"], []).append(sp)
        phases: dict = {}
        for sp in spans:
            covered = 0.0
            for ch in children.get(sp["span_id"], ()):  # clip to window
                covered += max(0.0, min(ch["t1"], sp["t1"])
                               - max(ch["t0"], sp["t0"]))
            self_s = max(0.0, (sp["t1"] - sp["t0"]) - covered)
            key = (sp["name"], sp["rank"])
            phases[key] = phases.get(key, 0.0) + self_s
            fleet_phases[key] = fleet_phases.get(key, 0.0) + self_s
        total = max(s["t1"] for s in spans) - min(s["t0"] for s in spans)
        dom_key = max(phases, key=phases.get)
        n_ranks = len({s["rank"] for s in spans})
        per_trace.append({
            "trace_id": tid,
            "name": entry.get("name"),
            "total_s": round(total, 6),
            "n_spans": len(spans),
            "n_ranks": n_ranks,
            "dominant_phase": dom_key[0],
            "dominant_rank": dom_key[1],
            "dominant_self_s": round(phases[dom_key], 6),
            "phases": [{"phase": k[0], "rank": k[1],
                        "self_s": round(v, 6)}
                       for k, v in sorted(phases.items(),
                                          key=lambda kv: -kv[1])],
        })
    per_trace.sort(key=lambda t: -t["total_s"])

    # Timeline-tail attribution: busy seconds per (op, rank) — names
    # the dominant collective/engine row of the training step view.
    tl_busy: dict = {}
    for r, blob in sorted(blobs.items()):
        rank = int(blob["rank"])
        tail = blob.get("timeline_tail", [])
        names = {int(e.get("tid", 0)): str(e.get("args", {}).get("name"))
                 for e in tail
                 if e.get("name") == "thread_name" and e.get("ph") == "M"}
        for ev in tail:
            if ev.get("ph") != "X":
                continue
            try:
                dur_s = float(ev.get("dur", 0.0)) / 1e6
            except (TypeError, ValueError):
                continue
            key = (str(ev.get("name", "?")), rank)
            tl_busy[key] = tl_busy.get(key, 0.0) + dur_s
    tl_rows = [{"name": k[0], "rank": k[1], "busy_s": round(v, 6)}
               for k, v in sorted(tl_busy.items(), key=lambda kv: -kv[1])]

    report = {
        "n_traces": len(per_trace),
        "slowest": per_trace[:max(1, int(top))],
        "phase_seconds": [{"phase": k[0], "rank": k[1],
                           "self_s": round(v, 6)}
                          for k, v in sorted(fleet_phases.items(),
                                             key=lambda kv: -kv[1])],
        "timeline_busy": tl_rows[:max(1, int(top))],
    }
    if per_trace:
        worst = per_trace[0]
        report["p99_trace"] = worst["trace_id"]
        report["dominant_phase"] = worst["dominant_phase"]
        report["dominant_rank"] = worst["dominant_rank"]
    return report


def export_critical_gauges(report: dict, *, registry=None) -> None:
    """Publish the report's per-(phase, rank) self seconds as
    ``hvd_trace_critical_phase_seconds{phase,rank}`` — rank-labeled so
    the snapshot/aggregation plane ships it to the autoscaler like any
    other per-rank family."""
    gauge = _m_crit if registry is None else registry.gauge(
        "hvd_trace_critical_phase_seconds",
        "critical-path self time attributed to (phase, rank) across the "
        "traces in the latest merged fleet view", ("phase", "rank"))
    for row in report.get("phase_seconds", []):
        gauge.labels(phase=str(row["phase"]),
                     rank=str(row["rank"])).set(float(row["self_s"]))


class TraceCollector:
    """Rank 0's merge point: sweeps published blobs, aligns clocks,
    serves the merged Perfetto JSON + critical-path report (the
    ``/tracez`` provider).  Clock offsets are measured lazily and
    cached (``offset_ttl_s``) — a ping handshake per rank per scrape
    would put the handshake's own latency into every fetch."""

    def __init__(self, *, own_rank: int = 0, own_pool: Optional[str] = None,
                 include_local: bool = True, tracer=None,
                 timeline_path: Optional[str] = None,
                 kv_factory: Callable = _kv_from_env,
                 offset_ttl_s: float = 30.0) -> None:
        self.own_rank = int(own_rank)
        self.own_pool = own_pool
        self._include_local = include_local
        self._tracer = tracer or TRACER
        self._timeline_path = timeline_path
        self._kv_factory = kv_factory
        self._offset_ttl = float(offset_ttl_s)
        self._kv = None
        self._lock = threading.Lock()
        self._offsets: dict = {}          # rank -> (t_measured, offset_us)

    def _offsets_for(self, ranks) -> dict:
        out: dict = {}
        now = time.monotonic()
        for r in ranks:
            if r == self.own_rank:
                out[r] = 0.0
                continue
            cached = self._offsets.get(r)
            if cached is not None and now - cached[0] < self._offset_ttl:
                out[r] = cached[1]
                continue
            off = estimate_clock_offset(self._kv, r, timeout_s=0.5)
            if off is not None:
                self._offsets[r] = (now, off)
                out[r] = off
            elif cached is not None:
                out[r] = cached[1]       # stale beats absent
        return out

    def collect(self, timeout_ms: int = 500) -> dict:
        """One merged fleet view; always returns a loadable object (at
        minimum the local rank's own traces)."""
        blobs: dict = {}
        offsets: dict = {}
        with self._lock:
            try:
                if self._kv is None:
                    self._kv = self._kv_factory()
            except (ConnectionError, OSError):
                self._kv = None
            if self._kv is not None:
                try:
                    blobs = collect_trace_blobs(
                        self._kv, timeout_ms=timeout_ms)
                    offsets = self._offsets_for(sorted(blobs))
                except (ConnectionError, OSError):
                    try:
                        self._kv.close()
                    except OSError:
                        pass
                    self._kv = None
                    blobs = {}
        if self._include_local:
            # Local rank read live — fresher than its last publication,
            # and the path works with no KV store at all.
            blobs[self.own_rank] = decode_trace_blob(local_trace_blob(
                self.own_rank, pool=self.own_pool, tracer=self._tracer,
                timeline_path=self._timeline_path))
            offsets[self.own_rank] = 0.0
        merged = merge_fleet_trace(blobs, offsets_us=offsets)
        report = critical_path_report(blobs, offsets_us=offsets)
        export_critical_gauges(report)
        merged["report"] = report
        _m_collects.inc()
        return merged

    def close(self) -> None:
        with self._lock:
            if self._kv is not None:
                try:
                    self._kv.close()
                except OSError:
                    pass
                self._kv = None


# ---------------------------------------------------------------------------
# process-wide wiring (context._arm_obs_plane()/shutdown() call these)
# ---------------------------------------------------------------------------

_publisher: Optional[TracePublisher] = None
_collector: Optional[TraceCollector] = None
_wiring_lock = threading.Lock()


def publish_interval_from_env() -> float:
    """``HVDTPU_/HOROVOD_TPU_/HOROVOD_ TRACE_PUBLISH_INTERVAL`` seconds;
    <= 0 disables the trace plane; unset falls back to the metrics
    snapshot cadence (``OBS_PUBLISH_INTERVAL``'s default)."""
    for prefix in ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_"):
        raw = os.environ.get(prefix + "TRACE_PUBLISH_INTERVAL")
        if raw:
            try:
                return float(raw)
            except ValueError:
                return DEFAULT_PUBLISH_INTERVAL_S
    return DEFAULT_PUBLISH_INTERVAL_S


def start_for_rank(rank: int, size: int, *, pool: Optional[str] = None,
                   timeline_path: Optional[str] = None) -> None:
    """Arm the trace plane for this process: every rank publishes (and
    answers clock pings); every rank can serve ``/tracez`` (rank 0 is
    the canonical scrape target, mirroring ``/cluster``).  Restarts
    cleanly on elastic re-init."""
    global _publisher, _collector
    with _wiring_lock:
        if _publisher is not None:
            _publisher.stop()
            _publisher = None
        if _collector is not None:
            _collector.close()
        interval = publish_interval_from_env()
        if os.environ.get("HVDTPU_RENDEZVOUS_ADDR") and interval > 0:
            _publisher = TracePublisher(
                rank, pool=pool, interval_s=interval,
                timeline_path=timeline_path).start()
        _collector = TraceCollector(own_rank=rank, own_pool=pool,
                                    timeline_path=timeline_path)
        from . import server
        server.set_trace_provider(_collector.collect)


def publish_now() -> bool:
    with _wiring_lock:
        pub = _publisher
    return pub.publish_now() if pub is not None else False


def stop() -> None:
    global _publisher, _collector
    with _wiring_lock:
        if _publisher is not None:
            _publisher.stop()
            _publisher = None
        if _collector is not None:
            _collector.close()
            _collector = None
        from . import server
        server.set_trace_provider(None)


def fleet_trace() -> dict:
    """The merged fleet trace (plain data).  Works before/without
    ``init()``: the un-armed fallback merges the local tracer only."""
    with _wiring_lock:
        col = _collector
    if col is not None:
        return col.collect()
    fallback = TraceCollector(kv_factory=lambda: None)
    try:
        return fallback.collect()
    finally:
        fallback.close()


# ---------------------------------------------------------------------------
# CLI: fetch /tracez into a file Perfetto opens directly
# ---------------------------------------------------------------------------

def main(argv: Optional[list] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.obs.tracemerge",
        description="fleet trace tooling")
    sub = p.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser(
        "fetch", help="GET <url>/tracez and write one Perfetto JSON")
    f.add_argument("url", help="metrics server base URL or full /tracez "
                   "URL (e.g. http://127.0.0.1:9464)")
    f.add_argument("-o", "--out", required=True)
    f.add_argument("--report", action="store_true",
                   help="also print the critical-path report")
    args = p.parse_args(argv)

    if args.cmd == "fetch":
        import urllib.request
        url = args.url.rstrip("/")
        if not url.endswith("/tracez"):
            url += "/tracez"
        with urllib.request.urlopen(url, timeout=30) as resp:
            merged = json.loads(resp.read().decode())
        with open(args.out, "w") as fh:
            json.dump(merged, fh)
        n = len(merged.get("traceEvents", []))
        print(f"tracemerge: wrote {args.out} ({n} events, "
              f"ranks={merged.get('ranks')})")
        if args.report:
            print(json.dumps(merged.get("report", {}), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
