"""Per-rank flight recorder: a bounded ring of recent events + postmortem
bundle dumps.

Metrics answer "how is the job doing"; traces answer "why was this
request slow"; neither survives the moment a rank dies or the engine
stall-shuts-down — the scrape you needed is the one you can no longer
take.  The flight recorder is the black box for that moment:

- a **fixed-size ring buffer** (``collections.deque(maxlen=N)``) of
  recent events — ended trace spans, collective dispatches, stall
  warnings, elastic interrupts — bounded memory by construction and
  lock-cheap to append (one deque append; drops are implicit and
  counted by construction, not tracked);
- a **postmortem bundle**: :meth:`FlightRecorder.dump` writes one JSON
  file holding the ring, an atomic metrics-registry snapshot, the
  process identity (rank/size/host/pid), and — when the caller has it —
  the stall attribution of the native controller (missing-rank list
  **and** bitmap per stalled tensor), so the file alone names the
  straggler;
- **wiring**: a serving session dumps when it gives up after repeated
  engine failures, an installed ``sys.excepthook`` dumps on an unhandled
  crash, and :meth:`FlightRecorder.dump` dumps on demand.  The collective
  engine's and elastic loop's dumps arrive with their slices.

Auto-dumps require arming (:meth:`FlightRecorder.arm`) so crashing jobs don't surprise-write
files; the manual API always works.  Dumping never raises — the
recorder must not take down the job it is documenting.

Stdlib-only, like the rest of ``obs``.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from collections import deque
from typing import Any, Optional

from .registry import REGISTRY

#: default ring capacity (events); env FLIGHT_RECORDER_SIZE overrides.
DEFAULT_CAPACITY = 2048

_m_events = REGISTRY.counter(
    "hvd_flightrec_events_total", "events recorded into the flight ring")
_m_dumps = REGISTRY.counter(
    "hvd_flightrec_dumps_total", "postmortem bundles written", ("reason",))


def _jsonsafe(o):
    """+/-Inf and NaN encode as strings so bundles are strict JSON."""
    if isinstance(o, float) and o != o:
        return "NaN"
    if isinstance(o, float) and o in (float("inf"), float("-inf")):
        return "+Inf" if o > 0 else "-Inf"
    if isinstance(o, dict):
        return {k: _jsonsafe(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonsafe(v) for v in o]
    return o


def _env(suffix: str) -> Optional[str]:
    for prefix in ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_"):
        v = os.environ.get(prefix + suffix)
        if v is not None:
            return v
    return None


def capacity_from_env() -> int:
    raw = _env("FLIGHT_RECORDER_SIZE")
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            pass
    return DEFAULT_CAPACITY


def rank_bitmap(ranks) -> int:
    """Missing-rank list -> bitmap int (rank r = bit r); the compact
    form the acceptance bundle carries next to the list."""
    bm = 0
    for r in ranks:
        bm |= 1 << int(r)
    return bm


def format_stall(stall_info: dict) -> dict:
    """``{tensor: StallInfo}`` (or any object with ``missing_ranks`` /
    ``age_ms``) -> the bundle's plain-data stall attribution."""
    out = {}
    for name, info in (stall_info or {}).items():
        missing = sorted(int(r) for r in
                         getattr(info, "missing_ranks", ()) or ())
        out[str(name)] = {
            "missing_ranks": missing,
            "missing_rank_bitmap": rank_bitmap(missing),
            "age_ms": int(getattr(info, "age_ms", 0)),
        }
    return out


class FlightRecorder:
    """Bounded event ring + bundle writer.  ``capacity=0`` disables
    recording (``record`` becomes a counter-only no-op)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = (capacity_from_env()
                         if capacity is None else max(0, int(capacity)))
        self._ring: deque = deque(maxlen=self.capacity or 1)
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._rank: Optional[int] = None
        self._size: Optional[int] = None
        self._hook_installed = False
        self._start_mono = time.monotonic()

    # -- recording (the hot path) ----------------------------------------
    def record(self, kind: str, name: str = "", **data: Any) -> None:
        """Append one event.  Deque appends are atomic; the counter add
        is the same one-lock cost every registry event pays."""
        if self.capacity:
            self._ring.append((time.time(),
                               time.monotonic() - self._start_mono,
                               kind, name, data or None))
        _m_events.inc()

    def snapshot(self) -> list:
        """The ring as plain dicts, oldest first."""
        with self._lock:
            items = list(self._ring) if self.capacity else []
        return [{"t_unix": round(t, 6), "t_mono_s": round(m, 6),
                 "kind": kind, "name": name,
                 **({"data": data} if data else {})}
                for t, m, kind, name, data in items]

    def __len__(self) -> int:
        return len(self._ring) if self.capacity else 0

    # -- identity / arming ------------------------------------------------
    def set_identity(self, rank: int, size: int) -> None:
        self._rank, self._size = int(rank), int(size)

    def set_capacity(self, capacity: int) -> None:
        """Resize the ring (``Config.flight_recorder_size`` at init);
        keeps the newest events that still fit."""
        capacity = max(0, int(capacity))
        if capacity == self.capacity:
            return
        with self._lock:
            old = list(self._ring) if self.capacity else []
            self.capacity = capacity
            self._ring = deque(old[-capacity:] if capacity else [],
                               maxlen=capacity or 1)

    def arm(self, directory: Optional[str]) -> None:
        """Enable auto-dumps into ``directory`` (None disarms).  Arming
        installs a chained ``sys.excepthook`` so an unhandled crash
        leaves a bundle behind."""
        self._dir = directory or None
        if self._dir and not self._hook_installed:
            self._hook_installed = True
            prev = sys.excepthook

            def hook(exc_type, exc, tb):
                try:
                    self.record("crash", name=exc_type.__name__,
                                error=repr(exc))
                    self.maybe_dump("crash",
                                    extra={"error": repr(exc)})
                finally:
                    prev(exc_type, exc, tb)

            sys.excepthook = hook

    @property
    def armed_dir(self) -> Optional[str]:
        return self._dir

    # -- bundles ----------------------------------------------------------
    def dump(self, path: Optional[str] = None, *, reason: str = "manual",
             stall: Optional[dict] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the postmortem bundle; returns the path, or None on any
        failure (logged, never raised — the recorder documents failures,
        it must not cause them)."""
        try:
            if path is None:
                d = self._dir or "."
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"flightrec-rank{self._rank if self._rank is not None else 'x'}"
                       f"-{os.getpid()}-{reason}-{int(time.time())}.json")
            else:
                parent = os.path.dirname(os.path.abspath(path))
                os.makedirs(parent, exist_ok=True)
            bundle = {
                "reason": reason,
                "t_unix": round(time.time(), 6),
                "rank": self._rank,
                "size": self._size,
                "hostname": socket.gethostname(),
                "pid": os.getpid(),
                "uptime_s": round(time.monotonic() - self._start_mono, 3),
                "events": self.snapshot(),
                "stall": format_stall(stall) if stall else {},
                "metrics": _jsonsafe(REGISTRY.snapshot()),
            }
            if extra:
                bundle["extra"] = _jsonsafe(dict(extra))
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(bundle, fh, separators=(",", ":"))
            os.replace(tmp, path)   # readers never see a torn bundle
            _m_dumps.labels(reason=reason).inc()
            from ..utils import logging as hvd_logging
            hvd_logging.get_logger().warning(
                "flight recorder: wrote %s bundle to %s "
                "(%d events%s)", reason, path, len(bundle["events"]),
                f", {len(bundle['stall'])} stalled tensor(s)"
                if bundle["stall"] else "")
            return path
        except Exception as e:  # noqa: BLE001 - by contract, never raise
            try:
                from ..utils import logging as hvd_logging
                hvd_logging.get_logger().warning(
                    "flight recorder: bundle dump failed: %s", e)
            except Exception:
                pass
            return None

    def maybe_dump(self, reason: str, *, stall: Optional[dict] = None,
                   extra: Optional[dict] = None) -> Optional[str]:
        """Auto-dump iff armed; the engine's crash paths call this so
        unarmed jobs pay nothing and write nothing."""
        if not self._dir:
            return None
        return self.dump(reason=reason, stall=stall, extra=extra)


#: the process-wide recorder every instrumented layer appends to
RECORDER = FlightRecorder()


def record(kind: str, name: str = "", **data: Any) -> None:
    RECORDER.record(kind, name, **data)
