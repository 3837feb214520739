"""Per-tensor collective lifecycle tracing to Chrome-trace JSON.

Reference († ``horovod/common/timeline.cc``): every tensor's journey
(NEGOTIATE → QUEUE → MEMCPY_IN_FUSION_BUFFER → <BACKEND>_ALLREDUCE →
MEMCPY_OUT_FUSION_BUFFER) is written as ``chrome://tracing`` events when
``HOROVOD_TIMELINE=/path.json`` is set; ``HOROVOD_TIMELINE_MARK_CYCLES`` adds
an instant event per background-loop cycle.

In this package the timeline carries the serving engine's request spans
(QUEUE → PREFILL → DECODE, one row per request); the collective engine's
per-tensor phases arrive with the collectives slice.  For on-device timing
use ``torch.profiler`` traces; this timeline is the host-side view, same as
the reference's.

Timeline v2 (beyond the reference):

- **Counter events** (``"ph": "C"``) — the engine samples the metrics
  registry (:mod:`horovod_tpu_torch.obs`) once per cycle into counter tracks,
  so one Perfetto load shows queue depth / cumulative collective bytes as
  graphs directly under the per-tensor spans.
- **Flow events** (``"ph": "s"``/``"f"``) — an arrow from a tensor's
  QUEUE span to its DISPATCH span, so a span picked in the execute phase
  links back to the enqueue that caused it even when other tensors'
  rows interleave.
- **Crash durability** — the writer flushes periodically (and on
  :meth:`flush`), registers an ``atexit`` close, and works as a context
  manager; the Chrome trace format treats the closing ``]`` as optional,
  so a trace cut off mid-run still loads with at most the
  post-last-flush tail missing.

The emitted file loads in ``chrome://tracing`` / Perfetto, like the
reference's.  Events use one "pid" per engine and one "tid" per tensor name,
matching the reference's layout (tensor rows).
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from typing import Optional


def rank_suffixed(path: str, rank: int, np_size: int) -> str:
    """Per-rank timeline path: ``/path.json`` → ``/path.r3.json`` when
    the job has more than one process, unchanged for np=1.

    ``HOROVOD_TIMELINE`` names ONE file; co-hosted multi-process workers
    handed the bare path verbatim would all open it for write and
    clobber each other's traces.  The ``.r<rank>`` infix keeps the
    extension (so Perfetto/chrome://tracing still recognize the file)
    and matches the ``rank[_-]?(\\d+)`` filename convention
    :func:`merge_timelines`' rank inference already understands.
    """
    if np_size <= 1:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}.r{int(rank)}{ext}" if ext else f"{path}.r{int(rank)}"


class Timeline:
    """Thread-safe Chrome-trace writer; no-op when ``path`` is None.

    ``rank`` (when known) is stamped into a ``clock_sync`` metadata
    event together with the wall-clock epoch of the trace's t=0 — the
    anchor :func:`merge_timelines` uses to rebase per-rank traces onto
    one shared time axis so cross-rank skew is visually real.
    """

    def __init__(self, path: Optional[str], *, mark_cycles: bool = False,
                 flush_interval_s: float = 1.0,
                 rank: Optional[int] = None) -> None:
        self._path = path
        self._mark_cycles = mark_cycles
        self._flush_interval = flush_interval_s
        self._lock = threading.Lock()
        self._fh = None
        self._tids: dict[str, int] = {}
        self._start = time.monotonic()
        self._last_flush = self._start
        self._flow_ids = itertools.count(1)
        self.rank = rank
        if path:
            # hvdrun --timeline-dir names a directory only the launcher
            # host pre-creates; ssh-launched ranks (and any user path)
            # must not die in init() over a missing parent.
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "w")
            self._fh.write("[\n")
            # Merge anchor: wall-clock time of this trace's ts=0, plus
            # the rank when the caller knows it (multi-process workers).
            sync_args: dict = {"epoch_us": time.time() * 1e6}
            if rank is not None:
                sync_args["rank"] = int(rank)
            self._emit({"name": "clock_sync", "ph": "M", "pid": 0,
                        "tid": 0, "args": sync_args})
            # Crash/exit durability: an unclosed timeline still flushes
            # its tail at interpreter exit (close() unregisters this).
            atexit.register(self.close)

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def __enter__(self) -> "Timeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _ts_us(self) -> float:
        return (time.monotonic() - self._start) * 1e6

    def _tid(self, tensor_name: str) -> int:
        tid = self._tids.get(tensor_name)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[tensor_name] = tid
            self._emit({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": tensor_name},
            })
        return tid

    def _emit(self, ev: dict) -> None:
        assert self._fh is not None
        self._fh.write(json.dumps(ev) + ",\n")
        now = time.monotonic()
        if now - self._last_flush >= self._flush_interval:
            self._fh.flush()
            self._last_flush = now

    def flush(self) -> None:
        """Push buffered events to disk so a crash right now loses
        nothing written so far (Chrome/Perfetto accept the truncated
        array — the closing ``]`` is optional in the trace format)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._last_flush = time.monotonic()

    def start_activity(self, tensor_name: str, activity: str) -> None:
        """Begin a phase for a tensor († ``Timeline::ActivityStart``)."""
        if not self.enabled:
            return
        with self._lock:
            if self._fh is None:
                return
            self._emit({"name": activity, "ph": "B", "pid": 0,
                        "tid": self._tid(tensor_name), "ts": self._ts_us()})

    def end_activity(self, tensor_name: str) -> None:
        """End the current phase († ``Timeline::ActivityEnd``)."""
        if not self.enabled:
            return
        with self._lock:
            if self._fh is None:
                return
            self._emit({"ph": "E", "pid": 0,
                        "tid": self._tid(tensor_name), "ts": self._ts_us()})

    def mark_cycle(self) -> None:
        """Instant event per engine cycle († HOROVOD_TIMELINE_MARK_CYCLES)."""
        if not self.enabled or not self._mark_cycles:
            return
        with self._lock:
            if self._fh is None:
                return
            self._emit({"name": "CYCLE", "ph": "i", "s": "g", "pid": 0,
                        "tid": 0, "ts": self._ts_us()})

    # -- Timeline v2 ---------------------------------------------------------
    def new_flow(self) -> int:
        """Fresh flow id for a QUEUE→DISPATCH arrow."""
        return next(self._flow_ids)

    def flow_start(self, tensor_name: str, flow_id: int) -> None:
        """Open a flow arrow at the tensor's current span (emit right
        after the QUEUE ``start_activity``)."""
        if not self.enabled:
            return
        with self._lock:
            if self._fh is None:
                return
            self._emit({"name": "hvd.link", "cat": "flow", "ph": "s",
                        "id": flow_id, "pid": 0,
                        "tid": self._tid(tensor_name), "ts": self._ts_us()})

    def flow_end(self, tensor_name: str, flow_id: int) -> None:
        """Land the arrow on the tensor's current span (emit right after
        the DISPATCH ``start_activity``); ``bp: "e"`` binds it to the
        enclosing slice."""
        if not self.enabled:
            return
        with self._lock:
            if self._fh is None:
                return
            self._emit({"name": "hvd.link", "cat": "flow", "ph": "f",
                        "bp": "e", "id": flow_id, "pid": 0,
                        "tid": self._tid(tensor_name), "ts": self._ts_us()})

    def complete(self, lane: str, name: str, t0_mono: float,
                 t1_mono: float, args: Optional[dict] = None) -> None:
        """Complete event (``"ph": "X"``): one slice with explicit start
        and duration, timestamped from ``time.monotonic()`` values.  The
        request tracer (:mod:`horovod_tpu_torch.obs.trace`) emits each ended
        span this way — the span's interval is only known at end time,
        when a B/E pair could no longer be placed retroactively."""
        if not self.enabled:
            return
        with self._lock:
            if self._fh is None:
                return
            ev = {"name": name, "ph": "X", "pid": 0,
                  "tid": self._tid(lane),
                  "ts": (t0_mono - self._start) * 1e6,
                  "dur": max(0.0, (t1_mono - t0_mono) * 1e6)}
            if args:
                ev["args"] = dict(args)
            self._emit(ev)

    def flow_at(self, lane: str, flow_id: int, ph: str,
                t_mono: float) -> None:
        """Flow endpoint (``ph`` = ``"s"`` or ``"f"``) at an explicit
        monotonic time — the retroactive form of :meth:`flow_start` /
        :meth:`flow_end`, used to chain already-ended ``X`` slices
        (QUEUE→PREFILL→DECODE arrows)."""
        if not self.enabled:
            return
        with self._lock:
            if self._fh is None:
                return
            ev = {"name": "hvd.link", "cat": "flow", "ph": ph,
                  "id": flow_id, "pid": 0, "tid": self._tid(lane),
                  "ts": (t_mono - self._start) * 1e6}
            if ph == "f":
                ev["bp"] = "e"
            self._emit(ev)

    def counter(self, name: str, values: dict) -> None:
        """Counter track sample (``"ph": "C"``): ``values`` is a flat
        ``{series: number}`` dict, rendered by Perfetto as stacked
        graphs.  The engine feeds these from the metrics registry once
        per cycle."""
        if not self.enabled:
            return
        with self._lock:
            if self._fh is None:
                return
            self._emit({"name": name, "ph": "C", "pid": 0, "tid": 0,
                        "ts": self._ts_us(), "args": dict(values)})

    def close(self) -> None:
        with self._lock:
            if self._fh is None:
                return
            # Chrome's trace parser accepts a trailing comma-less close; emit
            # a terminal metadata event so the JSON array is well-formed.
            self._fh.write(json.dumps(
                {"name": "trace_end", "ph": "M", "pid": 0, "tid": 0}) + "\n]\n")
            self._fh.close()
            self._fh = None
        atexit.unregister(self.close)


# ---------------------------------------------------------------------------
# Multi-rank merge: N per-rank Timeline files -> one Perfetto trace with
# one pid lane per rank.  The reference's † timeline.cc writes one file
# per process and leaves the join to the user; ``hvdrun --timeline-dir``
# collects per-rank files and this merge rebases them onto one wall-clock
# axis (via each file's clock_sync anchor), so cross-rank skew — who
# enqueued late, whose DISPATCH lags — is directly visible in one load.
# ---------------------------------------------------------------------------

#: flow/async ids are remapped per input file in strides of this, so
#: arrows never alias across ranks (each rank counts its own ids from 1).
_FLOW_ID_STRIDE = 1 << 24

_RANK_RE = None  # compiled lazily; avoids importing re on the hot path


def load_trace_events(path: str) -> list:
    """Read one Chrome-trace JSON file, tolerating the truncated-array
    form a crashed run leaves behind (the closing ``]`` is optional in
    the trace format, and Timeline relies on that for crash durability).
    Accepts both the bare-array and ``{"traceEvents": [...]}`` shapes."""
    with open(path) as fh:
        raw = fh.read()
    try:
        data = json.loads(raw)
    except ValueError:
        data = json.loads(raw.rstrip().rstrip(",") + "\n]")
    if isinstance(data, dict):
        data = data.get("traceEvents", [])
    return [ev for ev in data if isinstance(ev, dict)]


def _infer_rank(path: str, events: list, fallback: int) -> int:
    """A file's rank: the clock_sync stamp when present, else a
    ``rank<N>`` / ``.r<N>.`` hint in the filename (the latter is what
    :func:`rank_suffixed` emits), else the positional index."""
    for ev in events:
        if ev.get("name") == "clock_sync" and ev.get("ph") == "M":
            r = ev.get("args", {}).get("rank")
            if r is not None:
                return int(r)
            break
    global _RANK_RE
    if _RANK_RE is None:
        import re
        _RANK_RE = re.compile(r"(?:rank[_-]?|\.r)(\d+)")
    m = _RANK_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else fallback


def _epoch_us(events: list) -> Optional[float]:
    for ev in events:
        if ev.get("name") == "clock_sync" and ev.get("ph") == "M":
            e = ev.get("args", {}).get("epoch_us")
            if e is not None:
                return float(e)
    return None


def merge_timelines(out_path: str, inputs: list) -> dict:
    """Merge per-rank timeline files into ``out_path``.

    - one **pid lane per rank** (pid = rank, with ``process_name`` /
      ``process_sort_index`` metadata so Perfetto orders lanes by rank);
    - timestamps **rebased onto one shared axis** via each file's
      ``clock_sync`` wall-clock anchor (files without one keep their own
      zero), so a rank that started its step late is visibly shifted;
    - **counter tracks and flow arrows survive**: counter events move to
      their rank's lane, and flow ids are remapped per rank so no arrow
      aliases another rank's.

    Returns a summary dict (ranks merged, event count, output path).
    """
    per_file = []
    for i, path in enumerate(inputs):
        events = load_trace_events(path)
        per_file.append((_infer_rank(path, events, i),
                         _epoch_us(events), events))
    per_file.sort(key=lambda t: t[0])
    anchors = [e for _, e, _ in per_file if e is not None]
    base = min(anchors) if anchors else 0.0

    merged: list = []
    ranks = []
    for idx, (rank, epoch, events) in enumerate(per_file):
        ranks.append(rank)
        offset = (epoch - base) if epoch is not None else 0.0
        id_off = (idx + 1) * _FLOW_ID_STRIDE
        merged.append({"name": "process_name", "ph": "M", "pid": rank,
                       "tid": 0, "args": {"name": f"rank {rank}"}})
        merged.append({"name": "process_sort_index", "ph": "M",
                       "pid": rank, "tid": 0,
                       "args": {"sort_index": rank}})
        for ev in events:
            if ev.get("name") in ("trace_end", "process_name",
                                  "process_sort_index"):
                continue
            ev = dict(ev)
            ev["pid"] = rank
            if "ts" in ev:
                ev["ts"] = ev["ts"] + offset
            if ev.get("ph") in ("s", "t", "f") and "id" in ev:
                ev["id"] = int(ev["id"]) + id_off
            merged.append(ev)

    with open(out_path, "w") as fh:
        fh.write("[\n")
        for ev in merged:
            fh.write(json.dumps(ev) + ",\n")
        fh.write(json.dumps(
            {"name": "trace_end", "ph": "M", "pid": 0, "tid": 0}) + "\n]\n")
    return {"out": out_path, "ranks": ranks, "events": len(merged)}


def main(argv: Optional[list] = None) -> int:
    """CLI: ``python -m horovod_tpu_torch.utils.timeline merge out.json
    rank0.json rank1.json ...`` — see :func:`merge_timelines`."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.utils.timeline",
        description="Timeline tools (merge per-rank Chrome traces)")
    sub = p.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser(
        "merge", help="merge per-rank timeline files into one trace "
                      "with one pid lane per rank")
    m.add_argument("out", help="output trace path")
    m.add_argument("inputs", nargs="+",
                   help="per-rank timeline files (rank read from each "
                        "file's clock_sync event, else from a rank<N> "
                        "filename hint, else positional)")
    args = p.parse_args(argv)
    if args.cmd == "merge":
        summary = merge_timelines(args.out, args.inputs)
        print(f"merged {len(summary['ranks'])} rank timeline(s) "
              f"{summary['ranks']} -> {summary['out']} "
              f"({summary['events']} events)", file=sys.stderr)
        return 0
    return 2


if __name__ == "__main__":
    import sys
    sys.exit(main())
