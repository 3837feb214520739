"""Always-on sampling profiler: where does each rank's wall-clock go?

The obs plane's first three tiers say *what* happened (metrics), *when*
(traces/spans) and *what just broke* (flight recorder).  This tier says
*where the time goes*: a daemon thread samples every Python thread's
stack via ``sys._current_frames()`` at a configurable rate (default
10 Hz — ~100 us of work per tick for a dozen threads, comfortably inside
a 2% overhead budget), aggregates the samples into a bounded hot-stack
table, classifies what phase of its cycle the fusion-engine thread was
in, and — where CUDA is up — polls the card's memory.

A copy of the JAX package's ``obs/prof.py`` for the port, with three
changes: the engine thread it classifies is the port's
(:data:`ENGINE_THREAD`, the name the engine gives its thread), the
device-memory poll reads ``torch.cuda`` instead of jax, and a tick holds
no reference cycle through its own frame (the JAX package's does, and
on the card that kept tensors of the sampled threads alive until the
next garbage collection: :meth:`SamplingProfiler._sample_once`).

Everything is exported three ways:

- ``hvd_prof_*`` metrics on the process registry (scraped via /metrics,
  merged cluster-wide on /cluster with a ``rank`` label);
- ``GET /profz`` (text) / ``/profz.json`` on the obs server — the
  human-facing hot-stack table;
- :func:`flight_summary` — the most recent per-thread stack ring, folded
  into flight-recorder postmortem bundles so a stall bundle shows where
  each rank was stuck, not just which ranks went missing.

Stdlib-only at import (registry constraint); torch is touched only
inside the guarded device-memory poll, and only when the process already
imported it and started CUDA.  The sampler never raises into its host
process: a profiler must not be able to take the job down.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Optional

from .registry import REGISTRY

#: The name of the collective engine's cycle thread (ops/engine.py starts
#: its thread under this name); only its samples are classified by phase.
ENGINE_THREAD = "hvdtpu-torch-engine"

#: Engine cycle phase classification: first matching function name found
#: walking the engine thread's stack (innermost first) wins.  Names are
#: from ops/engine.py's cycle thread and ops/negotiator.py; "idle" is the
#: condition-variable wait between cycles.
_ENGINE_PHASES = (
    ("negotiate", ("_negotiate", "negotiate")),
    ("dispatch", ("_execute_group", "_dispatch", "execute_allreduce")),
    ("fuse", ("_fuse", "_plan_groups", "_drain")),
    ("idle", ("wait", "_wait_for_tensors")),
)

_m_samples = REGISTRY.counter(
    "hvd_prof_samples_total", "profiler sampling ticks taken")
_m_thread_samples = REGISTRY.counter(
    "hvd_prof_thread_samples_total",
    "stack samples aggregated, per thread", ("thread",))
_m_phase = REGISTRY.counter(
    "hvd_prof_engine_phase_samples_total",
    "engine-thread samples classified per cycle phase", ("phase",))
_m_overhead = REGISTRY.counter(
    "hvd_prof_self_seconds_total",
    "wall-clock the sampler itself consumed (overhead accounting)")
_m_hz = REGISTRY.gauge(
    "hvd_prof_hz", "configured sampling rate (0 = profiler off)")
_m_table = REGISTRY.gauge(
    "hvd_prof_stack_table_size", "distinct hot stacks currently tracked")
_m_threads = REGISTRY.gauge(
    "hvd_prof_threads", "threads observed in the latest sample")
_m_devmem = REGISTRY.gauge(
    "hvd_prof_device_memory_bytes",
    "CUDA device memory of this process, where torch reports it",
    ("device", "kind"))


def _stack_key(frame, depth: int = 24) -> tuple:
    """Innermost-first tuple of ``module:function`` frames.

    Line numbers are deliberately dropped: aggregating by function keeps
    the table small and stable across ticks (a hot loop is one row, not
    one row per bytecode offset the sampler happened to land on).
    """
    out = []
    f = frame
    while f is not None and len(out) < depth:
        code = f.f_code
        mod = code.co_filename.rsplit("/", 1)[-1]
        out.append(f"{mod}:{code.co_name}")
        f = f.f_back
    return tuple(out)


def _classify_engine(key: tuple) -> str:
    for entry in key:
        fn = entry.split(":", 1)[1]
        for phase, names in _ENGINE_PHASES:
            if fn in names:
                return phase
    return "other"


class SamplingProfiler:
    """Bounded-memory stack sampler over ``sys._current_frames``.

    One instance per process (module singleton :data:`PROFILER`); the
    sampling thread is a daemon and restarts cleanly across elastic
    re-inits (``start`` is idempotent, ``configure`` retunes live).
    """

    def __init__(self, *, hz: float = 0.0, max_stacks: int = 512,
                 ring: int = 64) -> None:
        self._lock = threading.Lock()
        self._hz = float(hz)
        self._max_stacks = int(max_stacks)
        self._stacks: dict = {}          # (thread, key) -> count
        self._evicted = 0
        self._ring: collections.deque = collections.deque(maxlen=int(ring))
        self._samples = 0
        self._started_at: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._devmem_every = 20          # poll device memory every Nth tick
        self._tick = 0

    # -- lifecycle --------------------------------------------------------

    def configure(self, *, hz: Optional[float] = None,
                  max_stacks: Optional[int] = None,
                  ring: Optional[int] = None) -> None:
        with self._lock:
            if hz is not None:
                self._hz = float(hz)
            if max_stacks is not None:
                self._max_stacks = int(max_stacks)
            if ring is not None and int(ring) != self._ring.maxlen:
                self._ring = collections.deque(self._ring,
                                               maxlen=int(ring))
        _m_hz.set(self._hz)

    @property
    def running(self) -> bool:
        t = self._thread
        return bool(t and t.is_alive())

    def start(self) -> bool:
        """Start sampling at the configured rate; False when hz <= 0
        (disabled) or already running."""
        with self._lock:
            if self._hz <= 0 or self.running:
                _m_hz.set(self._hz if self._hz > 0 else 0.0)
                return False
            self._stop.clear()
            self._started_at = time.time()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="hvdtpu-prof")
            self._thread.start()
        _m_hz.set(self._hz)
        return True

    def stop(self) -> None:
        t = self._thread
        self._stop.set()
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        _m_hz.set(0.0)

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._ring.clear()
            self._samples = 0
            self._evicted = 0

    # -- sampling ---------------------------------------------------------

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.is_set():
            hz = self._hz
            if hz <= 0:
                return
            t0 = time.perf_counter()
            try:
                self._sample_once(me)
            except Exception:
                # Never let the profiler take the process down; skip the
                # tick and keep sampling.
                pass
            spent = time.perf_counter() - t0
            _m_overhead.inc(spent)
            self._stop.wait(max(0.001, 1.0 / hz - spent))

    def _sample_once(self, self_ident: int) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        # This thread's own frame holds ``frames`` as a local, and the
        # dict would hold that frame: a cycle only the collector breaks,
        # which kept every sampled thread's frames, and each frame's
        # locals once its function returned (tensors), alive until the
        # next collection.  Dropped first, the dict dies with this call.
        frames.pop(self_ident, None)
        # The frames become keys before the lock is taken: a tick that
        # waits for the lock holding them would keep a returned
        # function's frame, and its locals, alive until the tick ends.
        keys = [(names.get(ident, f"tid-{ident}"), _stack_key(frame))
                for ident, frame in frames.items()]
        del frames
        tick_view = {}
        with self._lock:
            self._samples += 1
            self._tick += 1
            for name, key in keys:
                tick_view[name] = key[0] if key else "?"
                skey = (name, key)
                if skey in self._stacks:
                    self._stacks[skey] += 1
                elif len(self._stacks) < self._max_stacks:
                    self._stacks[skey] = 1
                else:
                    self._evicted += 1
                _m_thread_samples.labels(thread=name).inc()
                if name == ENGINE_THREAD:
                    _m_phase.labels(phase=_classify_engine(key)).inc()
            self._ring.append((time.time(), tick_view))
            _m_table.set(len(self._stacks))
            _m_threads.set(len(tick_view))
        _m_samples.inc()
        if self._tick % self._devmem_every == 0:
            self._poll_device_memory()

    def _poll_device_memory(self) -> None:
        """Export this process's CUDA memory, per card it has used, under
        the reference's kinds that torch reports: ``bytes_in_use`` and
        ``peak_bytes_in_use`` (the caching allocator's allocated bytes,
        current and peak) and ``bytes_limit`` (the card's total memory);
        torch has no ``largest_alloc_size``.  Never imports torch and
        never starts CUDA: the poll runs only once the process started
        it, and skips a card the allocator never reserved memory on,
        where ``mem_get_info`` would create a context."""
        torch = sys.modules.get("torch")
        if torch is None:
            return
        try:
            cuda = torch.cuda
            if not cuda.is_initialized():
                return
            for i in range(cuda.device_count()):
                stats = cuda.memory_stats(i)
                if not stats.get("reserved_bytes.all.current"):
                    continue
                dev = f"cuda:{i}"
                for kind, v in (
                        ("bytes_in_use",
                         stats["allocated_bytes.all.current"]),
                        ("peak_bytes_in_use",
                         stats["allocated_bytes.all.peak"]),
                        ("bytes_limit", cuda.mem_get_info(i)[1])):
                    _m_devmem.labels(device=dev, kind=kind).set(float(v))
        except Exception:
            pass

    # -- views ------------------------------------------------------------

    def hot_stacks(self, limit: int = 20) -> list:
        """Top aggregated stacks: ``[{thread, count, fraction, stack}]``,
        innermost frame first, descending by sample count."""
        with self._lock:
            total = max(1, sum(self._stacks.values()))
            rows = sorted(self._stacks.items(), key=lambda kv: -kv[1])
            return [{"thread": name, "count": count,
                     "fraction": round(count / total, 4),
                     "stack": list(key)}
                    for (name, key), count in rows[:limit]]

    def snapshot(self) -> dict:
        """Full state for ``/profz.json``."""
        with self._lock:
            samples = self._samples
            started = self._started_at
            evicted = self._evicted
            ring = [{"t": t, "threads": dict(view)}
                    for t, view in self._ring]
        phases = {}
        fam = REGISTRY.get("hvd_prof_engine_phase_samples_total")
        if fam is not None:
            for s in fam._samples():
                phases[s["labels"].get("phase", "?")] = s["value"]
        return {
            "enabled": self.running,
            "hz": self._hz,
            "samples": samples,
            "started_unix": started,
            "stacks_evicted": evicted,
            "self_seconds": _m_overhead.value,
            "engine_phases": phases,
            "hot_stacks": self.hot_stacks(limit=25),
            "recent_ring": ring[-16:],
        }

    def flight_summary(self) -> dict:
        """Compact form for flight-recorder bundles: the recent ring
        (where was every thread over the last ~ring ticks) plus the top
        hot stacks."""
        with self._lock:
            ring = [{"t": round(t, 3), "threads": dict(view)}
                    for t, view in self._ring]
        return {"enabled": self.running, "hz": self._hz,
                "ring": ring, "hot_stacks": self.hot_stacks(limit=8)}

    def render_text(self) -> str:
        """``/profz`` — the human-facing table."""
        snap = self.snapshot()
        lines = [
            "# horovod_tpu_torch sampling profiler",
            f"enabled={snap['enabled']} hz={snap['hz']:g} "
            f"samples={snap['samples']} "
            f"self_seconds={snap['self_seconds']:.4f} "
            f"stacks_evicted={snap['stacks_evicted']}",
            "",
        ]
        if snap["engine_phases"]:
            total = max(1.0, sum(snap["engine_phases"].values()))
            lines.append("## engine cycle phases")
            for phase, n in sorted(snap["engine_phases"].items(),
                                   key=lambda kv: -kv[1]):
                lines.append(f"  {phase:<12} {n:>10.0f}  "
                             f"{100.0 * n / total:5.1f}%")
            lines.append("")
        lines.append("## hot stacks (top 25, innermost first)")
        if not snap["hot_stacks"]:
            lines.append("  (no samples yet)")
        for row in snap["hot_stacks"]:
            lines.append(f"  {row['fraction'] * 100:5.1f}%  "
                         f"x{row['count']:<6} [{row['thread']}]")
            for fr in row["stack"][:10]:
                lines.append(f"           {fr}")
        lines.append("")
        return "\n".join(lines) + "\n"


#: process-wide profiler; armed from ``hvd.init()`` (context._arm_obs_plane)
#: with the config-resolved rate, or manually via configure()/start().
PROFILER = SamplingProfiler()


def arm_from_config(cfg) -> bool:
    """Configure + start from a resolved :class:`horovod_tpu_torch.Config`;
    re-entrant across elastic re-inits (a live sampler is retuned, a
    dead one restarted).  Returns whether the sampler is running."""
    PROFILER.configure(hz=cfg.prof_hz, max_stacks=cfg.prof_max_stacks,
                       ring=cfg.prof_ring)
    if cfg.prof_hz <= 0:
        if PROFILER.running:
            PROFILER.stop()
        return False
    if not PROFILER.running:
        PROFILER.start()
    return PROFILER.running
