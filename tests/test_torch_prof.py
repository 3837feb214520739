"""Port parity: the sampling profiler, ``horovod_tpu_torch.obs.prof``.

Held against the JAX package's ``horovod_tpu.obs.prof``: the stack keys
and the engine-phase classification on the same frames, the bounded
table, and the shapes of ``/profz.json``, ``/profz`` and the flight
summary.  Then what the port changes: the engine thread it classifies is
the port's (the JAX package's name matches no thread of the port, so a
verbatim copy counted no phase at all), the device-memory poll reads
``torch.cuda`` and never starts CUDA, a tick keeps no sampled local alive
past its function (the JAX package's does, through a reference cycle),
and flight-recorder bundles carry the profile.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import types

import pytest

from horovod_tpu.obs import prof as ref_prof
from horovod_tpu_torch.obs import REGISTRY, flightrec, prof

KEYS = [
    ("threading.py:wait", "engine.py:_loop", "threading.py:run"),
    ("negotiator.py:negotiate", "engine.py:_run_cycle", "engine.py:_loop"),
    ("collectives.py:allreduce_", "engine.py:_allreduce",
     "engine.py:_dispatch", "engine.py:_execute_group",
     "engine.py:_run_cycle"),
    ("engine.py:_entry_bytes", "engine.py:_fuse", "engine.py:_run_cycle"),
    ("engine.py:_run_cycle", "engine.py:_loop"),
    ("timeline.py:mark_cycle", "engine.py:_run_cycle"),
    (),
]


@pytest.mark.parametrize("key", KEYS)
def test_engine_phase_classification_matches_reference(key):
    assert prof._classify_engine(key) == ref_prof._classify_engine(key)
    assert prof._ENGINE_PHASES == ref_prof._ENGINE_PHASES


def test_stack_keys_match_reference():
    ev = threading.Event()

    def leaf():
        ev.wait(5)

    th = threading.Thread(target=leaf, name="probe")
    th.start()
    try:
        time.sleep(0.05)
        frame = sys._current_frames()[th.ident]
        for depth in (1, 4, 24):
            assert prof._stack_key(frame, depth) == \
                ref_prof._stack_key(frame, depth)
        assert prof._stack_key(frame)[0] == "threading.py:wait"
    finally:
        ev.set()
        th.join()


def test_the_port_engine_thread_is_the_one_classified():
    """The trap: the JAX package classifies a thread named
    ``hvdtpu-engine``; the port's engine thread is ``ENGINE_THREAD``."""
    from horovod_tpu_torch.ops import engine
    assert prof.ENGINE_THREAD == "hvdtpu-torch-engine"
    assert "hvdtpu-engine" != prof.ENGINE_THREAD
    assert engine._prof.ENGINE_THREAD is prof.ENGINE_THREAD


def test_one_rank_engine_phases_are_counted(monkeypatch):
    import torch

    import horovod_tpu_torch as hvd
    for k in list(__import__("os").environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    fam = REGISTRY.get("hvd_prof_engine_phase_samples_total")
    before = sum(s["value"] for s in fam._samples()) if fam else 0.0
    hvd.init(config=hvd.Config(platform="cpu", prof_hz=200.0))
    try:
        assert prof.PROFILER.running
        assert hvd.global_state().engine._thread.name == prof.ENGINE_THREAD
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            hvd.allreduce(torch.ones(1 << 14), hvd.Sum, name="prof.x")
            fam = REGISTRY.get("hvd_prof_engine_phase_samples_total")
            if fam and sum(s["value"] for s in fam._samples()) > before + 5:
                break
        snap = prof.PROFILER.snapshot()
        assert sum(snap["engine_phases"].values()) > before
        assert set(snap["engine_phases"]) <= {
            "negotiate", "dispatch", "fuse", "idle", "other"}
        assert any(r["thread"] == prof.ENGINE_THREAD
                   for r in prof.PROFILER.hot_stacks(limit=100))
    finally:
        hvd.shutdown()
    assert not prof.PROFILER.running


def test_bounded_table_and_views_match_reference_shapes():
    views = []
    for mod in (ref_prof, prof):
        p = mod.SamplingProfiler(hz=500.0, max_stacks=3, ring=4)
        stop = threading.Event()
        threads = [threading.Thread(target=stop.wait, args=(5,),
                                    name=f"busy{i}") for i in range(6)]
        for t in threads:
            t.start()
        me = threading.get_ident()
        for _ in range(10):
            p._sample_once(me)
        stop.set()
        for t in threads:
            t.join()
        snap = p.snapshot()
        assert len(p._stacks) <= 3 and p._evicted > 0
        assert len(snap["recent_ring"]) == 4
        views.append((sorted(snap), sorted(p.flight_summary()),
                      p.render_text().splitlines()[1].split()[0]))
    assert views[0] == views[1]


def test_arm_from_config_starts_retunes_and_stops():
    from horovod_tpu_torch import config
    try:
        assert prof.arm_from_config(config.Config(prof_hz=50.0))
        assert prof.PROFILER.running and prof.PROFILER._hz == 50.0
        assert prof.arm_from_config(config.Config(prof_hz=20.0,
                                                  prof_ring=8))
        assert prof.PROFILER._ring.maxlen == 8
        assert not prof.arm_from_config(config.Config(prof_hz=0.0))
        assert not prof.PROFILER.running
        assert REGISTRY.get("hvd_prof_hz").value == 0.0
    finally:
        prof.PROFILER.stop()
        prof.PROFILER.configure(hz=0.0, ring=64)


_OUTLIVES = r"""
import gc, json, sys, threading, weakref
from horovod_tpu.obs import prof as ref_prof
from horovod_tpu_torch.obs import prof


class Local:
    pass


def outlives(profiler):
    inside, leave, refs = threading.Event(), threading.Event(), []

    def victim():
        x = Local()
        refs.append(weakref.ref(x))
        inside.set()
        leave.wait(5)

    t = threading.Thread(target=victim)
    t.start()
    inside.wait(5)
    s = threading.Thread(
        target=lambda: profiler._sample_once(threading.get_ident()))
    s.start()
    s.join()
    leave.set()
    t.join()
    return refs[0]() is not None


gc.collect()
gc.disable()
print(json.dumps([outlives(ref_prof.SamplingProfiler()),
                  outlives(prof.SamplingProfiler())]))
"""


def test_a_tick_keeps_no_sampled_local_alive():
    """Sample a thread while one of its functions holds a local, let the
    function return, and ask whether the local outlived it, with the
    collector off (as between two collections), in a process of its own
    (no other sampler running).  The JAX package's tick holds its own
    frame in the dict its frame holds, a cycle that kept every sampled
    thread's locals alive until the next collection (on an H100, 0.7-1.6
    GB more peak memory in the 7B data-parallel step at 10 Hz, 6.3 GB at
    100 Hz).  The port's tick holds none."""
    import os
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    res = subprocess.run([sys.executable, "-c", _OUTLIVES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.splitlines()[-1]) == [True, False]


class _Gate:
    """Stands in for a profiler's ``_lock``: says when a tick reaches it,
    then waits for the real lock, which the test holds."""

    def __init__(self, lock: threading.Lock) -> None:
        self.lock = lock
        self.reached = threading.Event()

    def __enter__(self):
        self.reached.set()
        self.lock.acquire()

    def __exit__(self, *exc):
        self.lock.release()


def test_a_tick_waiting_for_its_lock_holds_no_returned_frame():
    """A tick blocked at the profiler's lock must not keep a sampled
    function's frame, and with it its locals, alive after the function
    returned: the tick turns frames into keys before it takes the lock."""
    import gc
    import weakref

    import torch

    profiler = prof.SamplingProfiler()
    gate = _Gate(profiler._lock)
    profiler._lock = gate
    inside, leave = threading.Event(), threading.Event()
    refs = []

    def holder():
        big = torch.empty(1 << 20)
        refs.append(weakref.ref(big))
        inside.set()
        leave.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    assert inside.wait(10)
    gate.lock.acquire()
    s = threading.Thread(
        target=lambda: profiler._sample_once(threading.get_ident()))
    try:
        s.start()
        assert gate.reached.wait(10)
        leave.set()
        t.join(10)
        assert not t.is_alive()
        deadline = time.monotonic() + 2.0
        while refs[0]() is not None and time.monotonic() < deadline:
            gc.collect()
            time.sleep(0.01)
        assert refs[0]() is None, \
            "a tick waiting for the lock kept the returned frame's tensor"
    finally:
        gate.lock.release()
        s.join(10)
    assert not s.is_alive()
    assert profiler._samples == 1


class _FakeCuda:
    def __init__(self, initialized: bool) -> None:
        self.initialized = initialized
        self.calls: list = []

    def is_initialized(self):
        return self.initialized

    def device_count(self):
        return 2

    def memory_stats(self, i):
        self.calls.append(("memory_stats", i))
        return {} if i == 1 else {"reserved_bytes.all.current": 4096,
                                  "allocated_bytes.all.current": 1000,
                                  "allocated_bytes.all.peak": 3000}

    def mem_get_info(self, i):
        self.calls.append(("mem_get_info", i))
        return (10, 80 << 30)


def test_device_memory_poll_reads_torch_cuda(monkeypatch):
    cuda = _FakeCuda(True)
    monkeypatch.setitem(sys.modules, "torch", types.SimpleNamespace(
        cuda=cuda))
    prof.SamplingProfiler()._poll_device_memory()
    fam = REGISTRY.get("hvd_prof_device_memory_bytes")
    got = {k: fam.labels(device="cuda:0", kind=k).value
           for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")}
    assert got == {"bytes_in_use": 1000.0, "peak_bytes_in_use": 3000.0,
                   "bytes_limit": float(80 << 30)}
    # a card this process never reserved memory on is not asked
    assert ("mem_get_info", 1) not in cuda.calls


def test_device_memory_poll_never_starts_cuda(monkeypatch):
    cuda = _FakeCuda(False)
    monkeypatch.setitem(sys.modules, "torch", types.SimpleNamespace(
        cuda=cuda))
    prof.SamplingProfiler()._poll_device_memory()
    assert cuda.calls == []
    monkeypatch.delitem(sys.modules, "torch")
    prof.SamplingProfiler()._poll_device_memory()   # never imports it
    assert "torch" not in sys.modules


def test_flight_bundle_carries_the_profile(tmp_path):
    p = prof.PROFILER
    try:
        p.configure(hz=200.0)
        p.start()
        deadline = time.monotonic() + 5
        while not p.flight_summary()["ring"] and time.monotonic() < deadline:
            time.sleep(0.02)
        path = flightrec.RECORDER.dump(str(tmp_path / "fr.json"))
        bundle = json.loads(open(path).read())
        assert bundle["profile"]["ring"] and bundle["profile"]["enabled"]
        assert set(bundle["profile"]) == set(ref_prof.SamplingProfiler()
                                             .flight_summary())
    finally:
        p.stop()
        p.configure(hz=0.0)
