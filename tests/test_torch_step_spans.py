"""The training step's spans (``horovod_tpu_torch/obs/steps.py``).

At one rank over Gloo in this process, a ``DistributedOptimizer`` step
taken while ``torch.profiler`` records (CPU activity) is one ``hvd.step``
trace of ``obs.trace.TRACER``: its four phases nested in it and in
order, its engine cycles carrying exactly the gradients' tensors and
bytes, the root's counters, a collector pass and the samplers' ticks as
children.  With ``HOROVOD_TIMELINE`` the same spans are ``X`` slices on
the ``hvd.step`` row beside the per-tensor rows.  Unarmed, twenty steps
record no span, register no gc callback and enter no ``record_function``
of the runtime's.  The marker kernel a step launches on a CUDA device is
checked with ``torch.cuda`` stood in for.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from horovod_tpu_torch.obs import REGISTRY, steps
from horovod_tpu_torch.obs.trace import TRACER
from horovod_tpu_torch.utils.timeline import load_trace_events

PHASES = ["hvd.step.forward", "hvd.step.backward",
          "hvd.step.allreduce_wait", "hvd.step.optimizer"]


@pytest.fixture
def runtime(monkeypatch):
    """``init(timeline=...)`` at one rank on the CPU (no timeline when
    None); shut down at the end."""
    import horovod_tpu_torch as hvd
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)

    def start(timeline=None):
        hvd.init(config=hvd.Config(platform="cpu"), timeline=timeline)
        return hvd

    yield start
    hvd.shutdown()


class _Model:
    """Three layers (six gradients) and a step through
    ``DistributedOptimizer``; ``during_forward`` runs inside the
    forward pass."""

    def __init__(self, hvd, zero_grad=True):
        torch.manual_seed(0)
        self.net = torch.nn.Sequential(
            torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 16),
            torch.nn.Tanh(), torch.nn.Linear(16, 4))
        self.opt = hvd.DistributedOptimizer(
            torch.optim.SGD(self.net.parameters(), lr=0.01),
            named_parameters=self.net.named_parameters())
        self.zero_grad = zero_grad
        self.during_forward = None

    def step(self):
        if self.zero_grad:
            self.opt.zero_grad()
        else:
            for p in self.net.parameters():
                p.grad = None
        if self.during_forward is not None:
            self.during_forward()
        self.net(torch.randn(4, 8)).square().mean().backward()
        self.opt.step()

    @property
    def grad_bytes(self):
        return sum(p.numel() * p.element_size()
                   for p in self.net.parameters())


def _new_steps(before: set) -> list:
    """The ``hvd.step`` traces finished since ``before`` (trace ids),
    once every engine cycle of theirs has ended (the engine's thread may
    close its last cycle just after ``step()`` returns): their cycles'
    tensors add up to the root's count."""
    deadline = time.monotonic() + 10
    while True:
        got = [t for t in TRACER.export_all()
               if t["trace_id"] not in before and t["name"] == "hvd.step"]
        if got and all(_cycles_ended(t) for t in got):
            return got
        if time.monotonic() > deadline:
            raise AssertionError("the step's spans never finished")
        time.sleep(0.01)


def _cycles_ended(tr: dict) -> bool:
    root = [s for s in tr["spans"] if s["parent_id"] is None]
    return len(root) == 1 and root[0]["attrs"]["tensors"] == sum(
        s["attrs"]["tensors"] for s in tr["spans"]
        if s["name"] == "hvd.engine.cycle")


def _by_name(tr: dict) -> dict:
    out: dict = {}
    for s in tr["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def _bounds(s: dict) -> tuple:
    return s["t_offset_s"], s["t_offset_s"] + s["duration_s"]


def test_profiled_step_is_one_trace_with_its_phases_in_order(runtime):
    m = _Model(runtime())
    m.step()                                # warm, unrecorded
    before = set(TRACER.finished_ids())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.step()
    got = _new_steps(before)
    assert len(got) == 1
    spans = _by_name(got[0])
    (root,) = spans["hvd.step"]
    assert root["parent_id"] is None
    phases = [spans[name] for name in PHASES]
    assert all(len(p) == 1 for p in phases)
    # Offsets and durations are exported rounded to the microsecond, so
    # a bound computed from both is good to 1.5 us.
    eps = 2e-6
    lo, hi = _bounds(root)
    prev_end = lo
    for (s,) in phases:
        assert s["parent_id"] == root["span_id"]
        s0, s1 = _bounds(s)
        assert lo - eps <= s0 <= s1 <= hi + eps
        assert s0 >= prev_end - eps          # in order, not overlapping
        prev_end = s1
    assert spans["hvd.step.allreduce_wait"][0]["attrs"]["handles"] == 6
    # The training thread's phases are host ranges of the profile too.
    names = {e.name for e in prof.events()}
    assert {"hvd.step", *PHASES} <= names


def test_engine_cycles_carry_the_gradients(runtime):
    m = _Model(runtime())
    before = set(TRACER.finished_ids())
    with profile(activities=[ProfilerActivity.CPU]):
        m.step()
    (tr,) = _new_steps(before)
    spans = _by_name(tr)
    root = spans["hvd.step"][0]
    cycles = spans["hvd.engine.cycle"]
    assert cycles and all(c["parent_id"] == root["span_id"] for c in cycles)
    assert sum(c["attrs"]["tensors"] for c in cycles) == 6
    assert sum(c["attrs"]["bytes"] for c in cycles) == m.grad_bytes
    ids = {c["span_id"] for c in cycles}
    for child in ("hvd.engine.negotiate", "hvd.engine.dispatch"):
        assert len(spans[child]) == len(cycles)
        assert {s["parent_id"] for s in spans[child]} == ids
    a = root["attrs"]
    assert a["gradients"] == 6 and a["tensors"] == 6
    assert a["bytes"] == m.grad_bytes
    assert a["groups"] == sum(c["attrs"]["groups"] for c in cycles)
    assert a["cycles"] == len(cycles)


def test_collector_passes_and_sampler_ticks_are_children(runtime):
    from horovod_tpu_torch.obs import prof, tsdb

    m = _Model(runtime())
    sampler = tsdb.TsdbSampler(tsdb.SeriesStore(interval_s=60))

    def ended_inside_the_step():
        # the names of the open step's spans that have ended so far
        return {s["name"] for s in steps.CURRENT.root._st.spans}

    def inside():
        gc.collect()
        sampler.start()                  # ticks once at once
        prof.PROFILER.configure(hz=200)
        prof.PROFILER.start()
        deadline = time.monotonic() + 30
        while not {"hvd.prof.tick", "hvd.tsdb.tick"} <= \
                ended_inside_the_step():
            assert time.monotonic() < deadline, "no sampler tick"
            time.sleep(0.01)

    m.during_forward = inside
    before = set(TRACER.finished_ids())
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            m.step()
    finally:
        sampler.stop()
        prof.PROFILER.stop()
        prof.PROFILER.configure(hz=0)
    (tr,) = _new_steps(before)
    spans = _by_name(tr)
    root = spans["hvd.step"][0]
    for name in ("hvd.gc", "hvd.prof.tick", "hvd.tsdb.tick"):
        assert spans.get(name), name
        assert all(s["parent_id"] == root["span_id"] for s in spans[name])
    gcs = spans["hvd.gc"]
    assert root["attrs"]["gc_passes"] == len(gcs) >= 1
    assert any(s["attrs"]["generation"] == 2 for s in gcs)
    assert root["attrs"]["gc_ms"] == pytest.approx(
        1e3 * sum(s["duration_s"] for s in gcs), abs=0.01)


def test_first_gradient_hook_opens_the_step_without_zero_grad(runtime):
    m = _Model(runtime(), zero_grad=False)
    m.step()
    before = set(TRACER.finished_ids())
    with profile(activities=[ProfilerActivity.CPU]):
        m.step()
    (tr,) = _new_steps(before)
    spans = _by_name(tr)
    assert "hvd.step.forward" not in spans
    assert all(len(spans[n]) == 1 for n in PHASES[1:])
    assert spans["hvd.step"][0]["attrs"]["gradients"] == 6


def test_timeline_shows_the_step_row_beside_the_tensor_rows(runtime,
                                                           tmp_path):
    path = tmp_path / "tl.json"
    hvd = runtime(timeline=str(path))
    m = _Model(hvd)
    before = set(TRACER.finished_ids())
    m.step()                             # armed by the timeline alone
    assert len(_new_steps(before)) == 1
    hvd.shutdown()
    events = load_trace_events(str(path))
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("name") == "thread_name"}
    slices = [(rows[e["tid"]], e["name"]) for e in events
              if e.get("ph") == "X"]
    assert ("hvd.step", "hvd.step") in slices
    assert {("hvd.step", n) for n in PHASES} <= set(slices)
    assert ("hvd.engine", "hvd.engine.cycle") in slices
    tensor_rows = {rows[e["tid"]] for e in events
                   if e.get("ph") == "B" and e.get("name") == "DISPATCH"}
    assert len(tensor_rows) == 6
    assert all(r.startswith("grad.") for r in tensor_rows)


def test_unarmed_steps_record_nothing(runtime, monkeypatch):
    m = _Model(runtime())
    m.step()
    time.sleep(0.05)
    spans_total = REGISTRY.get("hvd_trace_spans_total")
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    callbacks = list(gc.callbacks)
    seen = []
    m.during_forward = lambda: seen.append(list(gc.callbacks))
    n0 = spans_total.value
    for _ in range(20):
        m.step()
    time.sleep(0.05)
    assert spans_total.value == n0
    # torch.optim enters its own ranges (Optimizer.step#SGD.step) always;
    # the runtime's, the engine's per group among them, none.
    assert entered and not [n for n in entered if n.startswith("hvd.")]
    assert seen == [callbacks] * 20 and gc.callbacks == callbacks
    assert steps.CURRENT is None


def test_profiled_ranges_are_the_training_threads_alone(runtime,
                                                      monkeypatch):
    """While a profiler records, the root and the four phases are
    entered as ``record_function`` ranges, and the engine's and the
    samplers' spans are not (a profile started in the training thread
    records no range of another thread); the per-group range stays."""
    m = _Model(runtime())
    m.step()
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    before = set(TRACER.finished_ids())
    with profile(activities=[ProfilerActivity.CPU]):
        m.step()
    (tr,) = _new_steps(before)
    assert _by_name(tr)["hvd.engine.cycle"]
    ours = [n for n in entered if n.startswith("hvd.")]
    assert sorted(n for n in ours if ":" not in n) == sorted(
        ["hvd.step", *PHASES])
    assert [n for n in ours if ":" in n] and all(
        n.startswith("hvd.allreduce:") for n in ours if ":" in n)


def test_step_spans_stay_out_of_the_flight_recorder(runtime):
    from horovod_tpu_torch.obs import flightrec

    m = _Model(runtime())
    before = set(TRACER.finished_ids())
    n0 = len(flightrec.RECORDER.snapshot())
    with profile(activities=[ProfilerActivity.CPU]):
        m.step()
    (tr,) = _new_steps(before)
    ids = {s["span_id"] for s in tr["spans"]}
    assert len(ids) >= 1 + len(PHASES) + 3
    assert not [e for e in flightrec.RECORDER.snapshot()[n0:]
                if e["kind"] == "span" and e["data"]["span"] in ids]


def test_a_step_on_a_cuda_device_launches_its_marker(monkeypatch):
    """Read the clock, then launch ``torch.cuda._sleep(1)`` on the
    step's device; the device's first armed step launches it once before
    the clock read too (``torch.cuda`` stood in for on the CPU)."""
    launched = []
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: launched.append((cycles,
                                                        time.time())))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(steps, "_LOADED", set())
    dev = types.SimpleNamespace(type="cuda", index=0)
    for n in (2, 1):
        del launched[:]
        t = time.time()
        st = steps.StepSpans.open(None, dev, at_zero_grad=True)
        try:
            marker = st.root.attrs["marker_unix_s"]
            assert st.root.attrs["markers"] == n
            assert [c for c, _ in launched] == [1] * n
            assert t <= marker <= launched[-1][1]
            assert all(t <= w <= marker for _, w in launched[:-1])
            assert steps.CURRENT is st
        finally:
            st.close()
        assert steps.CURRENT is None and st._on_gc not in gc.callbacks
        tr = TRACER.export(st.root.trace_id)
        assert tr["spans"][-1]["attrs"]["marker_unix_s"] == marker
    # Loaded once a device, before any recorded step.
    monkeypatch.setattr(steps, "_LOADED", set())
    del launched[:]
    steps.load_marker(dev)
    steps.load_marker(dev)
    steps.load_marker(types.SimpleNamespace(type="cpu", index=None))
    assert len(launched) == 1
    st = steps.StepSpans.open(None, dev, at_zero_grad=True)
    st.close()
    assert st.root.attrs["markers"] == 1 and len(launched) == 2


def test_the_first_unrecorded_step_loads_the_marker(runtime, monkeypatch):
    """On a card the optimizer loads the marker kernel at its first step
    that no profiler records, and never again (``load_marker`` stood in
    for: the parameters here are on the CPU)."""
    loads = []
    monkeypatch.setattr(steps, "load_marker", loads.append)
    m = _Model(runtime())
    assert m.opt._unloaded is None              # CPU parameters
    dev = types.SimpleNamespace(type="cuda", index=0)
    m.opt._unloaded = dev
    with profile(activities=[ProfilerActivity.CPU]):
        m.step()                                # recorded: no load
    assert loads == []
    for _ in range(3):
        m.step()
    assert loads == [dev] and m.opt._unloaded is None
