"""The port's step spans on the device timeline (``harness/spans.py``):
the clocks' offset from the step markers, the spans' idle time, and a
run whose spans or markers are missing reading None."""

from __future__ import annotations

import types

import pytest
import torch

from portbench.harness import spans, trace
from portbench.harness.trace import Interval, Profile

T0 = 1.7e9                      # unix seconds at the profile's zero


def _step(start, dur, marker_latency, waits=(), cycles=()):
    """One ``hvd.step`` trace as ``Tracer.export_all`` gives it, opening
    at profile time ``start``; its marker reached the device
    ``marker_latency`` seconds after the host read the clock."""
    spans_ = [{"name": "hvd.step", "t_offset_s": 0.0, "duration_s": dur,
               "attrs": {"marker_unix_s": T0 + start - marker_latency}}]
    for name, pairs in (("hvd.step.allreduce_wait", waits),
                        ("hvd.engine.cycle", cycles)):
        spans_ += [{"name": name, "t_offset_s": s - start,
                    "duration_s": e - s} for s, e in pairs]
    return {"name": "hvd.step", "t_start_unix": T0 + start,
            "spans": spans_}


def _ctx(device, steps=3, ranks=1):
    p = Profile(device=[Interval(n, s, e, 7) for n, s, e in device],
                host=[], region=(0.0, 3.0), steps=steps)
    cell = types.SimpleNamespace(traffic={"profiled_steps": steps})
    return types.SimpleNamespace(cell=cell, profiles=[p] * ranks,
                                 ranks=ranks, rate=1.0)


# Three steps of one second: a marker at each step's start, compute from
# 0.1 s in, idle where each step waits for its allreduces at its end.
DEVICE = [("void at::cuda::(anonymous namespace)::spin_kernel(long)",
           float(i), i + 1e-6) for i in range(3)] + \
    [("gemm", i + 0.1, i + 0.8) for i in range(3)]
STEPS = [_step(0.0, 1.0, 5e-6, waits=[(0.7, 0.95)], cycles=[(0.3, 0.31)]),
         _step(1.0, 1.0, 2e-3, waits=[(1.7, 1.95)],
               cycles=[(1.3, 1.31), (1.5, 1.52)]),
         _step(2.0, 1.0, 3e-3, waits=[(2.7, 2.95)], cycles=[])]


def test_offset_is_the_marker_nearest_its_host_time():
    p = _ctx(DEVICE).profiles[0]
    # The first marker met an idle device: 5 us after its host time.
    assert spans.offset_s(p, STEPS) == pytest.approx(T0 - 5e-6, abs=1e-7)
    # The i-th marker kernel is paired with the i-th step: reversed, the
    # steps give another offset.
    assert spans.offset_s(p, STEPS[::-1]) != spans.offset_s(p, STEPS)
    assert spans.offset_s(p, STEPS[:2]) is None      # a marker too many
    bare = [dict(t, spans=[dict(t["spans"][0], attrs={})] + t["spans"][1:])
            for t in STEPS]
    assert spans.offset_s(p, bare) is None            # no host time


def test_a_loading_launch_before_the_first_marker_is_skipped():
    # The device's first armed step launched the marker kernel once to
    # load it, 60 us before its own marker (root attr ``markers`` 2).
    load = ("void at::cuda::(anonymous namespace)::spin_kernel(long)",
            -60e-6, -59e-6)
    first = dict(STEPS[0], spans=[dict(STEPS[0]["spans"][0], attrs=dict(
        STEPS[0]["spans"][0]["attrs"], markers=2))] + STEPS[0]["spans"][1:])
    p = _ctx([load] + DEVICE).profiles[0]
    assert spans.offset_s(p, [first] + STEPS[1:]) == \
        pytest.approx(T0 - 5e-6, abs=1e-7)
    assert spans.offset_s(p, STEPS) is None           # a marker too many


def test_idle_gaps_intersected_with_the_wait(monkeypatch):
    ctx = _ctx(DEVICE)
    monkeypatch.setattr(spans, "step_traces", lambda c: STEPS)
    # Idle from 0.8 to 1.0 of each step (the marker is busy for 1 us at
    # the next step's start); the wait, 0.7-0.95 of each step, lands 5 us
    # later on the profile's clock (its zero is 5 us before T0): 0.15 s
    # and 5 us of each step are idle.
    assert spans.idle_ms(ctx, "hvd.step.allreduce_wait") == \
        pytest.approx(1e3 * (0.15 + 5e-6), rel=1e-6)
    # Nothing idle inside the cycles, which fall on the compute.
    assert spans.idle_ms(ctx, "hvd.engine.cycle") == 0.0
    assert spans.host_ms(ctx, "hvd.step.allreduce_wait") == \
        pytest.approx(250.0)
    assert spans.host_ms(ctx, "hvd.engine.cycle") == \
        pytest.approx(1e3 * 0.04 / 3)
    assert spans.overlap_s([(0, 2), (3, 5)], [(1, 4)]) == pytest.approx(2)


def test_nothing_to_place_reads_none(monkeypatch):
    # Without markers (the port off the card, or an older port), with a
    # step short, or at more than one rank, every reader finds nothing.
    no_markers = [d for d in DEVICE if "spin" not in d[0]]
    monkeypatch.setattr(spans, "step_traces", lambda c: STEPS)
    assert spans.idle_ms(_ctx(no_markers), "hvd.step.allreduce_wait") \
        is None
    monkeypatch.setattr(spans, "step_traces", lambda c: None)
    assert spans.host_ms(_ctx(DEVICE), "hvd.engine.cycle") is None
    monkeypatch.undo()
    assert spans.step_traces(_ctx(DEVICE, ranks=2)) is None
    assert spans.step_traces(_ctx(DEVICE, steps=10 ** 6)) is None


def test_profiled_steps_leave_their_traces(cpu_runtime):
    """On the CPU a profiled ``DistributedOptimizer`` step leaves one
    ``hvd.step`` trace each (no marker off the card), and an unprofiled
    one none."""
    from torch.profiler import ProfilerActivity, profile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs.trace import TRACER

    hvd.init()
    lin = torch.nn.Linear(4, 2)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(lin.parameters(), lr=0.1),
        named_parameters=lin.named_parameters())

    def step():
        opt.zero_grad()
        lin(torch.ones(3, 4)).sum().backward()
        opt.step()

    before = set(TRACER.finished_ids())
    step()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            step()
    step()
    assert [t["name"] for t in TRACER.export_all()
            if t["trace_id"] not in before] == [spans.STEP] * 2
    ctx = _ctx([], steps=2)
    got = spans.step_traces(ctx)
    assert got is not None and len(got) == 2
    waits = [spans.intervals(t, "hvd.step.allreduce_wait") for t in got]
    assert [len(w) for w in waits] == [1, 1]
    assert waits[0][0][1] <= waits[1][0][0]
    assert spans.offset_s(ctx.profiles[0], got) is None
    assert trace.idle_gaps(ctx.profiles[0]) == [(0.0, 3.0)]
