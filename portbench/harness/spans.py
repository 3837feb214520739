"""The port's training-step spans placed on a traced run's device timeline.

Each step that ``DistributedOptimizer`` takes while a profiler records is
one ``hvd.step`` trace in ``horovod_tpu_torch.obs.trace.TRACER``, the
process's table of finished traces (``horovod_tpu_torch/obs/steps.py``
names the spans).  A one-rank cell's readers run in the process that
trained, after the window, so they read the last ``profiled_steps`` of
those traces there; a rank of a data-parallel cell sends its device
profile alone, so there the readers find nothing.

The profile's times count from the profiler's start; a span's bounds are
unix seconds.  Each step, on opening, read the wall clock into
``marker_unix_s`` and then launched a marker kernel (``spin_kernel``),
which starts on the device no earlier than that: the largest
``marker_unix_s`` less its marker's start, over the profiled steps, is
the unix time of the profile's zero, late by at most one launch's
latency (the harness synchronises before the first profiled step, so
that step's marker meets an idle device).  A device's first armed step
launches the kernel once more before its clock read, to load it; its
root's ``markers`` counts the launches (2, else 1), and the step's own
marker is the last of them.

A program without these spans or markers (an older port, a run off the
card) reads None."""

from __future__ import annotations

from typing import Optional

from . import trace

STEP = "hvd.step"
MARKER = "spin_kernel"


def step_traces(ctx) -> Optional[list]:
    """The profiled steps' ``hvd.step`` traces (``Tracer.export_all``
    dicts), oldest first; None unless the run has one rank and the table
    holds at least ``profiled_steps`` of them."""
    if ctx.ranks != 1:
        return None
    from horovod_tpu_torch.obs.trace import TRACER
    k = ctx.cell.traffic["profiled_steps"]
    steps = [t for t in TRACER.export_all() if t["name"] == STEP][-k:]
    return steps if len(steps) == k else None


def intervals(tr: dict, name: str) -> list:
    """``(start, end)`` in unix seconds of one trace's spans ``name``."""
    t0 = tr["t_start_unix"]
    return [(t0 + s["t_offset_s"], t0 + s["t_offset_s"] + s["duration_s"])
            for s in tr["spans"] if s["name"] == name]


def _root_attrs(tr: dict) -> dict:
    for s in tr["spans"]:
        if s["name"] == STEP:
            return s.get("attrs", {})
    return {}


def offset_s(p: trace.Profile, steps: list) -> Optional[float]:
    """Unix seconds of the profile's zero: the largest host time of a
    step's marker less that marker's start on the device (the marker
    kernels in order, each step's ``markers`` of them, the last its
    own); None unless every step has one."""
    marks = sorted(d.start for d in p.device if MARKER in d.name)
    attrs = [_root_attrs(t) for t in steps]
    if any("marker_unix_s" not in a for a in attrs) or \
            len(marks) != sum(a.get("markers", 1) for a in attrs):
        return None
    out, i = None, -1
    for a in attrs:
        i += a.get("markers", 1)
        d = a["marker_unix_s"] - marks[i]
        out = d if out is None else max(out, d)
    return out


def placed(ctx) -> Optional[tuple]:
    """``(profile, step traces, offset)``, or None where the spans cannot
    be placed on the device timeline."""
    steps = step_traces(ctx)
    if steps is None:
        return None
    p = ctx.profiles[0]
    off = offset_s(p, steps)
    return None if off is None else (p, steps, off)


def on_device(steps: list, name: str, off: float) -> list:
    """The spans ``name`` of every step on the profile's clock, as
    sorted disjoint pairs."""
    return trace.union((s - off, e - off) for t in steps
                       for s, e in intervals(t, name))


def overlap_s(a: list, b: list) -> float:
    """Seconds in both of two sorted disjoint lists of pairs."""
    return trace.measure(a) - trace.measure(trace.subtract(a, b))


def host_ms(ctx, name: str) -> Optional[float]:
    """Ms a step the host spent in spans ``name``: their durations
    summed over the profiled steps, over the steps."""
    got = placed(ctx)
    if got is None:
        return None
    _, steps, _ = got
    return 1e3 * sum(s["duration_s"] for t in steps for s in t["spans"]
                     if s["name"] == name) / len(steps)


def idle_ms(ctx, name: str) -> Optional[float]:
    """Ms a step in which no device operation ran while the host was
    inside a span ``name``."""
    got = placed(ctx)
    if got is None:
        return None
    p, steps, off = got
    return 1e3 * overlap_s(trace.idle_gaps(p), on_device(steps, name, off)) \
        / p.steps
