"""The traced run's profile, reduced to what the per-layer readers need.

``torch.profiler`` records a fixed handful of steps at the end of the
measured window (CPU and CUDA activity only: no shapes, memory or
stacks), so the trace stays small however long the window is.  Its
events become plain intervals: device operations (kernels, copies and
sets) with their stream, the host's operations, and the profiled region
from the first recorded step's start to the last device operation's end.
Busy time is the union of device intervals over every stream, so two
streams that overlap are counted once and the idle share is never below
0."""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Optional


@dataclasses.dataclass
class Interval:
    name: str
    start: float            # seconds, the trace's clock
    end: float
    stream: int = -1


@dataclasses.dataclass
class Profile:
    """One rank's profiled steps."""
    device: list            # Interval, one per device operation
    host: list              # Interval, one per host operation
    region: tuple           # (start, end), seconds
    steps: int              # profiled steps

    @property
    def window_s(self) -> float:
        return self.region[1] - self.region[0]


def union(intervals: Iterable[tuple]) -> list:
    """The union of ``(start, end)`` pairs as sorted disjoint pairs."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def measure(pairs: Iterable[tuple]) -> float:
    return sum(e - s for s, e in pairs)


def clip(pairs: Iterable[tuple], lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in pairs
            if min(e, hi) > max(s, lo)]


def subtract(a: list, b: list) -> list:
    """``a`` less ``b``, both sorted disjoint pairs."""
    out, j = [], 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def busy_s(p: Profile) -> float:
    return measure(clip(union((d.start, d.end) for d in p.device),
                        *p.region))


def idle_gaps(p: Profile) -> list:
    """The device's idle stretches inside the region, as pairs."""
    busy = clip(union((d.start, d.end) for d in p.device), *p.region)
    return subtract([p.region], busy)


def compute_stream(p: Profile) -> Optional[int]:
    """The stream that carries the step's compute: the one with the most
    device time outside NCCL's kernels."""
    per: dict = {}
    for d in p.device:
        if "nccl" not in d.name.lower():
            per[d.stream] = per.get(d.stream, 0.0) + d.end - d.start
    return max(per, key=per.get) if per else None


def short_name(name: str, n: int = 64) -> str:
    """A kernel's name without its template arguments and parameter list,
    truncated: stable from build to build."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::",
                                               "")
    for ch in "<(":
        i = name.find(ch)
        if i > 0:
            name = name[:i]
    return name[:n]


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time (seconds a step, by
    short name) and the longest idle gaps, each named by the innermost
    host operation running when it began."""
    per: dict = {}
    for d in p.device:
        k = short_name(d.name)
        per[k] = per.get(k, 0.0) + (d.end - d.start)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(p), key=lambda g: g[0] - g[1])[:top]
    host = sorted(p.host, key=lambda h: h.start)
    named = []
    for s, e in gaps:
        inner = None
        for h in host:
            if h.start > s:
                break
            if h.end >= s and (inner is None or
                               h.end - h.start < inner.end - inner.start):
                inner = h
        named.append([short_name(inner.name) if inner else "(no host op)",
                      e - s])
    return {"device_ops": [[k, v / p.steps] for k, v in ops],
            "idle_gaps": named}


def from_profiler(prof, steps: int) -> Profile:
    """A :class:`Profile` from a stopped ``torch.profiler.profile``.  On
    the card only CUDA activity is recorded (the CUDA runtime's calls are
    the host side), and the region is the span of the recorded device
    operations: the harness synchronises just before the first profiled
    step, so nothing of an earlier step is in flight.  Off the card (CPU
    activity, the tests) it starts at the first recorded
    ``ProfilerStep`` and ends at the last step or device operation."""
    events = list(prof.events())
    # A user annotation (``ProfilerStep*``, ``Optimizer.step#Adam.step``)
    # is mirrored on the device timeline under its host name; it covers
    # kernels already counted, and a kernel never bears a host op's name.
    host_names = {e.name for e in events if e.device_type.name == "CPU"}
    device, host, marks = [], [], []
    for e in events:
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type.name == "CUDA":
            if e.name not in host_names and \
                    not e.name.startswith("ProfilerStep"):
                device.append(Interval(e.name, s, t, int(
                    getattr(e, "device_resource_id", 0) or 0)))
        elif e.name.startswith("ProfilerStep"):
            marks.append((s, t))
        else:
            host.append(Interval(e.name, s, t))
    if device:
        start = min(d.start for d in device)
        end = max(d.end for d in device)
    elif marks:
        start = min(s for s, _ in marks)
        end = max(t for _, t in marks)
    else:
        raise RuntimeError("the profile holds no device operation and no "
                           "ProfilerStep mark")
    device = [d for d in device if d.end > start]
    return Profile(device=device, host=host, region=(start, end),
                   steps=steps)


def to_json(p: Profile) -> dict:
    """The device side of a profile, compact (host operations stay with
    the rank that recorded them)."""
    names = sorted({d.name for d in p.device})
    index = {n: i for i, n in enumerate(names)}
    return {"names": names, "region": list(p.region), "steps": p.steps,
            "device": [[index[d.name], d.start, d.end, d.stream]
                       for d in p.device]}


def from_json(j: dict) -> Profile:
    names = j["names"]
    return Profile(device=[Interval(names[i], s, e, st)
                           for i, s, e, st in j["device"]],
                   host=[], region=tuple(j["region"]), steps=j["steps"])
