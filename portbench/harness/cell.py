"""One run of one cell, on one rank: set-up, the checked first steps, the
measured window (optionally with its last few steps profiled), the plain
reference after the window, and the line the run prints.

A cell's program file (``configs/<config>.py``) gives a ``Program``
with:

- ``Program(cell, seed, device, hvd)``: the weights made from the seed,
  the model, the optimizer and the step, under the initialized runtime;
- ``step(i) -> loss``: training step ``i`` on its own rows, as a 0-d
  tensor, with no host sync;
- ``work_per_step``: this rank's tokens (or images) a step;
- ``read_grad1()``, ``read_change()``: each leaf's norm of the first
  gradient, worked out from the optimizer's state after step 0, and of
  the parameters' change so far, by leaf name;
- ``free()``: drop the program's state;
- the module's ``RATE_METRIC``: the end-to-end metric of its work rate.

The same object steps through the checked steps and then the window, on
rows that all differ."""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import time

from . import guard, judge, trace

MIN_WINDOW_STEPS = 3


def process_start_epoch() -> float:
    """This process's start, in seconds since the epoch (Linux)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])                 # field 22: starttime
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checked_steps(prog, traffic: dict, device) -> tuple:
    """The checked first steps, the set-up's warm-up, through the
    window's own call and feed: (readings, each step's seconds, the
    seconds spent reading the state)."""
    import torch

    losses, step_s, read_s = [], [], 0.0
    grad1 = None
    for i in range(traffic["check_steps"]):
        t = time.perf_counter()
        loss = prog.step(i)
        _sync(torch, device)
        step_s.append(time.perf_counter() - t)
        losses.append(loss.item())
        if i == 0:
            t = time.perf_counter()
            grad1 = prog.read_grad1()
            read_s += time.perf_counter() - t
    t = time.perf_counter()
    change = prog.read_change()
    read_s += time.perf_counter() - t
    return ({"loss": losses, "grad1": grad1, "change": change}, step_s,
            read_s)


def run_rank(cell, seed: int, seconds: float, traced: bool, device, hvd,
             t_start: float, *, world_group_init=None) -> dict:
    """Run the cell on this rank under the initialized runtime ``hvd``;
    shut the runtime down after the window and run the reference
    (``world_group_init(rank, size)`` starts the reference's own process
    group where the ranks must average).  Returns this rank's result."""
    import torch

    tr = cell.traffic
    rank, size = hvd.rank(), hvd.size()
    prog = cell.program().Program(cell, seed, device, hvd)
    readings, step_s, read_s = checked_steps(prog, tr, device)
    losses = readings["loss"]

    K = tr["profiled_steps"]
    n = max(MIN_WINDOW_STEPS, round(seconds / step_s[-1]))
    if traced:
        n = max(n, K + 2)
    if size > 1:                            # every rank steps alike
        n = hvd.broadcast_object(n, root_rank=0, name="portbench.steps")
        hvd.allreduce(torch.zeros(1, device=device), name="portbench.go")
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, schedule
        # CPU activity would record every operator, and that host cost
        # would make the profiled steps host-bound (ResNet-50 read 25-30%
        # idle so, against about 1% untraced).
        acts = [ProfilerActivity.CUDA if device.type == "cuda"
                else ProfilerActivity.CPU]
        prof = profile(activities=acts, record_shapes=False,
                       profile_memory=False, with_stack=False,
                       schedule=schedule(wait=n - K - 1, warmup=1,
                                         active=K, repeat=1))
        prof.start()
    _sync(torch, device)
    t_first = time.time()
    t0 = time.perf_counter()
    window = []
    for j in range(n):
        if traced and j == n - K:
            _sync(torch, device)            # the profiled region starts
        window.append(prog.step(tr["check_steps"] + j))
        if traced and j < n - 1:
            prof.step()
    _sync(torch, device)
    t1 = time.perf_counter()
    if traced:
        prof.stop()

    window_losses = torch.stack(window).float().cpu().tolist()
    failed = sum(not math.isfinite(x) for x in losses + window_losses)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = {"rank": rank, "size": size, "steps": n,
           "work": n * prog.work_per_step, "window_s": t1 - t0,
           "setup_s": t_first - t_start - read_s,
           "attempted": tr["check_steps"] + n, "failed": failed,
           "memory_peak_bytes": peak, "losses": losses + window_losses}
    if traced:
        p = trace.from_profiler(prof, K)
        out["profile"] = trace.to_json(p)
        out["breakdown"] = trace.breakdown(p)
        del p
    prog.free()
    del prof, window, prog
    hvd.shutdown()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    group_up = world_group_init(rank, size) if size > 1 else False
    try:
        ref = cell.reference().readings(cell.config, tr, seed, device,
                                        rank=rank, world=size)
    finally:
        if group_up:
            import torch.distributed as dist
            dist.destroy_process_group()
    out["reference_s"] = time.perf_counter() - t
    out["numbers"] = judge.gaps(readings, ref)
    out["forbidden_modules"] = guard.forbidden_modules()
    return out


def _device_info(torch, cell, ranks: list, traced: bool) -> dict:
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else "cpu",
           "count": len(ranks),
           "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    if traced:
        profs = [trace.from_json(r["profile"]) for r in ranks]
        dev["busy_s"] = sum(trace.busy_s(p) for p in profs) / len(profs)
        dev["window_s"] = sum(p.window_s for p in profs) / len(profs)
    return dev


class Context:
    """What a per-layer reader reads: the cell, every rank's profile and
    the traced window's work rate (units a second over all ranks)."""

    def __init__(self, cell, profiles: list, rate: float):
        self.cell, self.profiles, self.rate = cell, profiles, rate
        self.ranks = len(profiles)


def finish(cell, ranks: list, traced: bool) -> tuple:
    """(exit code, the result's line) from every rank's result; prints
    the compared numbers and their limits on standard error."""
    import torch

    found = sorted({m for r in ranks for m in r["forbidden_modules"]}
                   | set(guard.forbidden_modules()))
    if found:
        print(f"portbench: modules of the JAX package were loaded: "
              f"{found}", file=sys.stderr, flush=True)
        return 3, None
    drv = cell.program()
    rate = sum(r["work"] for r in ranks) / max(r["window_s"] for r in ranks)
    numbers = judge.worst([r["numbers"] for r in ranks])
    ok, rows = judge.compare(numbers, cell.limits)
    failed = sum(r["failed"] for r in ranks)
    metrics = {}
    if traced:
        ctx = Context(cell, [trace.from_json(r["profile"]) for r in ranks],
                      rate)
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {drv.RATE_METRIC: rate,
                  "setup_s": max(r["setup_s"] for r in ranks),
                  "peak_mem_gb": max(r["memory_peak_bytes"]
                                     for r in ranks) / 1e9}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": bool(ok and failed == 0),
            "attempted": sum(r["attempted"] for r in ranks),
            "failed": failed, "metrics": metrics,
            "device": _device_info(torch, cell, ranks, traced)}
    if traced:
        fullest = max(range(len(ranks)), key=lambda i: trace.busy_s(
            trace.from_json(ranks[i]["profile"])))
        line["breakdown"] = ranks[fullest]["breakdown"]
    line["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    line["check"]["failed_steps"] = {"value": failed, "limit": 0}
    for r in ranks:
        print(f"portbench: rank {r['rank']}: {r['steps']} window steps in "
              f"{r['window_s']:.4f} s, set-up {r['setup_s']:.3f} s, "
              f"reference {r['reference_s']:.3f} s, losses "
              f"{r['losses'][:4]}", file=sys.stderr)
    print(f"portbench: numbers (worst rank) {numbers}; rank 0's worst "
          f"leaves: grad1 {ranks[0]['numbers']['grad1_worst_leaf']}, "
          f"change {ranks[0]['numbers']['change_worst_leaf']}; quiet "
          f"leaves {ranks[0]['numbers']['quiet_leaves']}", file=sys.stderr)
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    print(f"check failed_steps {failed} limit 0", file=sys.stderr,
          flush=True)
    return 0, json.dumps(line)
