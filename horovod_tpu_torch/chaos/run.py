"""Chaos scenario harness: ``python -m horovod_tpu_torch.chaos.run``.

The port of ``horovod_tpu/chaos/run.py``.  Failures are INPUTS here,
recovery is the unit under test:

- **elastic** (np=4, launcher subprocesses on the CPU over Gloo):
  workers train a committed :class:`~horovod_tpu_torch.elastic.FileBackedState`
  loop while ``HVDTPU_FAULTS`` injects one rank death (``dispatch:die``
  behind a cross-relaunch once-latch), p=0.02 KV errors on both blob
  directions, and probabilistic negotiation delays.  Asserts: the
  ElasticDriver blacklists the dead rank's host and relaunches at np=2,
  every incarnation's per-step allreduce equals its world size, the job
  completes within a bounded recovery budget, and a flight-recorder
  bundle on disk names the injected fault.
- **autoscale** (np=4 → 2 → 4): an expert-parallel step (``alltoall``
  dispatch and combine) under the closed-loop autoscaler; an injected
  death shrinks the job, an SLO burn holds scale-up pressure, and the
  controller grows it back when the blacklist cooldown lapses.  A
  deterministic predictive leg runs first.
- **determinism**: the same seeded spec driven over the same traversal
  schedule twice produces the bit-identical fault sequence.

The serving, router and disagg scenarios of the reference need the front
door's router and transport and the KV migration, which come with ROADMAP
section A 'Parallel strategies, and what needs them': ``--scenario``
names them and exits 2.  (Serving's own recovery, rejoin included, is
held by ``tests/test_torch_serving.py`` and ``tests/test_torch_chaos.py``.)

Exit 0 iff every selected scenario passes.  ``--worker`` and
``--moe-worker`` are the internal worker entry points.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

#: generous wall-clock bound on the whole np=4 kill/blacklist/relaunch
#: circle — an unbounded hang must fail the job, not outwait CI.
ELASTIC_BUDGET_S = 240.0

_WORKER_TOTAL_STEPS = 10
_MOE_TOTAL_STEPS = 150

#: scenarios of the reference that wait for later slices of the port
_WAITING = {
    "serving": "the serving scenario (its /healthz drain is tested in "
               "tests/test_torch_chaos.py)",
    "router": "the front door's router",
    "disagg": "disaggregated serving's KV migration",
}
_WAITING_ITEM = "ROADMAP section A 'Parallel strategies, and what needs them'"


def _log_to(path: str):
    def log_line(text: str) -> None:
        with open(path, "a") as f:
            f.write(text + "\n")
    return log_line


def _worker_env() -> tuple:
    return (os.environ["HVDTPU_CHAOS_STATE"],
            _log_to(os.environ["HVDTPU_CHAOS_LOG"]))


# ---------------------------------------------------------------------------
# np=4 worker (internal entry point)
# ---------------------------------------------------------------------------

def worker_main() -> int:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import FileBackedState

    state_path, log_line = _worker_env()
    total = int(os.environ.get("HVDTPU_CHAOS_TOTAL",
                               str(_WORKER_TOTAL_STEPS)))
    hvd.init()
    me, n = hvd.rank(), hvd.size()
    log_line(f"START rank={me} size={n}")
    # NB: construction broadcasts rank 0's loaded state (4 engine
    # dispatches), so the injected death's after=N counts those too.
    state = FileBackedState(state_path, step=0)
    log_line(f"RESUME rank={me} size={n} resume_step={state.step}")

    @hvd.elastic.run
    def train(state):
        for step in range(state.step, total):
            out = hvd.synchronize(hvd.allreduce_async(
                torch.ones(2), hvd.Sum, name=f"chaos.w.{step}"))
            # A sum of ones across the CURRENT world must equal the world
            # size exactly; an inconsistency after recovery shows here.
            got = float(out[0])
            if got != float(n):
                log_line(f"BAD rank={me} step={step} got={got} want={n}")
                raise SystemExit(3)
            state.step = step + 1
            state.commit()
            log_line(f"STEP rank={me} size={n} step={step}")
        return state.step

    train(state)
    log_line(f"DONE rank={me} size={n} step={state.step}")
    hvd.shutdown()
    return 0


# ---------------------------------------------------------------------------
# expert-parallel worker (internal entry point for --scenario autoscale)
# ---------------------------------------------------------------------------

def _moe_step(hvd, x, router, experts, me: int, n: int, tag: str):
    """One top-1 expert-parallel layer over ``hvd.alltoall``: each token
    goes to the rank owning its expert, ``tanh(x @ w_e)`` there, and back
    into its place.  Returns the outputs and the load-balancing term."""
    import torch
    e_local = experts.shape[0]
    probs = torch.softmax(x @ router, dim=-1)
    expert = probs.argmax(-1)
    owner = expert // e_local
    order = torch.argsort(owner, stable=True)
    splits = torch.bincount(owner, minlength=n)
    recv_counts = hvd.alltoall(splits, splits=[1] * n, name=f"{tag}.counts")
    tokens = hvd.alltoall(x[order], splits=splits.tolist(),
                          name=f"{tag}.dispatch")
    which = hvd.alltoall(expert[order], splits=splits.tolist(),
                         name=f"{tag}.experts")
    w = experts[which - me * e_local]
    y = torch.tanh(torch.bmm(tokens[:, None, :], w)[:, 0])
    back = hvd.alltoall(y, splits=recv_counts.tolist(), name=f"{tag}.combine")
    out = torch.empty_like(back)
    out[order] = back
    frac = torch.bincount(expert, minlength=probs.shape[1]).float() \
        / x.shape[0]
    aux = float((frac * probs.mean(0)).sum() * probs.shape[1])
    return out, aux


def moe_worker_main() -> int:
    """Like :func:`worker_main`, but each step drives the expert-parallel
    layer plus the allreduce-of-ones probe.  Expert weights are sliced
    from a fixed full table by rank, so any world size n with
    ``E_total % n == 0`` computes with the same experts."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import FileBackedState

    state_path, log_line = _worker_env()
    total = int(os.environ.get("HVDTPU_CHAOS_TOTAL", str(_MOE_TOTAL_STEPS)))
    hvd.init()
    me, n = hvd.rank(), hvd.size()
    log_line(f"START rank={me} size={n}")

    D, E_total, T = 8, 4, 16
    rng = np.random.RandomState(0)
    router = torch.from_numpy(rng.randn(D, E_total).astype(np.float32))
    w_full = torch.from_numpy(rng.randn(E_total, D, D).astype(np.float32))
    e_local = E_total // n
    experts = w_full[me * e_local:(me + 1) * e_local]

    state = FileBackedState(state_path, step=0)
    log_line(f"RESUME rank={me} size={n} resume_step={state.step}")

    @hvd.elastic.run
    def train(state):
        for step in range(state.step, total):
            toks = torch.from_numpy(np.random.RandomState(
                1000 * me + step).randn(T, D).astype(np.float32))
            out, aux = _moe_step(hvd, toks, router, experts, me, n,
                                 f"chaos.moe.{step}")
            if out.shape != (T, D) or not bool(torch.isfinite(out).all()) \
                    or not np.isfinite(aux):
                log_line(f"BAD rank={me} step={step} moe shape="
                         f"{tuple(out.shape)} aux={aux}")
                raise SystemExit(3)
            got = float(hvd.allreduce(torch.ones(2), hvd.Sum,
                                      name=f"chaos.moe.{step}")[0])
            if got != float(n):
                log_line(f"BAD rank={me} step={step} got={got} want={n}")
                raise SystemExit(3)
            state.step = step + 1
            state.commit()
            log_line(f"STEP rank={me} size={n} step={step}")
            # Pace the loop so the np=2 stretch outlives the blacklist
            # cooldown + controller tick + epoch bump round-trip.
            time.sleep(0.2)
        return state.step

    train(state)
    log_line(f"DONE rank={me} size={n} step={state.step}")
    hvd.shutdown()
    return 0


def _scenario_env(work: str, faults: str, total: int) -> dict:
    return {
        "HVDTPU_FAULTS": faults,
        "HVDTPU_CHAOS_STATE": os.path.join(work, "state.json"),
        "HVDTPU_CHAOS_LOG": os.path.join(work, "train.log"),
        "HVDTPU_CHAOS_TOTAL": str(total),
        "HVDTPU_FLIGHT_RECORDER_DIR": os.path.join(work, "flightrec"),
        "HVDTPU_PLATFORM": "cpu",
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": os.pathsep.join(
            [p for p in (os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
                os.environ.get("PYTHONPATH", "")) if p]),
    }


# ---------------------------------------------------------------------------
# scenario: elastic recovery at np=4
# ---------------------------------------------------------------------------

def scenario_elastic(np_total: int = 4, verbose: bool = False) -> None:
    from ..runner.elastic import ElasticDriver, FixedDiscovery

    work = tempfile.mkdtemp(prefix="hvdtpu_chaos_")
    die_latch = os.path.join(work, "die.latch")
    per_host = max(1, np_total // 2)
    # after=8: 4 state-sync broadcasts at init + steps 0..2 = traversal
    # 8 is step 3's allreduce — the death lands mid-training, past
    # several durable commits.  The once-latch keeps the relaunched
    # incarnation (same env, fresh rank 1) from dying again.
    faults = (f"dispatch:rank=1:die:after=8:once={die_latch}; "
              "kv_put:err:p=0.02:seed=7; kv_get:err:p=0.02:seed=7; "
              "negotiate:delay=20ms:p=0.05:seed=3")
    env = _scenario_env(work, faults, _WORKER_TOTAL_STEPS)
    state_path, log_path = env["HVDTPU_CHAOS_STATE"], env["HVDTPU_CHAOS_LOG"]
    frec_dir = env["HVDTPU_FLIGHT_RECORDER_DIR"]
    # Two "hosts" (both exec locally) so the dead rank's host is
    # blacklistable and the job relaunches on the survivor at np//2.
    driver = ElasticDriver(
        FixedDiscovery(f"localhost:{per_host},127.0.0.1:{per_host}"),
        min_np=1, max_np=np_total,
        # Longer than the scenario: probation/decay has its own unit
        # tests; here a mid-run re-admission would only add rounds.
        blacklist_cooldown_s=600.0)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.chaos.run", "--worker"]
    t0 = time.monotonic()
    code = driver.run_job(cmd, extra_env=env, max_restarts=5,
                          slot_timeout_s=60.0,
                          launch_kwargs={"verbose": verbose,
                                         "connectivity_check": False})
    dt = time.monotonic() - t0
    assert code == 0, f"elastic chaos job failed with exit code {code}"
    assert dt < ELASTIC_BUDGET_S, \
        f"recovery not bounded: took {dt:.0f}s > {ELASTIC_BUDGET_S:.0f}s"
    assert os.path.exists(die_latch), "injected death never fired"
    assert driver.blacklisted() == {"localhost"}, driver.blacklisted()

    lines = open(log_path).read().splitlines()
    assert not any(ln.startswith("BAD") for ln in lines), \
        [ln for ln in lines if ln.startswith("BAD")]
    assert f"START rank=0 size={np_total}" in lines, lines
    # The relaunch ran on the surviving host at half size, resuming
    # from a committed step (not from scratch).
    resumed = [ln for ln in lines
               if ln.startswith(f"RESUME rank=0 size={per_host} ")]
    assert resumed, f"no relaunch at np={per_host}:\n" + "\n".join(lines)
    assert all(int(ln.split("resume_step=")[1]) > 0 for ln in resumed), \
        resumed
    assert any(ln.startswith(f"DONE rank=0 size={per_host} "
                             f"step={_WORKER_TOTAL_STEPS}")
               for ln in lines), lines
    assert json.load(open(state_path))["step"] == _WORKER_TOTAL_STEPS

    # The dead rank's black box names the injected fault.
    bundles = glob.glob(os.path.join(
        frec_dir, "flightrec-rank1-*-injected_death-*.json"))
    assert bundles, f"no injected_death bundle in {os.listdir(frec_dir)}"
    b = json.load(open(bundles[-1]))
    assert b["extra"]["site"] == "dispatch", b["extra"]
    assert "die" in b["extra"]["rule"], b["extra"]
    assert any(e["kind"] == "fault_injected"
               and e["data"]["fault_kind"] == "die"
               for e in b["events"]), b["events"][-5:]
    print(f"CHAOS-ELASTIC-OK np={np_total} rounds="
          f"{sum(1 for ln in lines if ln.startswith('START rank=0'))} "
          f"wall={dt:.0f}s")


# ---------------------------------------------------------------------------
# scenario: autoscale closed loop (shrink on a death, grow back)
# ---------------------------------------------------------------------------

def _predictive_grow_leg() -> None:
    """Forecast-fed scale-up, fully deterministic (fake clock, fake
    collect): a queue ramp of +0.5/s at np=2 with ``queue_high=8`` and a
    30s lookahead must fire ``action="grow_predicted"`` while the
    instantaneous depth is still below 8."""
    from ..autoscale import PolicyConfig, ScalePolicy
    from ..autoscale.controller import AutoscaleController
    from ..obs import tsdb

    clk = [1000.0]
    depth = [0.0]

    def collect():
        return [
            {"name": "horovod_tpu_rank_snapshot_age_seconds",
             "type": "gauge", "help": "", "labelnames": ("rank", "stale"),
             "samples": [{"labels": {"rank": "0", "stale": "false"},
                          "value": 0.0}]},
            {"name": "hvd_serving_queue_depth", "type": "gauge",
             "help": "", "labelnames": (),
             "samples": [{"labels": {"rank": "0"}, "value": depth[0]}]},
        ]

    policy = ScalePolicy(
        PolicyConfig(min_np=2, max_np=4, queue_high=8.0,
                     forecast_horizon_s=30.0, scale_up_cooldown_s=0.0),
        clock=lambda: clk[0])
    bumps = []
    ctl = AutoscaleController(
        policy, current_np=2, collect=collect,
        bump=lambda: bumps.append(1), capacity=lambda: 4,
        store=tsdb.SeriesStore(interval_s=1.0, name="chaos-predict"),
        clock=lambda: clk[0])
    depth_at_decision = None
    for _ in range(20):
        d = ctl.poll_once()
        if d.action == "grow_predicted":
            depth_at_decision = depth[0]
            break
        clk[0] += 1.0
        depth[0] += 0.5
    assert depth_at_decision is not None, \
        [x.action for x in ctl.decisions]
    assert depth_at_decision < 8.0, \
        f"predictive grow fired only at depth {depth_at_decision}"
    assert bumps, "grow_predicted decision never bumped the epoch"
    d = next(x for x in ctl.decisions if x.action == "grow_predicted")
    assert d.target_np == 4 and "forecast" in d.reason, d
    print(f"CHAOS-AUTOSCALE predictive leg OK: grow_predicted at "
          f"depth={depth_at_decision:.1f} (<8.0) [{d.reason}]")


def scenario_autoscale(verbose: bool = False) -> None:
    """np=4 expert-parallel job under the closed-loop autoscaler: an
    injected rank death blacklists its host (shrink to np=2, recorded by
    the controller), an SLO load spike (every cycle violates a 1 µs
    objective, so the burn rate pegs on BOTH windows) holds scale-up
    pressure, and when the blacklist cooldown lapses the controller
    grows the job back to np=4 through the membership-epoch bump.
    Asserts exact state continuity across both resizes and that every
    decision surfaced as ``hvd_autoscale_*`` metrics and flight-recorder
    events in the driver process."""
    from ..autoscale import PolicyConfig
    from ..obs import REGISTRY
    from ..obs import flightrec
    from ..runner.elastic import ElasticDriver, FixedDiscovery

    _predictive_grow_leg()

    work = tempfile.mkdtemp(prefix="hvdtpu_chaos_as_")
    die_latch = os.path.join(work, "die.latch")
    # Death lands a few steps in (each step is 5 engine dispatches after
    # the 4 init broadcasts); the once-latch keeps the relaunched
    # incarnations alive.
    env = _scenario_env(
        work, f"dispatch:rank=1:die:after=24:once={die_latch}",
        _MOE_TOTAL_STEPS)
    # The load spike: any activity violates a 1 us cycle objective,
    # pegging hvd_slo_burn_rate on both windows.
    env.update({"HVDTPU_SLO": "p99(cycle) < 1us",
                "HVDTPU_SLO_TICK_SECONDS": "0.5"})
    state_path, log_path = env["HVDTPU_CHAOS_STATE"], env["HVDTPU_CHAOS_LOG"]
    # Short cooldown: the dead rank's host comes back ~12s after the
    # blacklist, which is when the grow leg of the loop can fire.
    driver = ElasticDriver(
        FixedDiscovery("localhost:2,127.0.0.1:2"),
        min_np=2, max_np=4, blacklist_cooldown_s=12.0)
    policy = PolicyConfig(
        min_np=2, max_np=4,
        burn_threshold=1.0,
        scale_up_cooldown_s=1.0,      # re-bump fast if one is absorbed
        scale_down_cooldown_s=600.0,  # never shrink voluntarily here
        stale_after_s=15.0)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.chaos.run",
           "--moe-worker"]
    t0 = time.monotonic()
    code = driver.run_job(cmd, extra_env=env, max_restarts=5,
                          slot_timeout_s=60.0,
                          autoscale=policy, autoscale_interval_s=0.5,
                          launch_kwargs={"verbose": verbose,
                                         "connectivity_check": False})
    dt = time.monotonic() - t0
    assert code == 0, f"autoscale chaos job failed with exit code {code}"
    assert dt < ELASTIC_BUDGET_S, \
        f"recovery not bounded: took {dt:.0f}s > {ELASTIC_BUDGET_S:.0f}s"
    assert os.path.exists(die_latch), "injected death never fired"

    lines = open(log_path).read().splitlines()
    assert not any(ln.startswith("BAD") for ln in lines), \
        [ln for ln in lines if ln.startswith("BAD")]
    assert "START rank=0 size=4" in lines, lines
    shrunk = [int(ln.split("resume_step=")[1]) for ln in lines
              if ln.startswith("RESUME rank=0 size=2 ")]
    assert shrunk and all(s > 0 for s in shrunk), \
        "no np=2 resume:\n" + "\n".join(lines)
    regrown = [int(ln.split("resume_step=")[1]) for ln in lines
               if ln.startswith("RESUME rank=0 size=4 ")
               and int(ln.split("resume_step=")[1]) > 0]
    assert regrown, "never grew back to np=4:\n" + "\n".join(lines)
    assert min(regrown) > min(shrunk), (shrunk, regrown)
    assert any(ln.startswith(f"DONE rank=0 size=4 "
                             f"step={_MOE_TOTAL_STEPS}")
               for ln in lines), lines
    assert json.load(open(state_path))["step"] == _MOE_TOTAL_STEPS

    snap = {f["name"]: f for f in REGISTRY.snapshot()}
    decisions = {s["labels"]["action"]: s["value"]
                 for s in snap["hvd_autoscale_decisions_total"]["samples"]}
    assert decisions.get("shrink", 0) >= 1, decisions
    assert decisions.get("grow", 0) >= 1, decisions
    assert decisions.get("grow_predicted", 0) >= 1, decisions
    assert snap["hvd_autoscale_target_np"]["samples"][0]["value"] == 4.0, \
        snap["hvd_autoscale_target_np"]["samples"]
    assert snap["hvd_autoscale_rendezvous_bumps_total"]["samples"][0][
        "value"] >= 1
    actions = {e.get("name") for e in flightrec.RECORDER.snapshot()
               if e.get("kind") == "autoscale_decision"}
    assert {"shrink", "grow", "grow_predicted"} <= actions, actions
    print(f"CHAOS-AUTOSCALE-OK 4->2->4 decisions={decisions} "
          f"wall={dt:.0f}s")


# ---------------------------------------------------------------------------
# scenario: determinism (same seed => identical fault sequence)
# ---------------------------------------------------------------------------

def scenario_determinism() -> None:
    from . import FaultInjector, parse_spec
    from ..obs import REGISTRY

    spec = ("kv_get:err:p=0.02:seed=7; kv_put:err:p=0.1:seed=5; "
            "negotiate:delay=1ms:p=0.05:seed=3")
    schedule = (["kv_get"] * 400 + ["kv_put"] * 200
                + ["negotiate"] * 300)

    def drive() -> tuple:
        inj = FaultInjector(parse_spec(spec))
        before = REGISTRY.get("hvd_faults_injected_total").total()
        for site in schedule:
            try:
                inj.fire(site)
            except ConnectionError:
                pass
        return (inj.fired_events(),
                REGISTRY.get("hvd_faults_injected_total").total() - before)

    events_a, count_a = drive()
    events_b, count_b = drive()
    assert events_a == events_b, "same seed, different fault sequence"
    assert count_a == count_b and count_a > 0, (count_a, count_b)
    print(f"CHAOS-DETERMINISM-OK {count_a:.0f} faults, "
          "bit-identical sequence on re-run")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.chaos.run",
        description="chaos scenario harness")
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)   # internal np=4 worker
    p.add_argument("--moe-worker", action="store_true",
                   help=argparse.SUPPRESS)   # internal MoE worker
    p.add_argument("--scenario", default="all",
                   choices=("all", "elastic", "autoscale", "determinism",
                            *_WAITING))
    p.add_argument("--np", type=int, default=4, dest="np_total")
    p.add_argument("--verbose", "-v", action="store_true")
    args = p.parse_args(argv)
    if args.worker:
        return worker_main()
    if args.moe_worker:
        return moe_worker_main()
    if args.scenario in _WAITING:
        print(f"chaos: --scenario {args.scenario} ({_WAITING[args.scenario]}"
              f") is not ported to horovod_tpu_torch yet ({_WAITING_ITEM})",
              file=sys.stderr)
        return 2
    if args.scenario == "autoscale":
        # Not in "all": a full 4->2->4 resize circle with real cooldowns.
        scenario_autoscale(verbose=args.verbose)
    if args.scenario in ("all", "elastic"):
        scenario_elastic(args.np_total, verbose=args.verbose)
    if args.scenario in ("all", "determinism"):
        scenario_determinism()
    print("CHAOS-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
