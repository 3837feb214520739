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
- **serving** (np=1, in-process): a live serving session takes an
  injected engine-step fault mid-decode; in-flight requests finish with
  ``finish_reason="error"`` (partial tokens kept), ``/healthz`` goes
  200 → 503 (the drain window) → 200, and a request after the recovery
  completes normally.
- **router** (two replica processes behind the front door's router over
  the native KV store): a ``serving_step:die`` kills one replica
  mid-stream; every request completes on the survivor token-identical to
  greedy ``generate``, the router records failovers, and
  ``hvd_router_replica_healthy`` and ``/healthz`` show the dead/live split.
- **disagg** (four replica processes, 2 prefill + 2 decode, behind the
  ``DisaggRouter``): a ``mig_export:die`` kills a prefill replica between
  its migration blobs; every request completes token-identical through
  the migration path, the decode pool never dips, and one ``/tracez``
  pull shows a migrated request as one trace across at least three
  processes.
- **determinism**: the same seeded spec driven over the same traversal
  schedule twice produces the bit-identical fault sequence.

Every scenario runs on the CPU (the tiny model, Gloo).  Exit 0 iff every
selected scenario passes.  ``--worker``, ``--moe-worker``,
``--router-worker`` and ``--disagg-worker`` are the internal worker entry
points.
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

_MOE_D, _MOE_E, _MOE_T = 8, 4, 16


def moe_inputs(me: int, n: int, step: int):
    """The expert-parallel worker's inputs at one step: this rank's
    tokens ``[T, D]`` (seeded by rank and step), the router ``[D, E]``
    and this rank's slice of a fixed expert table, so any world size n
    with ``E % n == 0`` computes with the same experts (the JAX
    package's worker draws the same numbers)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    router = torch.from_numpy(rng.randn(_MOE_D, _MOE_E).astype(np.float32))
    w_full = torch.from_numpy(
        rng.randn(_MOE_E, _MOE_D, _MOE_D).astype(np.float32))
    e_local = _MOE_E // n
    toks = torch.from_numpy(np.random.RandomState(1000 * me + step).randn(
        _MOE_T, _MOE_D).astype(np.float32))
    return toks, router, w_full[me * e_local:(me + 1) * e_local]


def moe_layer(toks, router, experts):
    """The worker's layer: the ported ``moe_layer_hvd`` with the JAX
    package's worker's expert (``tanh(x @ w)``), capacity factor 1.25 and
    drop label ``chaos``.  Returns (outputs, aux, dropped)."""
    import torch

    from ..parallel.moe import moe_layer_hvd
    return moe_layer_hvd(toks, router, lambda w, x: torch.tanh(x @ w),
                         experts, capacity_factor=1.25, layer="chaos")


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

    state = FileBackedState(state_path, step=0)
    log_line(f"RESUME rank={me} size={n} resume_step={state.step}")

    @hvd.elastic.run
    def train(state):
        for step in range(state.step, total):
            toks, router, experts = moe_inputs(me, n, step)
            out, aux, _ = moe_layer(toks, router, experts)
            if out.shape != toks.shape or not bool(torch.isfinite(out).all()) \
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
    # Death lands a few steps in (each step is 4 engine dispatches, the
    # layer's three alltoalls and the probe's allreduce, after the 4 init
    # broadcasts); the once-latch keeps the relaunched incarnations alive.
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
# the tiny model every serving scenario runs (replicas and the parent
# build the same weights from the same seed)
# ---------------------------------------------------------------------------

def _tiny_model():
    import torch

    from ..models import llama
    cfg = llama.LlamaConfig.tiny()
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")


def _greedy_oracle(cfg, params):
    import numpy as np
    import torch

    from ..models import llama

    def oracle(prompt, m):
        p = torch.as_tensor(np.asarray(prompt, np.int64))[None]
        full = llama.generate(params, p, cfg, max_new_tokens=m)[0]
        return [int(t) for t in full[p.shape[1]:]]
    return oracle


def _replica_session(cfg, params):
    from .. import serving
    return serving.serve(params, cfg, device="cpu", num_blocks=64,
                         block_size=8, max_active=4, use_flash="never",
                         prefix_cache=True)


def _replica_env(prefix: str) -> tuple:
    """A KV store for the fleet, and the env its replica workers share."""
    import secrets

    from .._native import KvServer

    kv_srv = KvServer(secret=os.environ.setdefault(
        "HVDTPU_SECRET", secrets.token_hex(8)))
    os.environ["HVDTPU_RENDEZVOUS_ADDR"] = f"127.0.0.1:{kv_srv.port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in (os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
            os.environ.get("PYTHONPATH", "")) if p])
    env["OMP_NUM_THREADS"] = "1"
    env.pop("HVDTPU_FAULTS", None)
    # An injected death dumps a flight-recorder bundle; keep it out of
    # the caller's cwd.
    env["HVDTPU_FLIGHT_RECORDER_DIR"] = tempfile.mkdtemp(prefix=prefix)
    return kv_srv, env


def _wait_registered(kv, ranks, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(kv.get(f"fd/member/{r}") is not None
               and kv.get(f"obs/rank/{r}/meta") is not None
               for r in ranks):
            return
        time.sleep(0.1)
    raise AssertionError(f"replicas {list(ranks)} never registered")


# ---------------------------------------------------------------------------
# scenario: serving degradation + /healthz transitions (np=1)
# ---------------------------------------------------------------------------

def _healthz(port: int) -> int:
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def scenario_serving() -> None:
    import numpy as np

    import horovod_tpu_torch as hvd
    from . import arm, disarm
    from .. import serving
    from ..obs import server

    hvd.init(config=hvd.Config(platform="cpu"))
    srv = server.MetricsServer(0, addr="127.0.0.1")
    try:
        cfg, params = _tiny_model()
        sess = serving.serve(params, cfg, device="cpu", num_blocks=16,
                             block_size=8, max_active=2,
                             recovery_pause_s=0.75)
        with sess:
            assert _healthz(srv.port) == 200
            # Arm + submit BEFORE the loop starts so step 1 admits both
            # requests and step 2 (the armed traversal) aborts both.
            arm("serving_step:err:after=2:times=1")
            futs = [sess.submit(np.arange(4, dtype=np.int32) + r,
                                max_tokens=8) for r in range(2)]
            sess.start()
            # 200 -> 503 (the drain window) ...
            deadline = time.monotonic() + 30.0
            saw_503 = False
            while time.monotonic() < deadline:
                if _healthz(srv.port) == 503:
                    saw_503 = True
                    break
                time.sleep(0.02)
            assert saw_503, "healthz never went 503 during the abort"
            # ... -> 200 again after the recovery.
            while time.monotonic() < deadline:
                if _healthz(srv.port) == 200:
                    break
                time.sleep(0.05)
            assert _healthz(srv.port) == 200, \
                "healthz never recovered to 200"
            for f in futs:
                res = f.result(timeout=60)
                assert res.metrics["finish_reason"] == "error", res.metrics
            assert sess.recoveries == 1, sess.recoveries
            # The degraded session is a live session: post-recovery
            # traffic completes normally.
            res = sess.submit(np.arange(5, dtype=np.int32),
                              max_tokens=4).result(timeout=60)
            assert res.metrics["finish_reason"] == "length", res.metrics
            assert len(res.tokens) == 4
    finally:
        disarm()
        srv.close()
        hvd.shutdown()
    print("CHAOS-SERVING-OK healthz 200->503->200, aborts carry "
          "finish_reason=error")


# ---------------------------------------------------------------------------
# scenario: router failover across np=2 serving replicas
# ---------------------------------------------------------------------------

def router_worker_main(rank: int) -> int:
    """One serving replica behind the front-door transport: session +
    ReplicaServer + RankPublisher + /healthz endpoint, serving until the
    parent writes ``fd/stop``.  Rank 1 carries an injected mid-stream
    death (``serving_step:die`` via env, armed at package import)."""
    from ..context import component_health
    from ..obs import flightrec, server
    from ..obs.aggregate import RankPublisher, _kv_from_env
    from ..serving.frontdoor.transport import ReplicaServer

    # No hvd.init() in this worker (single-process serving), so arm the
    # flight recorder's dump directory from the env directly — the
    # injected death dumps unconditionally and must not litter the cwd.
    flightrec.RECORDER.arm(os.environ.get("HVDTPU_FLIGHT_RECORDER_DIR"))
    sess = _replica_session(*_tiny_model())
    server.set_health_provider(
        lambda: {"ready": bool(component_health("serving")),
                 "status": "ok", "rank": rank})
    srv = server.MetricsServer(0, addr="127.0.0.1")
    kv = _kv_from_env()
    kv.set(f"fd/port/{rank}", str(srv.port).encode())
    replica = ReplicaServer(sess, rank).start()
    pub = RankPublisher(rank, 2, interval_s=0.5).start()
    sess.start()
    try:
        while kv.get("fd/stop") is None:
            time.sleep(0.1)
    finally:
        pub.stop()
        replica.stop()
        sess.close()
        srv.close()
    return 0


def scenario_router() -> None:
    """np=2 replicas + router; a ``serving_step:die`` kills one replica
    mid-stream.  Asserts: every in-flight request completes on the
    survivor token-identical to the greedy reference, the router
    recorded failovers, ``hvd_router_replica_healthy`` and ``/healthz``
    reflect the dead/live split, and the dead worker exited with the
    injected ``DIE_EXIT_CODE``."""
    import subprocess
    import urllib.error
    import urllib.request

    import numpy as np

    from . import DIE_EXIT_CODE
    from .._native import KvClient
    from ..obs import REGISTRY
    from ..serving.frontdoor import Router, RouterConfig
    from ..serving.frontdoor.transport import KVReplicaClient

    kv_srv, env_base = _replica_env("hvdtpu-fd-flightrec-")
    workers = []
    for rank in range(2):
        env = dict(env_base)
        if rank == 1:
            # Dies on its 6th serving round — mid-stream of every
            # request placed on it (each needs ~max_tokens rounds).
            env["HVDTPU_FAULTS"] = "serving_step:die:after=6"
        workers.append(subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.chaos.run",
             "--router-worker", str(rank)], env=env))
    kv = KvClient("127.0.0.1", kv_srv.port, timeout_ms=5000)
    try:
        _wait_registered(kv, range(2), 90.0)
        ports = {r: int(kv.get(f"fd/port/{r}").decode()) for r in range(2)}
        oracle = _greedy_oracle(*_tiny_model())

        router = Router([KVReplicaClient(r, kv) for r in range(2)],
                        RouterConfig(max_attempts=4))
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, 256, size=(8 + 2 * i,)).astype(np.int32)
                   for i in range(6)]
        futs = [router.submit(p, 16) for p in prompts]
        router.drain(timeout_s=150.0)

        for p, f in zip(prompts, futs):
            res = f.result(timeout=5)
            assert res.metrics["finish_reason"] == "length", res.metrics
            assert res.tokens == oracle(p, 16), (res.tokens, oracle(p, 16))
        assert router.failovers >= 1, \
            "the injected death never forced a failover"

        # Health gauges + /healthz reflect the dead/live split.  The
        # gauge tracks snapshot freshness, so pump until the survivor's
        # next publish lands.
        healthy = {}
        gauge_deadline = time.monotonic() + 30.0
        while time.monotonic() < gauge_deadline:
            router.pump()
            healthy = {
                s["labels"]["replica"]: s["value"]
                for fam in REGISTRY.snapshot()
                if fam["name"] == "hvd_router_replica_healthy"
                for s in fam["samples"]}
            if healthy.get("0") == 1.0 and healthy.get("1") == 0.0:
                break
            time.sleep(0.1)
        assert healthy.get("0") == 1.0, healthy
        assert healthy.get("1") == 0.0, healthy
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ports[0]}/healthz", timeout=5) as r:
            assert r.status == 200
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{ports[1]}/healthz", timeout=5)
            raise AssertionError("dead replica's /healthz still answers")
        except (urllib.error.URLError, ConnectionError, OSError):
            pass

        kv.set("fd/stop", b"1")
        assert workers[1].wait(timeout=30) == DIE_EXIT_CODE, \
            workers[1].returncode
        assert workers[0].wait(timeout=30) == 0, workers[0].returncode
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        kv.close()
        kv_srv.stop()
    print(f"CHAOS-ROUTER-OK np=2 failovers={router.failovers} "
          f"(in-flight requests finished token-identical on the "
          f"survivor)")


# ---------------------------------------------------------------------------
# scenario: disaggregated prefill/decode with a mid-migration kill
# ---------------------------------------------------------------------------

def disagg_worker_main(rank: int, pool: str) -> int:
    """One pool-tagged disagg replica: session + ReplicaServer +
    RankPublisher + TracePublisher, serving until the parent writes
    ``fd/stop``.  The victim prefill rank carries ``mig_export:die``
    (armed via env at package import) so it dies between migration blob
    publishes."""
    from ..obs import flightrec
    from ..obs.aggregate import RankPublisher, _kv_from_env
    from ..obs.tracemerge import TracePublisher
    from ..serving.frontdoor.transport import ReplicaServer

    flightrec.RECORDER.arm(os.environ.get("HVDTPU_FLIGHT_RECORDER_DIR"))
    sess = _replica_session(*_tiny_model())
    kv = _kv_from_env()
    replica = ReplicaServer(sess, rank, pool=pool).start()
    # 2s cadence -> 4s staleness tolerance: four CPU replicas decoding at
    # once starve publisher threads for >1s routinely, and a transiently
    # late DECODE publish must not read as a pool dip when the fault
    # targets a PREFILL rank.
    pub = RankPublisher(rank, 4, interval_s=2.0).start()
    # Fleet trace plane: publish ended spans + answer clock pings so the
    # parent's /tracez shows the migrated request as one connected
    # chain across processes.
    tpub = TracePublisher(rank, pool=pool, interval_s=1.0).start()
    sess.start()
    try:
        while kv.get("fd/stop") is None:
            time.sleep(0.1)
    finally:
        tpub.stop()
        pub.stop()
        replica.stop()
        sess.close()
    return 0


def _tracez_chain(kv_port: int, artifact_dir: str) -> tuple:
    """Serve ``/tracez`` from this (router) process over the workers'
    trace publishers, pull it once over HTTP, and check that the merged
    Perfetto view shows a migrated request as ONE trace id spanning at
    least three processes, with cross-process flow arrows, per-lane
    monotonic spans and a critical-path report.  Writes the artefact;
    returns (trace id, processes, artefact path)."""
    import urllib.request
    from collections import defaultdict

    from .._native import KvClient
    from ..obs import server as obs_server
    from ..obs.tracemerge import TraceCollector

    collector = TraceCollector(
        own_rank=4, own_pool="router",
        kv_factory=lambda: KvClient("127.0.0.1", kv_port, timeout_ms=5000))
    obs_server.set_trace_provider(collector.collect)
    srv = obs_server.MetricsServer(0, addr="127.0.0.1")
    try:
        merged, chain_tid, by_tid = None, None, {}
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/tracez",
                    timeout=10) as resp:
                merged = json.loads(resp.read().decode())
            by_tid = defaultdict(set)
            for ev in merged["traceEvents"]:
                if ev.get("ph") == "X" and \
                        ev.get("args", {}).get("trace_id"):
                    by_tid[ev["args"]["trace_id"]].add(ev["pid"])
            spanning = [t for t, pids in by_tid.items() if len(pids) >= 3]
            if spanning:
                chain_tid = spanning[0]
                break
            time.sleep(0.5)     # worker publishers on a 1s cadence
        assert chain_tid is not None, \
            "no trace spans >= 3 processes in the merged /tracez view"
        flows = [ev for ev in merged["traceEvents"]
                 if ev.get("cat") == "trace" and ev.get("ph") in ("s", "f")]
        assert flows, "merged trace has no cross-process flow arrows"
        lanes = defaultdict(list)
        for ev in merged["traceEvents"]:
            if ev.get("ph") == "X":
                lanes[(ev["pid"], ev["tid"])].append(ev["ts"])
        assert all(ts == sorted(ts) for ts in lanes.values()), \
            "merged trace is not monotonic per lane"
        report = merged.get("report", {})
        assert report.get("dominant_phase") is not None \
            and report.get("dominant_rank") is not None, report
        artifact = os.environ.get(
            "HVDTPU_TRACE_ARTIFACT",
            os.path.join(artifact_dir, "disagg_tracez.json"))
        with open(artifact, "w") as fh:
            json.dump(merged, fh)
    finally:
        obs_server.set_trace_provider(None)
        collector.close()
        srv.close()
    return chain_tid, len(by_tid[chain_tid]), artifact


def scenario_disagg() -> None:
    """np=4 disaggregated fleet (2 prefill + 2 decode replicas); a
    ``mig_export:die`` kills one prefill replica between its migration
    blob publishes (K landed, manifest did not).  Asserts: every
    request completes token-identical to the greedy reference AND took
    the migration path (``metrics["migrated"]``), exactly once on the
    stream, the router recorded the prefill-stage failover,
    ``hvd_disagg_pool_replicas{pool="decode"}`` never dropped below 2
    (decode pool untouched by a prefill kill), the victim exited with
    ``DIE_EXIT_CODE``, and one ``/tracez`` pull shows a migrated request
    as one connected trace across at least three processes (written as
    the ``disagg_tracez.json`` artefact)."""
    import subprocess

    import numpy as np

    from . import DIE_EXIT_CODE
    from .._native import KvClient
    from ..obs import REGISTRY
    from ..serving.disagg import DisaggRouter, DisaggRouterConfig
    from ..serving.frontdoor.transport import KVReplicaClient

    kv_srv, env_base = _replica_env("hvdtpu-disagg-flightrec-")
    die_latch = os.path.join(
        tempfile.mkdtemp(prefix="hvdtpu-disagg-latch-"), "die")
    pools = {0: "prefill", 1: "prefill", 2: "decode", 3: "decode"}
    workers = []
    for rank, pool in pools.items():
        env = dict(env_base)
        if rank == 0:
            # Dies on its second mig_export traversal: the K payload is
            # published, the V payload and manifest are not — the
            # durable-point probe must come up empty and the router
            # must re-prefill from the prompt on the pool survivor.
            env["HVDTPU_FAULTS"] = \
                f"mig_export:die:after=2:once={die_latch}"
        workers.append(subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.chaos.run",
             "--disagg-worker", str(rank), pool], env=env))
    kv = KvClient("127.0.0.1", kv_srv.port, timeout_ms=5000)
    try:
        _wait_registered(kv, range(4), 120.0)
        oracle = _greedy_oracle(*_tiny_model())
        clients = [KVReplicaClient(r, kv) for r in range(4)]
        assert [c.pool for c in clients] == \
            ["prefill", "prefill", "decode", "decode"], \
            [c.pool for c in clients]
        router = DisaggRouter(clients, kv,
                              DisaggRouterConfig(max_attempts=6))
        rng = np.random.RandomState(11)
        prompts = [rng.randint(0, 256, size=(8 + 2 * i,)).astype(np.int32)
                   for i in range(4)]
        streamed: dict[int, list] = {}
        futs = [router.submit(
            p, 16,
            stream_cb=lambda fid, t: streamed.setdefault(
                fid, []).append(t)) for p in prompts]

        # Drain by hand so the decode-pool health gauge is sampled on
        # every pump — "never drops" holds at every pass, not just at
        # the end.
        decode_gauge = REGISTRY.get("hvd_disagg_pool_replicas")
        min_decode = float("inf")
        drain_deadline = time.monotonic() + 240.0
        while router._flights:
            router.pump()
            min_decode = min(min_decode,
                             decode_gauge.labels(pool="decode").value)
            if not router._flights:
                break
            if time.monotonic() > drain_deadline:
                raise AssertionError(
                    f"disagg drain stuck: "
                    f"{[(f.fid, f.state) for f in router._flights.values()]}")
            time.sleep(0.05)

        for i, (p, f) in enumerate(zip(prompts, futs)):
            res = f.result(timeout=5)
            want = oracle(p, 16)
            assert res.tokens == want, (i, res.tokens, want)
            assert res.metrics["migrated"] is True, (i, res.metrics)
            assert res.metrics["finish_reason"] == "length", res.metrics
            # Exactly-once streaming under replay.
            assert streamed.get(i, []) == want, (i, streamed.get(i), want)
        assert router.failovers >= 1, \
            "the mid-migration death never forced a failover"
        assert min_decode >= 2.0, \
            f"decode pool dipped to {min_decode} after a PREFILL kill"
        chain_tid, n_procs, artifact = _tracez_chain(
            kv_srv.port, env_base["HVDTPU_FLIGHT_RECORDER_DIR"])

        kv.set("fd/stop", b"1")
        assert workers[0].wait(timeout=30) == DIE_EXIT_CODE, \
            workers[0].returncode
        for w in workers[1:]:
            assert w.wait(timeout=30) == 0, w.returncode
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        kv.close()
        kv_srv.stop()
    print(f"CHAOS-DISAGG-OK np=4 (2 prefill + 2 decode) "
          f"failovers={router.failovers} min_decode_pool={min_decode:.0f} "
          f"(mid-migration prefill kill, token-identical completion; "
          f"/tracez chain {chain_tid} spans {n_procs} processes -> "
          f"{artifact})")


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
    p.add_argument("--router-worker", type=int, default=None,
                   metavar="RANK",
                   help=argparse.SUPPRESS)   # internal router replica
    p.add_argument("--disagg-worker", nargs=2, default=None,
                   metavar=("RANK", "POOL"),
                   help=argparse.SUPPRESS)   # internal disagg replica
    p.add_argument("--scenario", default="all",
                   choices=("all", "elastic", "serving", "determinism",
                            "router", "autoscale", "disagg"))
    p.add_argument("--np", type=int, default=4, dest="np_total")
    p.add_argument("--verbose", "-v", action="store_true")
    args = p.parse_args(argv)
    if args.worker:
        return worker_main()
    if args.moe_worker:
        return moe_worker_main()
    if args.router_worker is not None:
        return router_worker_main(args.router_worker)
    if args.disagg_worker is not None:
        return disagg_worker_main(int(args.disagg_worker[0]),
                                  args.disagg_worker[1])
    # Not in "all": the disagg and router scenarios start four and two
    # serving replicas, and autoscale runs a full 4->2->4 resize circle
    # with real cooldowns.
    if args.scenario == "disagg":
        scenario_disagg()
    if args.scenario == "router":
        scenario_router()
    if args.scenario == "autoscale":
        scenario_autoscale(verbose=args.verbose)
    if args.scenario in ("all", "elastic"):
        scenario_elastic(args.np_total, verbose=args.verbose)
    if args.scenario in ("all", "serving"):
        scenario_serving()
    if args.scenario in ("all", "determinism"):
        scenario_determinism()
    print("CHAOS-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
