"""Port parity: the chaos scenario harness
(``python -m horovod_tpu_torch.chaos.run``) and recovery from an injected
collective failure.

- the elastic scenario at np=4 → 2 on the CPU: one injected rank death,
  flaky KV and delayed negotiation; the driver blacklists the dead rank's
  host, relaunches at np=2 from the last commit, every step's allreduce
  equals the world size, and the dead rank's flight-recorder bundle names
  the fault (the reference's ``scenario_elastic``);
- the determinism scenario;
- the autoscale scenario (np=4 → 2 → 4, about 50 s), slow-marked as the
  reference's harness is (``tests/test_runner.py:580``);
- the scenarios that wait for later slices exit 2 naming their item;
- serving's rejoin after an injected ``HorovodInternalError``: a
  ``dispatch:err`` fault under a live session's step aborts the in-flight
  request, the runtime is re-initialized in the process, and serving goes
  on.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.chaos import run as chaos_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=120):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.chaos.run", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def test_elastic_scenario_np4_to_np2():
    res = _run("--scenario", "elastic")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "CHAOS-ELASTIC-OK np=4 rounds=2" in res.stdout, res.stdout
    assert "blacklisted host localhost" in res.stderr, res.stderr


def test_determinism_scenario():
    chaos_run.scenario_determinism()


@pytest.mark.parametrize("scenario", ["serving", "router", "disagg"])
def test_scenarios_of_later_slices_exit_2_naming_their_item(scenario):
    res = _run("--scenario", scenario, timeout=60)
    assert res.returncode == 2
    assert "not ported" in res.stderr
    assert "'Parallel strategies, and what needs them'" in res.stderr


@pytest.mark.slow  # as the reference's autoscale harness
def test_autoscale_recovery_scenario_harness():
    res = _run("--scenario", "autoscale", timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "CHAOS-AUTOSCALE-OK" in res.stdout, res.stdout
    assert "CHAOS-OK" in res.stdout, res.stdout


def test_serving_rejoins_after_an_injected_collective_failure(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import chaos, context, serving
    from horovod_tpu_torch.models import llama
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    hvd.init(config=hvd.Config(platform="cpu"))
    try:
        first = hvd.global_state().engine
        with serving.serve(params, cfg, device="cpu", num_blocks=16,
                           block_size=8, max_active=2) as sess:
            real_step = sess.engine.step
            ticks = [0]

            def step_with_a_collective():
                # a replica's tick that takes part in a collective
                ticks[0] += 1
                hvd.allreduce(torch.ones(2), hvd.Sum, name=f"t{ticks[0]}")
                return real_step()

            monkeypatch.setattr(sess.engine, "step", step_with_a_collective)
            chaos.arm("dispatch:err:after=1:times=1")
            fut = sess.submit(np.arange(4, dtype=np.int32), 4)
            sess.drain()
            chaos.disarm()
            assert fut.result(timeout=0).metrics["finish_reason"] == "error"
            assert sess.recoveries == 1
            assert hvd.global_state().engine is not first
            assert context.component_health("serving") is True
            again = sess.submit(np.arange(4, dtype=np.int32), 4)
            sess.drain()
            res = again.result(timeout=0)
            assert res.metrics["finish_reason"] != "error"
            assert len(res.tokens) == 4
    finally:
        chaos.disarm()
        hvd.shutdown()
