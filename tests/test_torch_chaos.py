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
- the serving scenario (an injected step fault: aborts with
  ``finish_reason="error"``, ``/healthz`` 200 → 503 → 200), the router
  scenario (two replica processes behind the front door's router, one
  killed mid-stream) and the disagg scenario (2 prefill + 2 decode replica
  processes, a prefill replica killed mid-migration, one ``/tracez``
  trace across at least three processes), each in tier 1: the reference
  slow-marks the router and disagg harnesses for their JAX replicas'
  start-up, but the port's finish in well under a minute on the CPU;
- serving's rejoin after an injected ``HorovodInternalError``: a
  ``dispatch:err`` fault under a live session's step aborts the in-flight
  request, the runtime is re-initialized in the process, and serving goes
  on.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.chaos import run as chaos_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=120, env=None):
    env = dict({k: v for k, v in os.environ.items()
                if not k.startswith(("HVDTPU_", "HOROVOD_"))}, **(env or {}))
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
def test_scenarios_of_later_slices_exit_2_naming_their_item(scenario,
                                                             tmp_path):
    """The three scenarios that exited 2 before their slice was ported
    (the name is kept with its cases) now run and pass."""
    ok = f"CHAOS-{scenario.upper()}-OK"
    res = _run("--scenario", scenario, timeout=300,
               env={"TMPDIR": str(tmp_path)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert ok in res.stdout, res.stdout
    assert "CHAOS-OK" in res.stdout, res.stdout
    if scenario == "disagg":
        trace = json.loads((next(tmp_path.glob(
            "hvdtpu-disagg-flightrec-*")) / "disagg_tracez.json").read_text())
        assert trace["traceEvents"] and trace["report"]["dominant_phase"]


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


def test_moe_worker_layer_equals_the_references_at_np2(tmp_path):
    """The expert-parallel worker's layer (the ported ``moe_layer_hvd``,
    ``tanh(x @ w)`` experts, capacity factor 1.25, drops counted under
    ``layer="chaos"``) at np=2, step by step on the worker's inputs,
    against the JAX package's ``moe_layer_hvd`` driving the same two
    ranks' tokens in this process (its runtime re-initialized over two
    CPU devices): outputs within 1e-5, dropped rows exactly 0 in both,
    the aux within 1e-5 and the drops equal."""
    import jax
    import jax.numpy as jnp

    import horovod_tpu as jhvd
    import mp_torch_dataplane_worker as DW
    from horovod_tpu.parallel.moe import moe_layer_hvd

    DW.check_ranks(DW.launch("chaos_moe", str(tmp_path), 2))
    ranks = DW.load("chaos_moe", tmp_path, 2)
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    try:
        for step in range(DW.CHAOS_STEPS):
            ins = [chaos_run.moe_inputs(r, 2, step) for r in range(2)]
            outs, aux, dropped = moe_layer_hvd(
                [t.numpy() for t, _, _ in ins], ins[0][1].numpy(),
                lambda w, x: jnp.tanh(x @ w),
                [jnp.asarray(e.numpy()) for _, _, e in ins],
                capacity_factor=1.25, layer="chaos")
            got_drops = 0
            for r, (arrays, info) in enumerate(ranks):
                got, want = arrays[f"step{step}"], np.asarray(outs[r])
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
                np.testing.assert_array_equal((got == 0).all(axis=1),
                                              (want == 0).all(axis=1))
                got_drops += info[f"step{step}"]["dropped"]
                assert info[f"step{step}"]["counted"] == \
                    info[f"step{step}"]["dropped"]
            assert got_drops == dropped
            np.testing.assert_allclose(
                np.mean([info[f"step{step}"]["aux"] for _, info in ranks]),
                aux, rtol=1e-5)
    finally:
        jhvd.shutdown()
        jhvd.init()
