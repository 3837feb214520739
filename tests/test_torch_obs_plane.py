"""The rest of the port's observability plane at two ranks, under its
launcher, over Gloo on the CPU.

One job, ``python -m horovod_tpu_torch.runner -np 2 --platform cpu
--autotune --autotune-log D/autotune.log -- python
tests/mp_torch_port_worker.py plane D``, with ``HVDTPU_SLO``,
``HVDTPU_ALERTS`` and a fast time-series interval set
(``mp_torch_port_worker.PLANE_ENV``): ``init`` arms them and no longer
refuses; ``--autotune`` reaches both ranks and both tune; ranks whose
group caps differ still fuse alike (every allreduce equals the sum of
both ranks' inputs); the engine feeds the performance model series with
the JAX package's labels and a positive achieved bus bandwidth; the
profiler counts phases of the port's engine thread; rank 0's ``/tracez``
merges both ranks' step spans as ``pid`` 0 and 1.  And the plane's own
end-to-end check, ``python -m horovod_tpu_torch.obs.smoke``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mp_torch_port_worker as W
from horovod_tpu.obs import REGISTRY as REF_REGISTRY
from horovod_tpu.obs import perfmodel  # noqa: F401  (registers hvd_perf_*)


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    d = tmp_path_factory.mktemp("plane")
    log = d / "autotune.log"
    res = W.launch("plane", str(d), timeout=150, extra_env=W.PLANE_ENV,
                   flags=("--autotune", "--autotune-log", str(log)))
    for rc, text in res:
        assert rc == 0, text
    infos = [json.loads((d / f"plane.rank{r}.json").read_text())
             for r in range(W.NP)]
    arrays = [np.load(d / f"plane.rank{r}.npz") for r in range(W.NP)]
    return infos, arrays, log.read_text()


def test_init_accepts_slo_alerts_and_launcher_autotune(plane):
    infos, _, log = plane
    for info in infos:
        autotune, log_path, slo, alerts = info["config"]
        assert autotune is True and log_path.endswith("autotune.log")
        assert slo == W.PLANE_ENV["HVDTPU_SLO"]
        assert alerts == W.PLANE_ENV["HVDTPU_ALERTS"]
        assert info["jax_loaded"] is False
    assert log.count("sample #") >= 2        # both ranks scored trials


def test_ranks_with_different_caps_and_tuners_reduce_alike(plane):
    _, arrays, _ = plane
    for i in range(8):
        want = sum(W.engine_input("caps", r, i, 1000) for r in range(W.NP))
        for a in arrays:
            np.testing.assert_array_equal(a[f"caps.{i}"], want)
    for i in range(W.PLANE_STEPS):
        for j, n in enumerate(W.PLANE_SIZES):
            want = sum(W.engine_input("plane", r, i * 10 + j, n)
                       for r in range(W.NP))
            for a in arrays:
                np.testing.assert_array_equal(a[f"plane.{i}.{j}"], want)


def test_engine_feeds_the_performance_model(plane):
    infos, _, _ = plane
    ref_names = {n: REF_REGISTRY.get(n).labelnames for n in (
        "hvd_perf_efficiency", "hvd_perf_achieved_busbw_gbs",
        "hvd_perf_expected_busbw_gbs")}
    for info in infos:
        perf = info["perf"]
        for name in ref_names:
            [(labels, value)] = [s for s in perf[name]
                                 if s[0]["verb"] == "allreduce"]
            assert tuple(labels) == tuple(ref_names[name])
            assert labels == {"verb": "allreduce", "mode": "fp32",
                              "schedule": "monolithic", "tier": "flat"}
            assert value > 0
        [(labels, obs)] = [s for s in perf["hvd_perf_observations_total"]
                           if s[0] == {"verb": "allreduce"}]
        assert obs >= W.PLANE_STEPS


def test_profiler_counts_the_port_engine_threads_phases(plane):
    infos, _, _ = plane
    for info in infos:
        phases = info["engine_phases"]
        assert sum(phases.values()) > 0
        assert phases.get("negotiate", 0) + phases.get("dispatch", 0) > 0
    profz = infos[0]["/profz.json"]
    assert profz["samples"] > 0 and profz["hz"] == 100.0


def test_slo_and_alert_are_armed(plane):
    infos, _, _ = plane
    for info in infos:
        assert 0.0 <= info["slo"]["cycle"]["attainment"] <= 1.0
        [a] = info["alerts"]["alerts"]
        assert (a["alert"], a["state"]) == (W.PLANE_ALERT, "firing")
    assert infos[0]["/alertz.json"]["firing"] == 1


def test_rank0_tracez_merges_both_ranks(plane):
    infos, _, _ = plane
    assert all(info["published"] for info in infos)
    merged = infos[0]["/tracez"]
    assert merged["ranks"] == [0, 1]
    steps = [e for e in merged["traceEvents"]
             if e.get("ph") == "X" and e.get("name") == "plane.step"]
    assert {e["pid"] for e in steps} == {0, 1}
    assert sum(e["pid"] == 1 for e in steps) == W.PLANE_STEPS
    names = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
             if e.get("name") == "process_name"}
    assert names == {0: "rank 0", 1: "rank 1"}


def test_obs_smoke_exits_0(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = W.REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.obs.smoke"], cwd=W.REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "obs smoke OK: /cluster aggregated 2 worker processes" in \
        res.stdout
