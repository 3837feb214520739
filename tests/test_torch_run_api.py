"""Port parity: ``run_func``, the KV blob format and the probe stage.

``horovod_tpu_torch.runner.run_func`` ships a cloudpickled function over
the job's KV store, runs it on every rank as a real launcher job and
returns the rank-ordered results; these tests drive that full circle with
live subprocesses, on the cases of ``tests/test_run_api.py``.

The blob format is held against the JAX package's, byte for byte: a blob
written by one package's ``kv_put_blob`` is read back whole by the other's
``kv_get_blob`` over one KV server, at the chunk sizes of the reference's
test and around the 4 MiB chunk edge, and the keys both write are equal.

The probe cases of ``tests/test_probe.py`` run against the port's probe
module (``python -m horovod_tpu_torch.runner.probe``).
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from horovod_tpu._native import KvClient as RefKvClient
from horovod_tpu.runner import api as ref_api
from horovod_tpu.runner import probe as ref_probe
from horovod_tpu_torch._native import KvClient, KvServer
from horovod_tpu_torch.runner import api as port_api
from horovod_tpu_torch.runner.api import run_func
from horovod_tpu_torch.runner.probe import local_addresses, run_probe_stage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clean_env(monkeypatch):
    """The launcher's workers inherit this process's env: no job knobs,
    and the repo on the path."""
    for k in list(os.environ):
        if k.startswith(("HVDTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep +
                       os.environ.get("PYTHONPATH", ""))


# ---------------------------------------------------------------------------
# run_func
# ---------------------------------------------------------------------------

def _rank_info(mult):
    return {
        "rank": int(os.environ["HVDTPU_CROSS_RANK"]),
        "size": int(os.environ["HVDTPU_CROSS_SIZE"]),
        "x": int(os.environ["HVDTPU_CROSS_RANK"]) * mult,
        "secret": bool(os.environ.get("HVDTPU_SECRET")),
    }


def test_run_func_rank_ordered_results(clean_env):
    out = run_func(_rank_info, args=(10,), np=2)
    assert [o["rank"] for o in out] == [0, 1]
    assert all(o["size"] == 2 and o["secret"] for o in out)
    assert [o["x"] for o in out] == [0, 10]


def test_run_func_pickles_closures_by_value(clean_env):
    base = 5  # captured — only cloudpickle-by-value can ship this lambda
    out = run_func(
        lambda: base + int(os.environ["HVDTPU_CROSS_RANK"]), np=2)
    assert out == [5, 6]


def test_run_func_worker_exception_propagates(clean_env):
    def boom():
        if os.environ["HVDTPU_CROSS_RANK"] == "1":
            raise ValueError("rank1 exploded")
        return "ok"

    with pytest.raises(RuntimeError, match="rank1 exploded"):
        run_func(boom, np=2)


def test_run_func_failure_surfaces_past_hung_peer(clean_env):
    """A rank blocked forever must not hide another rank's traceback."""
    def hang_or_boom():
        if os.environ["HVDTPU_CROSS_RANK"] == "1":
            raise ValueError("fast failure")
        import time
        time.sleep(300)  # killed by the monitor once rank 1 exits

    with pytest.raises(RuntimeError, match="fast failure"):
        run_func(hang_or_boom, np=2)


def test_worker_module_does_not_shadow_function():
    import horovod_tpu_torch.runner as R
    import horovod_tpu_torch.runner._run_func_worker  # noqa: F401
    assert callable(R.run_func)


def _allreduce_job(scale):
    """A real job of the port: init from the injected env (Gloo on the
    CPU) and allreduce."""
    import torch

    import horovod_tpu_torch as hvd
    hvd.init()
    out = hvd.allreduce(torch.full((4,), float(hvd.rank()) * scale),
                        hvd.Sum, name="run_func.allreduce")
    n = hvd.size()
    hvd.shutdown()
    expect = scale * n * (n - 1) / 2
    assert float(out[0]) == expect, (float(out[0]), expect)
    return float(out[0])


def test_run_func_full_collective_job(clean_env):
    out = run_func(_allreduce_job, args=(2.0,), np=2,
                   extra_env={"HVDTPU_PLATFORM": "cpu"})
    assert out == [2.0, 2.0]


# ---------------------------------------------------------------------------
# the KV blob format, across the two packages
# ---------------------------------------------------------------------------

SIZES = [0, 1, 4 << 20, (4 << 20) + 12345]


@pytest.fixture(scope="module")
def kv_pair():
    srv = KvServer(secret="s")
    port = KvClient("127.0.0.1", srv.port, secret="s")
    ref = RefKvClient("127.0.0.1", srv.port, secret="s")
    yield port, ref
    port.close()
    ref.close()
    srv.stop()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_kv_blob_crosses_packages(kv_pair, size, writer):
    port, ref = kv_pair
    blob = os.urandom(size)
    prefix = f"t/{writer}/{size}"
    if writer == "port":
        port_api.kv_put_blob(port, prefix, blob)
        assert ref_api.kv_get_blob(ref, prefix, timeout_ms=5000) == blob
    else:
        ref_api.kv_put_blob(ref, prefix, blob)
        assert port_api.kv_get_blob(port, prefix, timeout_ms=5000) == blob
    n = max(1, -(-size // (4 << 20)))
    assert port.get(f"{prefix}/meta") == f"{n}:{size}".encode()
    assert port.get(f"{prefix}/{n}") is None


def test_kv_blob_keys_are_the_references(kv_pair):
    port, ref = kv_pair
    blob = os.urandom((4 << 20) + 7)
    port_api.kv_put_blob(port, "same/port", blob)
    ref_api.kv_put_blob(ref, "same/ref", blob)
    for key in ("meta", "0", "1"):
        assert port.get(f"same/port/{key}") == port.get(f"same/ref/{key}")


def test_kv_blob_torn_read_raises_in_both(kv_pair):
    port, ref = kv_pair
    port_api.kv_put_blob(port, "torn", b"abc")
    port.set("torn/meta", b"1:4")           # a rewrite caught mid-way
    for api, kv in ((port_api, port), (ref_api, ref)):
        with pytest.raises(ValueError, match="torn"):
            api.kv_get_blob(kv, "torn", timeout_ms=2000)


# ---------------------------------------------------------------------------
# probe stage († tests/test_probe.py, retargeted)
# ---------------------------------------------------------------------------

def test_local_addresses_match_reference_loopback_last():
    addrs = local_addresses()
    assert addrs, "no NIC addresses discovered"
    assert addrs == ref_probe.local_addresses()
    if len(addrs) > 1:
        assert not addrs[0].startswith("127."), addrs


def _probe_proc(host_key: str, kv_port: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.probe",
         host_key, "127.0.0.1", str(kv_port)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_probe_stage_end_to_end():
    with KvServer() as srv:
        kv = KvClient("127.0.0.1", srv.port)
        result = run_probe_stage(
            ["hostA", "hostB"], kv=kv,
            launch_fn=lambda h: _probe_proc(h, srv.port), timeout=60.0)
        kv.close()
    assert result["driver_addr"] == "127.0.0.1"
    assert set(result["host_addrs"]) == {"hostA", "hostB"}
    assert set(result["nics"]) == {"hostA", "hostB"}
    for addrs in result["nics"].values():
        assert addrs


def test_probe_stage_reports_unregistered_host():
    with KvServer() as srv:
        kv = KvClient("127.0.0.1", srv.port)

        def launch_fn(h):
            return subprocess.Popen(
                [sys.executable, "-c", "import sys; sys.exit(3)"])

        with pytest.raises(RuntimeError, match="hostBAD"):
            run_probe_stage(["hostBAD", "hostB"], kv=kv,
                            launch_fn=launch_fn, timeout=5.0)
        kv.close()


def test_probe_task_driver_unreachable():
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.probe",
         "hostX", "127.0.0.1", "1"],  # port 1: nothing listens
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 3, (proc.returncode, err)
    assert "driver unreachable" in err
