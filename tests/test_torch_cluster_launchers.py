"""The port's Spark and Ray launchers (``horovod_tpu_torch.spark``,
``horovod_tpu_torch.ray``) and its placement exchange
(``runner/cluster.py``) against the JAX package's, on the CPU.

The fake cluster managers are ``tests/test_cluster_launchers.py``'s,
imported, not copied: a fake ``pyspark`` whose barrier stage forks one
process per partition, and a fake ``ray`` whose actors are forked
processes, so the env blocks are truly per worker.  The reference's and
the port's launchers run under the same fake, and each rank's
``HVDTPU_*`` keys, cross rank, size, local rank and platform are held
equal between the two (secrets, ports and addresses are per job).
"""

import os
import socket
import sys

import pytest

import horovod_tpu.runner.cluster as ref_cluster
import horovod_tpu_torch.runner.cluster as cluster
from test_cluster_launchers import (_env_probe, _install_fake_pyspark,
                                    _install_fake_ray)

SAME = ("HVDTPU_CROSS_RANK", "HVDTPU_CROSS_SIZE", "HVDTPU_LOCAL_RANK",
        "HVDTPU_PLATFORM")


def _hvdtpu_env():
    """The 'training fn': every ``HVDTPU_*`` variable this rank sees."""
    return {k: v for k, v in os.environ.items() if k.startswith("HVDTPU_")}


def _assert_same_wiring(got: list, ref: list) -> None:
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in SAME:
            assert g[k] == r[k], k


# ---------------------------------------------------------------------------
# cluster.py primitives, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [
    [], ["a"], ["a", "a", "b", "a", "b"],
    ["h|10.0.0.1", "h|10.0.0.2", "h|10.0.0.1"]])
def test_local_ranks_match_reference(hosts):
    assert cluster.local_ranks(hosts) == ref_cluster.local_ranks(hosts)
    assert cluster.local_ranks(["a", "a", "b", "a", "b"]) == [0, 1, 0, 2, 1]


@pytest.mark.parametrize("infos", [
    ["n0|10.0.0.1", "n0|10.0.0.1", "n1|10.0.0.2", "n1|10.0.0.2"],
    # identical hostnames on distinct hosts: grouped by the full pair
    ["worker|10.0.0.5", "worker|10.0.0.6", "worker|10.0.0.5"]])
def test_placement_env_matches_reference(infos):
    for rank in range(len(infos)):
        got = cluster.placement_env(infos, rank, 24601)
        assert got == ref_cluster.placement_env(infos, rank, 24601)
    assert cluster.placement_env(infos, 0, 24601)[
        "HVDTPU_COORDINATOR_ADDR"] == infos[0].split("|")[1] + ":24601"


def test_placement_info_is_hostname_and_ip():
    host, ip = cluster.placement_info().split("|")
    assert host == socket.gethostname()
    assert ip == cluster.local_ip()
    socket.inet_aton(ip)


def test_driver_services_env():
    with cluster.DriverServices(4, service_ip="127.0.0.1") as s:
        env = s.worker_env(2, 1, platform="cpu", extra_env={"FOO": "bar"})
        assert env["HVDTPU_CROSS_RANK"] == "2"
        assert env["HVDTPU_CROSS_SIZE"] == "4"
        assert env["HVDTPU_LOCAL_RANK"] == "1"
        assert env["HVDTPU_PLATFORM"] == "cpu"
        assert env["FOO"] == "bar"
        assert env["HVDTPU_SECRET"] == s.secret
        host, _, port = env["HVDTPU_CONTROLLER_ADDR"].rpartition(":")
        assert host == "127.0.0.1" and int(port) == s.controller.port
        assert int(env["HVDTPU_RENDEZVOUS_ADDR"].rpartition(":")[2]) \
            == s.kv.port
        assert "HVDTPU_PLATFORM" not in s.worker_env(0, 0)
        kv_port = s.kv.port
    with pytest.raises(OSError):
        c = socket.create_connection(("127.0.0.1", kv_port), timeout=2)
        c.close()


def test_driver_services_num_proc_validation():
    with pytest.raises(ValueError):
        cluster.DriverServices(0)


# ---------------------------------------------------------------------------
# Spark
# ---------------------------------------------------------------------------

def test_spark_run_wires_ranks(monkeypatch):
    _install_fake_pyspark(monkeypatch)
    import horovod_tpu_torch.spark as hvd_spark

    results = hvd_spark.run(_env_probe, num_proc=3, platform="cpu")
    assert len(results) == 3
    assert len({r["HVDTPU_SECRET"] for r in results}) == 1
    for rank, r in enumerate(results):
        assert r["HVDTPU_CROSS_RANK"] == str(rank)
        assert r["HVDTPU_CROSS_SIZE"] == "3"
        # all fake partitions run on this host -> local ranks 0,1,2
        assert r["HVDTPU_LOCAL_RANK"] == str(rank)
        assert r["HVDTPU_PLATFORM"] == "cpu"
        assert r["HVDTPU_COORDINATOR_ADDR"].count(":") == 1
    assert len({r["HVDTPU_CONTROLLER_ADDR"] for r in results}) == 1
    assert len({r["HVDTPU_COORDINATOR_ADDR"] for r in results}) == 1


def test_spark_run_matches_the_reference_s_wiring(monkeypatch):
    _install_fake_pyspark(monkeypatch)
    import horovod_tpu.spark as ref_spark
    import horovod_tpu_torch.spark as hvd_spark
    # a stale variable from an earlier run in a reused Spark worker
    monkeypatch.setenv("HVDTPU_STALE_KNOB", "1")
    kw = dict(num_proc=3, platform="cpu", extra_env={"HVDTPU_EXTRA": "x"})
    got = hvd_spark.run(_hvdtpu_env, **kw)
    ref = ref_spark.run(_hvdtpu_env, **kw)
    _assert_same_wiring(got, ref)
    for g in got:
        assert "HVDTPU_STALE_KNOB" not in g and g["HVDTPU_EXTRA"] == "x"


def test_spark_run_default_num_proc(monkeypatch):
    _install_fake_pyspark(monkeypatch, n_parallel=2)
    import horovod_tpu_torch.spark as hvd_spark
    results = hvd_spark.run(_env_probe)
    assert [r["HVDTPU_CROSS_RANK"] for r in results] == ["0", "1"]
    assert all(r["HVDTPU_PLATFORM"] == "" for r in results)


def test_spark_run_num_proc_validation(monkeypatch):
    _install_fake_pyspark(monkeypatch)
    import horovod_tpu_torch.spark as hvd_spark
    with pytest.raises(ValueError, match="num_proc"):
        hvd_spark.run(_env_probe, num_proc=0)


def test_spark_run_without_pyspark(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyspark", None)
    monkeypatch.setitem(sys.modules, "pyspark.sql", None)
    import horovod_tpu_torch.spark as hvd_spark
    with pytest.raises(ImportError,
                       match="pyspark.*horovod_tpu_torch.runner"):
        hvd_spark.run(_env_probe, num_proc=2)


def test_spark_estimator_namespaces():
    """† horovod.spark.torch / horovod.spark.keras import path shape."""
    from horovod_tpu_torch.estimator import KerasEstimator as KE
    from horovod_tpu_torch.estimator import LocalStore as LS
    from horovod_tpu_torch.estimator import TorchEstimator as TE
    from horovod_tpu_torch.spark.keras import (KerasEstimator, KerasModel,
                                               LocalStore)
    from horovod_tpu_torch.spark.torch import (TorchEstimator, TorchModel,
                                               LocalStore as LS2)
    assert KerasEstimator is KE and TorchEstimator is TE
    assert LocalStore is LS and LS2 is LS
    assert KerasModel.__name__ == "KerasModel"
    assert TorchModel.__name__ == "TorchModel"


# ---------------------------------------------------------------------------
# Ray
# ---------------------------------------------------------------------------

def test_ray_executor(monkeypatch):
    _install_fake_ray(monkeypatch)
    from horovod_tpu_torch.ray import RayExecutor

    ex = RayExecutor(num_workers=3, platform="cpu")
    ex.start()
    try:
        results = ex.run(_env_probe)
        assert len(results) == 3
        for rank, r in enumerate(results):
            assert r["HVDTPU_CROSS_RANK"] == str(rank)
            assert r["HVDTPU_CROSS_SIZE"] == "3"
            assert r["HVDTPU_LOCAL_RANK"] == str(rank)  # one fake host
            assert r["HVDTPU_PLATFORM"] == "cpu"
        assert len({r["HVDTPU_SECRET"] for r in results}) == 1
        assert ex.execute(_env_probe) == results
        single = ex.execute_single(_env_probe)
        assert single["HVDTPU_CROSS_RANK"] == "0"
        with pytest.raises(RuntimeError, match="already started"):
            ex.start()
    finally:
        ex.shutdown()
    assert ex._workers == [] and ex._services is None


def test_ray_executor_matches_the_reference_s_wiring(monkeypatch):
    _install_fake_ray(monkeypatch)
    from horovod_tpu.ray import RayExecutor as RefExecutor
    from horovod_tpu_torch.ray import RayExecutor

    out = []
    for cls in (RayExecutor, RefExecutor):
        ex = cls(num_workers=2, platform="cpu", env={"HVDTPU_EXTRA": "y"})
        ex.start()
        try:
            out.append(ex.run(_hvdtpu_env))
        finally:
            ex.shutdown()
    _assert_same_wiring(*out)


def test_ray_executor_errors(monkeypatch):
    _install_fake_ray(monkeypatch)
    from horovod_tpu_torch.ray import RayExecutor
    with pytest.raises(ValueError):
        RayExecutor(num_workers=0)
    ex = RayExecutor(num_workers=1)
    with pytest.raises(RuntimeError, match="start"):
        ex.run(_env_probe)
    with pytest.raises(RuntimeError, match="start"):
        ex.execute_single(_env_probe)
    ex.shutdown()                       # a no-op before start()


def test_ray_executor_without_ray(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray", None)
    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=2)
    with pytest.raises(ImportError, match="ray"):
        ex.start()
    ex.shutdown()
