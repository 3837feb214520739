"""Spark integration: run a horovod_tpu_torch training function on Spark
executors (the port of ``horovod_tpu/spark/__init__.py``).

† ``horovod/spark/__init__.py`` / ``horovod/spark/runner.py``: upstream's
``horovod.spark.run(fn, args, num_proc)`` starts rendezvous services on the
driver, launches a barrier-mode Spark job with one task per rank, each task
wires the env and invokes ``fn``; results come back rank-ordered.  The
MPI/Gloo machinery is replaced here by the native KV/controller services
and rank 0's ``torch.distributed`` TCP store — Spark is purely the process
placer.

Topology: one Spark task per rank; each task's ``fn`` calls
``hvd.init()``, which reads the injected ``HVDTPU_*`` env exactly as
``hvdrun``-launched workers do.  Address/local-rank exchange rides the
barrier stage's ``allGather`` (upstream ran a separate probe service for
this; the barrier primitive subsumes it).

The Estimator API (high-level DataFrame training) lives in
``horovod_tpu_torch/estimator`` (``spark.torch``, ``spark.keras``) — this
module is the function-launch surface.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..runner.cluster import DriverServices, pick_coordinator_port

__all__ = ["run"]


def _task_body(fn: Callable, args: Sequence, kwargs: Dict[str, Any],
               envs: List[Dict[str, str]], coord_port: int):
    """The per-task closure (pickled to executors).  Returns a 1-element
    iterator with (rank, result)."""

    def body(_it):
        from pyspark import BarrierTaskContext

        from horovod_tpu_torch.runner.cluster import (placement_env,
                                                      placement_info)
        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        # One allGather round replaces upstream's task-to-driver probe
        # phase: every rank learns each rank's host (for local_rank) and
        # rank 0's IP (for its torch.distributed store).
        infos = ctx.allGather(placement_info())
        env = dict(envs[rank])
        env.update(placement_env(infos, rank, coord_port))
        # Spark reuses worker processes (spark.python.worker.reuse): clear
        # any HVDTPU_* state a previous run left behind before wiring ours.
        for k in [k for k in os.environ if k.startswith("HVDTPU_")]:
            del os.environ[k]
        os.environ.update(env)
        result = fn(*args, **(kwargs or {}))
        yield (rank, result)

    return body


def run(fn: Callable,
        args: Sequence = (),
        kwargs: Optional[Dict[str, Any]] = None,
        num_proc: Optional[int] = None,
        extra_env: Optional[Dict[str, str]] = None,
        platform: Optional[str] = None,
        verbose: bool = False) -> List[Any]:
    """Run ``fn`` on ``num_proc`` Spark tasks as horovod_tpu_torch ranks
    and return the rank-ordered list of results († ``horovod.spark.run``).

    ``fn`` runs on each executor; call ``hvd.init()`` inside it.
    ``num_proc`` defaults to the cluster's default parallelism.
    ``platform="cpu"`` runs the ranks on the CPU over Gloo (default: one
    card a rank, ``cuda:<local_rank>``, over NCCL).

    Security note: the per-rank env blocks — including the job's HMAC
    secret (``HVDTPU_SECRET``) — travel inside the task closure that Spark
    pickles to executors, so the secret transits Spark task serialization
    and may appear in event logs if closure logging is enabled (upstream's
    Spark path has the same exposure).  The secret is per-job and expires
    with the driver services; for stricter handling, pre-distribute a
    secret via your cluster's credential mechanism and set ``HVDTPU_SECRET``
    in the executor environment instead.
    """
    try:
        from pyspark.sql import SparkSession
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark.run requires pyspark; without Spark "
            "use the port's launcher, `python -m horovod_tpu_torch.runner` "
            "(hvdrun)") from e

    spark = SparkSession.getActiveSession() or \
        SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    if num_proc is not None and num_proc < 1:
        raise ValueError(f"num_proc must be >= 1, got {num_proc}")
    n = num_proc if num_proc is not None else sc.defaultParallelism

    driver_ip = sc.getConf().get("spark.driver.host", None) or None
    with DriverServices(n, service_ip=driver_ip) as services:
        # local_rank is a placeholder here; tasks overwrite it after the
        # barrier allGather reveals host placement.
        envs = [services.worker_env(r, 0, platform=platform,
                                    extra_env=extra_env) for r in range(n)]
        coord_port = pick_coordinator_port()
        body = _task_body(fn, args, kwargs or {}, envs, coord_port)
        if verbose:
            print(f"horovod_tpu_torch.spark: launching {n} ranks "
                  f"(driver services at {services.service_ip})")
        results = (sc.parallelize(range(n), n)
                   .barrier()
                   .mapPartitions(body)
                   .collect())
    ordered = sorted(results, key=lambda t: t[0])
    got = [r for r, _ in ordered]
    if got != list(range(n)):
        raise RuntimeError(
            f"spark job returned results for ranks {got}, expected 0..{n-1}")
    return [res for _, res in ordered]
