"""Ray integration: place horovod_tpu_torch ranks as Ray actors (the port
of ``horovod_tpu/ray/__init__.py``).

† ``horovod/ray/runner.py`` (v0.20+): upstream's ``RayExecutor`` creates a
placement group of worker actors, wires the rendezvous env into each, and
exposes ``start() / run(fn) / execute(fn) / shutdown()``.  Here Ray is the
process placer; the control plane is the native KV/controller services on
the driver and the collectives run over ``torch.distributed``, exactly as
under ``hvdrun``.

Usage († upstream README example)::

    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=4)
    ex.start()
    results = ex.run(train_fn, args=(cfg,))
    ex.shutdown()
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..runner.cluster import (DriverServices, pick_coordinator_port,
                              placement_env)

__all__ = ["RayExecutor"]


def _worker_cls():
    """Build the Ray actor class lazily (ray import deferred)."""
    import ray

    @ray.remote
    class _HvdWorker:
        def __init__(self, rank: int, env: Dict[str, str]) -> None:
            self._rank = rank
            os.environ.update(env)

        def hostname_ip(self) -> str:
            from horovod_tpu_torch.runner.cluster import placement_info
            return placement_info()

        def set_env(self, env: Dict[str, str]) -> None:
            os.environ.update(env)

        def execute(self, fn: Callable, args: Sequence,
                    kwargs: Dict[str, Any]) -> Any:
            return fn(*args, **kwargs)

    return _HvdWorker


class RayExecutor:
    """† ``horovod.ray.RayExecutor``: actor-per-rank launcher.
    ``platform="cpu"`` runs the ranks on the CPU over Gloo."""

    def __init__(self, num_workers: int, *,
                 cpus_per_worker: int = 1,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 env: Optional[Dict[str, str]] = None,
                 platform: Optional[str] = None) -> None:
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        self.resources_per_worker = resources_per_worker
        self._extra_env = dict(env or {})
        self._platform = platform
        self._services: Optional[DriverServices] = None
        self._workers: List[Any] = []

    def start(self) -> None:
        """Create the services and the actor fleet; wire rendezvous env
        († upstream start(): placement group + per-worker env)."""
        try:
            import ray
        except ImportError as e:
            raise ImportError(
                "horovod_tpu_torch.ray.RayExecutor requires ray; without "
                "Ray use the port's launcher, `python -m "
                "horovod_tpu_torch.runner` (hvdrun)") from e
        if self._workers:
            raise RuntimeError("RayExecutor already started")
        if not ray.is_initialized():
            ray.init()

        n = self.num_workers
        self._services = DriverServices(n)
        cls = _worker_cls()
        opts: Dict[str, Any] = {"num_cpus": self.cpus_per_worker}
        if self.resources_per_worker:
            opts["resources"] = self.resources_per_worker
        self._workers = [
            cls.options(**opts).remote(
                r, self._services.worker_env(
                    r, 0, platform=self._platform,
                    extra_env=self._extra_env))
            for r in range(n)
        ]
        # Placement round: learn each actor's host for local_rank and
        # rank 0's IP for its torch.distributed store (≙ spark's barrier
        # allGather).
        infos = ray.get([w.hostname_ip.remote() for w in self._workers])
        coord_port = pick_coordinator_port()
        ray.get([
            w.set_env.remote(placement_env(infos, r, coord_port))
            for r, w in enumerate(self._workers)
        ])

    def run(self, fn: Callable, args: Sequence = (),
            kwargs: Optional[Dict[str, Any]] = None) -> List[Any]:
        """Run ``fn`` on every rank; return rank-ordered results
        († upstream run())."""
        import ray
        if not self._workers:
            raise RuntimeError("call start() first")
        return ray.get([w.execute.remote(fn, args, kwargs or {})
                        for w in self._workers])

    # † upstream alias: execute() runs on all workers too (its
    # single-worker `execute_single` is rank 0 here).
    execute = run

    def execute_single(self, fn: Callable, args: Sequence = (),
                       kwargs: Optional[Dict[str, Any]] = None) -> Any:
        import ray
        if not self._workers:
            raise RuntimeError("call start() first")
        return ray.get(self._workers[0].execute.remote(fn, args,
                                                       kwargs or {}))

    def shutdown(self) -> None:
        """Kill the fleet and close driver services († upstream
        shutdown()).  No-op before start(), so ``finally: ex.shutdown()``
        is safe even when start() itself failed."""
        if not self._workers and self._services is None:
            return
        import ray
        for w in self._workers:
            try:
                ray.kill(w)
            except Exception:
                pass
        self._workers = []
        if self._services is not None:
            self._services.close()
            self._services = None
