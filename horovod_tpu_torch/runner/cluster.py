"""Shared driver-side plumbing for launchers (a copy of the JAX package's
``runner/cluster.py`` for the port).

The reference's Spark and Ray integrations († ``horovod/spark/runner.py``,
``horovod/ray/runner.py``) both follow the same shape: the driver process
starts the rendezvous services, builds per-rank environment blocks, and the
cluster manager (instead of ssh) places the worker processes.  This module
is that shared shape for the port: the native KV + controller services of
``horovod_tpu_torch._native`` and the per-rank env block used by
``runner/launch.py``.  (Only the Spark and Ray placement exchange is
still to come, with those bindings, the last slice of ROADMAP section A
'Remaining models, bindings and examples'.)

The env block keeps ``HVDTPU_RENDEZVOUS_ADDR``: the metrics publisher
(:mod:`horovod_tpu_torch.obs.aggregate`) finds the job's KV store by it.
``HVDTPU_COORDINATOR_ADDR`` names the ``torch.distributed`` TCP store rank
0 serves.
"""

from __future__ import annotations

import os
import secrets as _secrets
from typing import Dict, Optional


def local_ip() -> str:
    """This host's most routable IPv4 address (the first of the NIC
    inventory, loopback last).  Unlike the reference, it never opens a
    socket towards an outside address to ask the routing table."""
    from .probe import local_addresses
    return local_addresses()[0]


def pick_coordinator_port() -> int:
    """Port for rank 0's ``torch.distributed`` TCP store, which binds on
    rank 0's host — the driver cannot probe a remote host's free ports,
    so pick from a wide ephemeral-range slice to make collisions
    unlikely.  (A conflict fails that worker's startup and the
    monitor/timeout reports it.)"""
    import random
    return random.randint(23000, 29999)


class DriverServices:
    """Native control-plane services bound on the driver.

    Starts the KV rendezvous store and the negotiation controller with a
    per-job HMAC secret († secret.py: one random credential per job), and
    hands out the env block each rank needs to ``hvd.init()``.
    """

    def __init__(self, num_proc: int, *, service_ip: Optional[str] = None,
                 secret: Optional[str] = None,
                 stall_shutdown_s: Optional[float] = None,
                 stall_warn_s: Optional[float] = None) -> None:
        from .._native import ControllerServer, KvServer

        if num_proc < 1:
            raise ValueError(f"num_proc must be >= 1, got {num_proc}")
        self.num_proc = num_proc
        self.secret = secret or os.environ.get("HVDTPU_SECRET") \
            or _secrets.token_hex(16)
        self.service_ip = service_ip or local_ip()
        self.kv = KvServer(secret=self.secret)
        # Round-barrier abort tracks the stall-shutdown opt-in: with
        # shutdown enabled, a rank whose peers stop checking in must be
        # released with an error rather than blocked in recv where its
        # own stall inspector cannot run († error Response to all ranks).
        # Callers whose stall knob does not live in this process's env
        # (hvdrun --config-file puts it only in the WORKER env) must pass
        # ``stall_shutdown_s`` explicitly.
        if stall_shutdown_s is None or stall_warn_s is None:
            from .. import config as config_mod
            cfg = config_mod.from_env()
            if stall_shutdown_s is None:
                stall_shutdown_s = cfg.stall_shutdown_time_s
            if stall_warn_s is None:
                # The controller's stall inspector (straggler attribution:
                # which ranks never submitted a pending tensor) must fire
                # on the same timescale as the workers' own stall checks,
                # not the native default.
                stall_warn_s = cfg.stall_warning_time_s
        round_abort_ms = 0
        if stall_shutdown_s and stall_shutdown_s > 0:
            round_abort_ms = int(stall_shutdown_s * 2 * 1000)
        try:
            self.controller = ControllerServer(
                size=num_proc, secret=self.secret,
                stall_warn_ms=max(1, int(stall_warn_s * 1000)),
                round_abort_ms=round_abort_ms)
        except Exception:
            self.kv.stop()  # construction failed; __exit__ will never run
            raise

    def worker_env(self, rank: int, local_rank: int, *,
                   coordinator_addr: Optional[str] = None,
                   extra_env: Optional[Dict[str, str]] = None
                   ) -> Dict[str, str]:
        """The env block ``runner/launch.py base_env`` injects, minus the
        inherited process env (the cluster manager owns that part)."""
        env = dict(extra_env or {})
        env.update({
            "HVDTPU_CROSS_RANK": str(rank),
            "HVDTPU_CROSS_SIZE": str(self.num_proc),
            "HVDTPU_CONTROLLER_ADDR":
                f"{self.service_ip}:{self.controller.port}",
            "HVDTPU_RENDEZVOUS_ADDR": f"{self.service_ip}:{self.kv.port}",
            "HVDTPU_LOCAL_RANK": str(local_rank),
            "HVDTPU_SECRET": self.secret,
        })
        if coordinator_addr:
            env["HVDTPU_COORDINATOR_ADDR"] = coordinator_addr
        return env

    def close(self) -> None:
        self.kv.stop()
        self.controller.stop()

    def __enter__(self) -> "DriverServices":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
