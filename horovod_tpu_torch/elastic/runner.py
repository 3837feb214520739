"""Elastic worker-side loop: the ``@hvd.elastic.run`` decorator and the
driver-notification client.

The port of ``horovod_tpu/elastic/runner.py``.  † ``horovod/common/
elastic.py run_fn`` (the catch/restore/reinit loop) and † ``horovod/
runner/elastic/worker.py WorkerNotificationService`` — the notification
channel is the job's native KV store (the driver bumps an epoch key;
workers poll it at commit boundaries).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Optional

from ..context import HorovodInternalError
from ..obs import REGISTRY as _obs
from ..obs import flightrec as _frec
from ..utils import logging as hvd_logging

log = hvd_logging.get_logger()

_m_interrupts = _obs.counter(
    "hvd_elastic_interrupts_total",
    "elastic control-flow interrupts seen by the worker loop",
    ("kind",))

_EPOCH_KEY = "elastic/membership_epoch"


class HostsUpdatedInterrupt(Exception):
    """† ``HostsUpdatedInterrupt``: driver reported a membership change;
    sync state and continue (no rollback needed — nothing failed)."""


class WorkerNotificationClient:
    """Polls the driver's membership epoch in the KV store."""

    def __init__(self, addr: Optional[str] = None) -> None:
        addr = addr or os.environ.get("HVDTPU_RENDEZVOUS_ADDR")
        self._client = None
        self._last_epoch = 0
        if addr:
            from .._native import KvClient
            host, _, port = addr.rpartition(":")
            try:
                self._client = KvClient(host or "127.0.0.1", int(port),
                                        timeout_ms=2000)
                self._last_epoch = self._read_epoch()
            except (ConnectionError, ValueError):
                log.warning("elastic: cannot reach rendezvous at %s", addr)

    def _read_epoch(self) -> int:
        assert self._client is not None
        raw = self._client.get(_EPOCH_KEY)
        return int(raw) if raw else 0

    def check(self) -> None:
        """Raise HostsUpdatedInterrupt if membership changed since last
        check; called from ``State.commit()``."""
        if self._client is None:
            return
        epoch = self._read_epoch()
        if epoch != self._last_epoch:
            self._last_epoch = epoch
            raise HostsUpdatedInterrupt(f"membership epoch -> {epoch}")

    @staticmethod
    def bump(kv_client) -> None:
        """Driver side: signal a membership change."""
        raw = kv_client.get(_EPOCH_KEY)
        epoch = int(raw) if raw else 0
        kv_client.set(_EPOCH_KEY, str(epoch + 1).encode())


def _reinitialize() -> None:
    """Tear down and re-init the runtime († 3.5 reinit): the engine
    thread, its stream and the process group (NCCL's communicator on the
    card) are destroyed and made anew in this process, with the knobs the
    runtime had.  ``init`` re-arms the metrics plane with the new rank and
    size; the immediate publish makes ``/cluster`` show the new world
    without waiting out a publish interval.  Serving replicas behind the
    front door then re-announce themselves, so the router sees them in
    the re-formed world (a no-op when this process hosts none)."""
    import horovod_tpu_torch as hvd
    cfg = hvd.global_state().config if hvd.is_initialized() else None
    hvd.shutdown()
    hvd.init(config=cfg)
    from ..obs import aggregate
    aggregate.publish_now()
    from ..serving.frontdoor import transport
    transport.republish_membership()


def run(func: Callable[..., Any]) -> Callable[..., Any]:
    """† ``hvd.elastic.run`` decorator.

    ``func(state, *args, **kwargs)`` is retried under the elastic protocol:
    ``HorovodInternalError`` → restore + reinit + on_reset;
    ``HostsUpdatedInterrupt`` → sync and continue (standalone), or exit
    with the reserved restart code when running under the ElasticDriver
    (``HVDTPU_ELASTIC=1``): the driver relaunches on the new assignment
    without blacklisting, and the state's last ``commit()`` (durable
    before the interrupt is raised) carries training across the restart.
    """

    @functools.wraps(func)
    def wrapper(state, *args: Any, **kwargs: Any) -> Any:
        notifier = WorkerNotificationClient()
        state._notifier = notifier
        first = True
        while True:
            if not first:
                state.on_reset()
            first = False
            try:
                return func(state, *args, **kwargs)
            except HorovodInternalError as e:
                _m_interrupts.labels(kind="failure").inc()
                # Black-box the failure before recovery tears state down.
                _frec.RECORDER.record("elastic_interrupt", name="failure",
                                      error=str(e))
                _frec.RECORDER.maybe_dump("elastic_failure",
                                          extra={"error": str(e)})
                if os.environ.get("HVDTPU_ELASTIC") == "1":
                    # Under the ElasticDriver the job is the recovery
                    # unit: exit so the driver relaunches survivors from
                    # durable state.  The VICTIM code tells the driver
                    # this rank observed a failure rather than caused one,
                    # so its host is not blacklisted.
                    from ..runner.launch import VICTIM_EXIT_CODE
                    log.warning(
                        "elastic: collective failure (%s); exiting for "
                        "driver relaunch", e)
                    raise SystemExit(VICTIM_EXIT_CODE)
                log.warning("elastic: collective failure (%s); rolling back "
                            "to last commit and re-initializing", e)
                _reinitialize()
                state.restore()
            except HostsUpdatedInterrupt as e:
                _m_interrupts.labels(kind="hosts_updated").inc()
                _frec.RECORDER.record("elastic_interrupt",
                                      name="hosts_updated", detail=str(e))
                if os.environ.get("HVDTPU_ELASTIC") == "1":
                    from ..runner.launch import RESTART_EXIT_CODE
                    log.info(
                        "elastic: %s; exiting for a driver relaunch on "
                        "the new assignment (state committed)", e)
                    raise SystemExit(RESTART_EXIT_CODE)
                log.info("elastic: %s; syncing state from rank 0", e)
                state.sync()

    return wrapper
