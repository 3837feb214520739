"""Elastic driver: host discovery, blacklist, assignment, job supervision.

A copy of ``horovod_tpu/runner/elastic.py`` over the port's launcher.
† ``horovod/runner/elastic/driver.py`` (``ElasticDriver``,
``HostAssignment``), ``discovery.py`` (``HostDiscovery`` script polling),
``registration.py`` (blacklist), ``worker.py`` (notification).

A membership change restarts the *job* (workers reload from their
committed state and checkpoints) rather than patching a live ring, as in
the reference.  The driver supervises that loop: poll discovery → compute
assignment (respecting the blacklist) → launch → on worker death,
blacklist the host and relaunch → on discovery change, bump the
membership epoch (the workers' ``WorkerNotificationClient`` raises
``HostsUpdatedInterrupt`` at their next commit, letting them exit cleanly
for the relaunch).  ``run_job``'s ``launcher`` is injectable; the default
is :func:`horovod_tpu_torch.runner.launch.launch_workers`.
"""

from __future__ import annotations

import dataclasses
import subprocess
import threading
import time
from typing import Callable, List, Optional, Sequence

from .hosts import HostSlots, assign_ranks, parse_hosts
from .. import config as config_mod
from ..obs import REGISTRY as _obs
from ..obs import flightrec as _frec
from ..utils import logging as hvd_logging
from ..utils import retry as _retry

log = hvd_logging.get_logger()

_m_worker_failures = _obs.counter(
    "hvd_elastic_worker_failures_total",
    "worker crashes that blacklisted a host")
_m_rendezvous_rounds = _obs.counter(
    "hvd_elastic_rendezvous_rounds_total",
    "job (re)launch rounds run by the elastic driver")
_m_hosts = _obs.gauge(
    "hvd_elastic_available_hosts",
    "non-blacklisted hosts in the current assignment")
_m_blacklisted = _obs.gauge(
    "hvd_elastic_blacklisted_hosts",
    "hosts currently serving a blacklist cooldown")
_m_epoch = _obs.gauge(
    "hvd_elastic_membership_epoch",
    "membership epoch of the assignment the driver last launched "
    "(aggregated per-rank, a lagging rank shows a stale epoch)")


class HostDiscovery:
    """† ``HostDiscovery`` interface."""

    def find_available_hosts(self) -> List[HostSlots]:
        raise NotImplementedError


class ScriptDiscovery(HostDiscovery):
    """† ``HostDiscoveryScript``: an executable printing ``host[:slots]``
    lines (the ``--host-discovery-script`` contract).  ``default_slots``
    applies to bare hostnames († the ``--slots`` flag)."""

    def __init__(self, script: str, timeout: float = 30.0,
                 default_slots: int = 1) -> None:
        self._script = script
        self._timeout = timeout
        self._default_slots = default_slots

    def find_available_hosts(self) -> List[HostSlots]:
        res = subprocess.run([self._script], capture_output=True, text=True,
                             timeout=self._timeout)
        if res.returncode != 0:
            raise RuntimeError(
                f"discovery script failed ({res.returncode}): {res.stderr}")
        lines = [line.strip() for line in res.stdout.splitlines()
                 if line.strip()]
        if not lines:
            return []
        spec = ",".join(
            line if ":" in line else f"{line}:{self._default_slots}"
            for line in lines)
        return parse_hosts(spec)


class FixedDiscovery(HostDiscovery):
    """Deterministic sequence of host lists (the reference's fake-discovery
    unit-test rig † ``test_elastic_driver.py``); repeats the last entry."""

    def __init__(self, *host_specs: str) -> None:
        self._specs = [parse_hosts(s) if s else [] for s in host_specs]
        self._i = 0

    def find_available_hosts(self) -> List[HostSlots]:
        spec = self._specs[min(self._i, len(self._specs) - 1)]
        self._i += 1
        return spec


@dataclasses.dataclass
class _BlacklistEntry:
    """One host's failure history: probation instead of a life sentence."""
    failures: int = 0
    until: float = 0.0         # monotonic instant the cooldown expires
    last_failure: float = 0.0


class ElasticDriver:
    """Membership brain: current hosts − blacklist → rank assignment.

    The blacklist DECAYS: a host's first crash excludes it for
    ``blacklist_cooldown_s``; when the cooldown lapses the host is
    re-admitted on probation, and a further crash doubles the cooldown
    (capped at ``blacklist_max_cooldown_s``).  A transient failure
    (preemption, OOM kill, flaky NIC) therefore costs bounded capacity,
    while a persistently bad host spends almost all its time excluded —
    the permanent blacklist it replaces ratcheted every transient
    failure toward ``min_np`` forever.  ``cooldown <= 0`` restores the
    permanent behavior.  ``clock`` is injectable so the decay schedule
    unit-tests without sleeping.
    """

    def __init__(self, discovery: HostDiscovery, *, min_np: int,
                 max_np: Optional[int] = None,
                 poll_interval_s: float = 1.0,
                 blacklist_cooldown_s: Optional[float] = None,
                 blacklist_max_cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if min_np < 1:
            raise ValueError("min_np must be >= 1")
        cfg = config_mod.from_env()
        self._discovery = discovery
        self.min_np = min_np
        self.max_np = max_np
        self._poll_interval = poll_interval_s
        self._cooldown = (cfg.blacklist_cooldown_s
                          if blacklist_cooldown_s is None
                          else blacklist_cooldown_s)
        self._max_cooldown = (cfg.blacklist_max_cooldown_s
                              if blacklist_max_cooldown_s is None
                              else blacklist_max_cooldown_s)
        self._clock = clock
        self._blacklist: dict[str, _BlacklistEntry] = {}
        self._lock = threading.Lock()
        self._current_hosts: List[HostSlots] = []
        self.membership_epoch = 0
        #: autoscaler-imposed world size; ``None`` = use full capacity.
        #: A voluntary shrink sets this below capacity so the next
        #: assignment retires ranks even though their hosts are healthy.
        self.target_np: Optional[int] = None

    # -- membership ---------------------------------------------------------
    def blacklist(self, hostname: str) -> None:
        """† ``registration.py``: a host whose worker crashed is excluded
        from future assignments — here for a decaying cooldown, not
        forever (see the class docstring)."""
        now = self._clock()
        with self._lock:
            e = self._blacklist.setdefault(hostname, _BlacklistEntry())
            e.failures += 1
            e.last_failure = now
            if self._cooldown > 0:
                cooldown = min(self._cooldown * (2 ** (e.failures - 1)),
                               self._max_cooldown)
                e.until = now + cooldown
            else:
                cooldown = float("inf")
                e.until = float("inf")
        _m_worker_failures.inc()
        _frec.RECORDER.record("elastic_blacklist", name=hostname,
                              failures=e.failures,
                              cooldown_s=(None if cooldown == float("inf")
                                          else round(cooldown, 3)))
        log.warning(
            "elastic: blacklisted host %s (failure #%d, cooldown %s)",
            hostname, e.failures,
            "permanent" if cooldown == float("inf")
            else f"{cooldown:.0f}s")

    def blacklisted(self) -> set[str]:
        """Hosts currently serving a cooldown.  Hosts whose cooldown
        lapsed are re-admitted (probation) but keep their failure
        count, so the next failure doubles the cooldown."""
        now = self._clock()
        out = set()
        readmitted = []
        with self._lock:
            for host, e in self._blacklist.items():
                if now < e.until:
                    out.add(host)
                elif e.until:      # lapsed since we last looked
                    e.until = 0.0
                    readmitted.append((host, e.failures))
        _m_blacklisted.set(len(out))
        for host, failures in readmitted:
            _frec.RECORDER.record("elastic_probation", name=host,
                                  failures=failures)
            log.warning(
                "elastic: blacklist cooldown lapsed for host %s "
                "(%d failure(s) so far) — re-admitting on probation",
                host, failures)
        return out

    def blacklist_failures(self, hostname: str) -> int:
        """Failure count a host has accrued (0 = never failed)."""
        with self._lock:
            e = self._blacklist.get(hostname)
            return e.failures if e else 0

    def poll_hosts(self) -> bool:
        """Refresh from discovery; returns True if membership changed."""
        hosts = [h for h in self._discovery.find_available_hosts()
                 if h.hostname not in self.blacklisted()]
        with self._lock:
            changed = hosts != self._current_hosts
            if changed:
                self._current_hosts = hosts
                self.membership_epoch += 1
        return changed

    def wait_for_available_slots(self, min_np: Optional[int] = None,
                                 timeout_s: float = 600.0
                                 ) -> List[HostSlots]:
        """† ``ElasticDriver.wait_for_available_slots``: block until at
        least min_np slots exist among non-blacklisted hosts.

        Discovery failures (the script crashing, timing out, or its
        host being briefly unreachable) no longer kill the driver: they
        back off on the shared retry policy — exponential, capped,
        deterministic jitter — and only the overall ``timeout_s``
        budget gives up.  A healthy poll resets the backoff to the
        plain poll interval."""
        need = min_np if min_np is not None else self.min_np
        deadline = time.monotonic() + timeout_s
        backoff = _retry.Backoff(
            _retry.RetryPolicy(max_attempts=None,
                               base_delay_s=max(0.05, self._poll_interval),
                               max_delay_s=max(8 * self._poll_interval,
                                               self._poll_interval)),
            op="elastic_discovery")
        last_err: Optional[Exception] = None
        while True:
            try:
                self.poll_hosts()
                backoff.reset()
                last_err = None
            except Exception as e:
                last_err = e
                log.warning("elastic: host discovery failed (%s); "
                            "retrying with backoff", e)
            with self._lock:
                hosts = list(self._current_hosts)
            if last_err is None and sum(h.slots for h in hosts) >= need:
                return hosts
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError(
                    f"not enough hosts for min_np={need} within "
                    f"{timeout_s}s (have {hosts}, "
                    f"blacklist {sorted(self.blacklisted())}"
                    + (f", last discovery error: {last_err}" if last_err
                       else "") + ")")
            delay = (backoff.next_delay() if last_err is not None
                     else self._poll_interval)
            time.sleep(min(delay, max(0.0, deadline - now)))

    def assignment(self, hosts: Optional[Sequence[HostSlots]] = None
                   ) -> List[tuple[int, str, int]]:
        """Rank assignment over current (or given) hosts, capped at
        max_np and at the autoscaler's ``target_np`` when one is set."""
        if hosts is None:
            with self._lock:
                hosts = list(self._current_hosts)
        total = sum(h.slots for h in hosts)
        np_total = min(total, self.max_np or total, self.target_np or total)
        np_total = max(np_total, min(self.min_np, total))
        return assign_ranks(list(hosts), np_total)

    # -- supervision --------------------------------------------------------
    def run_job(self, command: Sequence[str], *,
                max_restarts: int = 10,
                extra_env: Optional[dict] = None,
                launcher: Optional[Callable] = None,
                on_epoch_change: Optional[Callable] = None,
                slot_timeout_s: float = 600.0,
                launch_kwargs: Optional[dict] = None,
                autoscale=None,
                autoscale_interval_s: float = 2.0) -> int:
        """Supervise the elastic job: (re)launch on the current assignment
        until it exits 0 or restarts are exhausted.

        ``launcher`` defaults to :func:`horovod_tpu_torch.runner.launch.launch_workers`
        (injectable for tests); ``launch_kwargs`` forwards launcher knobs
        (ssh_port, verbose, connectivity_check, ...) to it.

        ``autoscale`` (an :class:`horovod_tpu_torch.autoscale.PolicyConfig`)
        replaces the plain capacity growth watcher with the full
        closed-loop controller: each round launches an
        :class:`~horovod_tpu_torch.autoscale.AutoscaleController` that polls the
        job's ``/cluster`` signals through the KV store and drives both
        grow and voluntary shrink via the membership-epoch bump.
        """
        last_np: dict = {"np": None}
        if launcher is None:
            from .launch import (
                RESTART_EXIT_CODE,
                VICTIM_EXIT_CODE,
                launch_workers,
            )

            def launcher(cmd, hosts, env):
                spec = ",".join(f"{h.hostname}:{h.slots}" for h in hosts)
                capacity_now = sum(h.slots for h in hosts)
                np_total = min(capacity_now, self.max_np or 10 ** 9,
                               self.target_np or 10 ** 9)
                np_total = max(np_total, min(self.min_np, capacity_now))
                env = dict(env)
                env["HVDTPU_AUTOSCALE_TARGET_NP"] = str(
                    self.target_np or np_total)
                prev_np, last_np["np"] = last_np["np"], np_total
                failure: dict = {}
                stop_watch = threading.Event()
                controller_box: list = []

                def autoscale_hook(services):
                    # Closed loop: sense (/cluster via the job KV) ->
                    # decide (ScalePolicy) -> act (epoch bump).  One
                    # controller per launch round; stopped when the
                    # round's workers exit.
                    from .._native import KvClient
                    from ..autoscale import AutoscaleController, ScalePolicy
                    from ..elastic.runner import WorkerNotificationClient
                    from ..obs.aggregate import ClusterAggregator

                    def kv_factory():
                        return KvClient("127.0.0.1", services.kv.port,
                                        secret=services.secret)

                    agg = ClusterAggregator(include_local=False,
                                            kv_factory=kv_factory)

                    def capacity() -> int:
                        try:
                            self.poll_hosts()
                        except Exception as e:
                            log.warning("autoscale: discovery poll "
                                        "failed: %s", e)
                        with self._lock:
                            return sum(h.slots
                                       for h in self._current_hosts)

                    def bump() -> None:
                        kv = kv_factory()
                        try:
                            WorkerNotificationClient.bump(kv)
                        finally:
                            kv.close()

                    def set_target(target: int) -> None:
                        self.target_np = target

                    controller_box.append(AutoscaleController(
                        ScalePolicy(autoscale),
                        current_np=np_total, prev_np=prev_np,
                        collect=agg.collect, bump=bump,
                        capacity=capacity, set_target=set_target,
                        interval_s=autoscale_interval_s).start())

                def services_hook(services):
                    if autoscale is not None:
                        return autoscale_hook(services)
                    # Growth watcher: while the job runs, poll discovery;
                    # when total capacity exceeds the running np (and
                    # max_np allows more), bump the membership epoch in
                    # the job's KV store — workers exit with the restart
                    # code at their next commit and we relaunch on the
                    # grown assignment († WorkerNotificationService push).
                    from .._native import KvClient
                    from ..elastic.runner import WorkerNotificationClient

                    def watch():
                        grown_polls = 0
                        while not stop_watch.wait(self._poll_interval):
                            try:
                                self.poll_hosts()
                                with self._lock:
                                    capacity = sum(
                                        h.slots
                                        for h in self._current_hosts)
                                growable = (capacity > np_total
                                            and np_total < (self.max_np
                                                            or 10 ** 9))
                                # Debounce (flaky discovery) and keep
                                # re-bumping while grown: a bump landing
                                # before a worker baselines its notifier
                                # epoch would otherwise be absorbed
                                # silently and the capacity never used.
                                grown_polls = (grown_polls + 1
                                               if growable else 0)
                                if grown_polls >= 2:
                                    kv = KvClient("127.0.0.1",
                                                  services.kv.port,
                                                  secret=services.secret)
                                    WorkerNotificationClient.bump(kv)
                                    kv.close()
                                    log.info(
                                        "elastic: capacity grew to %d "
                                        "slots (running np=%d); signaled "
                                        "workers to restart", capacity,
                                        np_total)
                            except Exception as e:
                                log.warning(
                                    "elastic: growth watcher error: %s", e)

                    threading.Thread(target=watch, daemon=True,
                                     name="hvdtpu-growth-watch").start()

                try:
                    code = launch_workers(cmd, np_total=np_total,
                                          hosts_spec=spec, extra_env=env,
                                          failure_info=failure,
                                          services_hook=services_hook,
                                          **(launch_kwargs or {}))
                finally:
                    stop_watch.set()
                    for c in controller_box:
                        c.stop()
                if code in (RESTART_EXIT_CODE, VICTIM_EXIT_CODE):
                    # Voluntary membership restart, or a victim of some
                    # other rank's fault: either way, the first-exiting
                    # worker is not the culprit — no blacklist.
                    return code
                if code != 0 and failure.get("host") and len(hosts) > 1:
                    # † registration.py: exclude the crashed worker's host
                    # from the next assignment.  Sole-host jobs keep their
                    # host (blacklisting it would make relaunch impossible;
                    # transient failures get the retry instead).
                    self.blacklist(failure["host"])
                return code

        from .launch import RESTART_EXIT_CODE

        restarts = 0
        voluntary = 0
        while True:
            hosts = self.wait_for_available_slots(timeout_s=slot_timeout_s)
            epoch = self.membership_epoch
            _m_rendezvous_rounds.inc()
            _m_hosts.set(len(hosts))
            _m_epoch.set(epoch)
            _frec.RECORDER.record("elastic_launch", epoch=epoch,
                                  hosts=len(hosts), restarts=restarts)
            log.info("elastic: launching on %s (epoch %d)", hosts, epoch)
            env = dict(extra_env or {})
            env["HVDTPU_ELASTIC"] = "1"
            code = launcher(list(command), hosts, env)
            if code == 0:
                return 0
            if code == RESTART_EXIT_CODE:
                # Voluntary membership restarts get their own (generous)
                # budget: a flapping discovery script alternating the
                # host list must not relaunch-loop the job forever.
                voluntary += 1
                if voluntary > max(10, max_restarts):
                    log.warning(
                        "elastic: %d voluntary restarts (flapping "
                        "discovery?); counting further ones against the "
                        "failure budget", voluntary)
                    restarts += 1
            else:
                restarts += 1
            if restarts > max_restarts:
                log.error("elastic: giving up after %d restarts",
                          restarts)
                return code
            # Refresh membership and let discovery/blacklist shape the
            # next assignment (a grown host list enlarges it; a crashed
            # host's blacklisting shrinks it).  A discovery hiccup here
            # is not fatal — the next wait_for_available_slots retries
            # it under the backoff policy.
            try:
                self.poll_hosts()
            except Exception as e:
                log.warning("elastic: post-round discovery poll failed "
                            "(%s); retrying at next slot wait", e)
            if on_epoch_change and self.membership_epoch != epoch:
                on_epoch_change(self.membership_epoch)
