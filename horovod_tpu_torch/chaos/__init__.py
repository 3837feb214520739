"""Deterministic fault injection for the elastic + serving runtime.

Recovery paths you cannot trigger are recovery paths you cannot trust:
elastic re-rendezvous, stall shutdown, KV torn-read handling and serving
drain all existed before this module, but only real hardware failures
ever exercised them.  ``chaos`` makes failures an *input*: named
injection **sites** wrap the runtime's choke points (KV blob ops,
negotiation barrier entry, collective dispatch, worker spawn/heartbeat,
serving admission/step), and a parsed spec
(:mod:`horovod_tpu_torch.chaos.spec`, env ``HVDTPU_FAULTS``) decides — with
per-(rule, site) seeded RNG streams — exactly which traversals raise,
sleep, or kill the process.  Same spec + same seed ⇒ the identical
fault sequence, on every rank (each process keys its streams by its own
cross-rank), which is what lets CI assert recovery rather than hope
for it.

Surface:

- :func:`fire(site) <fire>` — called at each choke point; a no-op
  global-read when disarmed (the production hot path pays one ``is
  None`` check);
- :func:`arm` / :func:`disarm` / :func:`arm_from_env` — install a spec;
  re-arming the *same* spec is a no-op so ``hvd.init()`` never resets
  mid-run traversal counters;
- :class:`InjectedFault` — what ``err`` raises.  It subclasses
  ``ConnectionError`` so a retry classifier treats injected faults
  exactly like real transport trouble — injection tests the same code
  path production failures take;
- every fired fault increments ``hvd_faults_injected_total{site,kind}``
  and lands in the flight-recorder ring (``fault_injected`` events), so
  postmortem bundles name the injected fault next to its consequences.

The scenario harness lives in :mod:`horovod_tpu_torch.chaos.run`
(``python -m horovod_tpu_torch.chaos.run --scenario elastic``).
"""

from __future__ import annotations

import fnmatch
import os
import threading
import time
from random import Random
from typing import Optional, Tuple

from .spec import KNOWN_SITES, FaultRule, parse_spec  # noqa: F401
from ..obs import REGISTRY as _obs
from ..obs import flightrec as _frec

_m_faults = _obs.counter(
    "hvd_faults_injected_total",
    "faults fired by the chaos injector", ("site", "kind"))

#: exit code an injected death uses — distinct from the elastic
#: RESTART (75) / VICTIM (76) codes so the launcher treats it as a real
#: fault (blacklist + relaunch), which is the point.
DIE_EXIT_CODE = 17


class InjectedFault(ConnectionError):
    """An ``err``-kind fault.  ConnectionError ancestry makes it
    retryable under a retry classifier — injected faults exercise the same handling real
    transport failures get."""


class FaultInjector:
    """Armed rule set + deterministic per-(rule, site) decision streams.

    Traversal counters are per rule (a ``*``-site rule counts every
    matching site traversal); probability draws come from a stream
    keyed ``(seed, rule index, site, kind, rank)`` so concurrent sites
    never perturb each other's sequences and every rank draws an
    independent — but reproducible — stream.
    """

    def __init__(self, rules: Tuple[FaultRule, ...], *,
                 spec_text: str = "", rank: Optional[int] = None) -> None:
        self.rules = rules
        self.spec_text = spec_text
        self._rank = rank
        self._lock = threading.Lock()
        self._hits: dict = {}      # rule index -> traversal count
        self._fired: dict = {}     # rule index -> fire count
        self._streams: dict = {}   # (rule index, site) -> Random
        self._log: list = []       # (site, kind, rule index, traversal)

    # -- identity ---------------------------------------------------------
    def _cross_rank(self) -> int:
        if self._rank is None:
            try:
                self._rank = int(os.environ.get("HVDTPU_CROSS_RANK", "0"))
            except ValueError:
                self._rank = 0
        return self._rank

    # -- introspection (tests, the determinism scenario) ------------------
    def fired_events(self) -> list:
        with self._lock:
            return list(self._log)

    def fired_count(self, index: int) -> int:
        with self._lock:
            return self._fired.get(index, 0)

    # -- the decision + effect -------------------------------------------
    def fire(self, site: str) -> None:
        for rule in self.rules:
            if not fnmatch.fnmatchcase(site, rule.site):
                continue
            if rule.rank is not None and rule.rank != self._cross_rank():
                continue
            with self._lock:
                hits = self._hits.get(rule.index, 0) + 1
                self._hits[rule.index] = hits
                if hits < rule.after:
                    continue
                if rule.times is not None \
                        and self._fired.get(rule.index, 0) >= rule.times:
                    continue
                if rule.p < 1.0:
                    key = (rule.index, site)
                    rng = self._streams.get(key)
                    if rng is None:
                        rng = Random(f"{rule.seed}:{rule.index}:{site}:"
                                     f"{rule.kind}:{self._cross_rank()}")
                        self._streams[key] = rng
                    if rng.random() >= rule.p:
                        continue
                if rule.once_path is not None \
                        and not _claim_once(rule.once_path):
                    continue
                self._fired[rule.index] = \
                    self._fired.get(rule.index, 0) + 1
                self._log.append((site, rule.kind, rule.index, hits))
            self._effect(site, rule)

    def _effect(self, site: str, rule: FaultRule) -> None:
        _m_faults.labels(site=site, kind=rule.kind).inc()
        # NB: record()'s first positional IS the event kind — the fault
        # kind rides as data (a kind= kwarg would collide with it).
        _frec.RECORDER.record("fault_injected", name=site,
                              fault_kind=rule.kind, rule=rule.describe())
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
        elif rule.kind == "err":
            raise InjectedFault(
                f"injected fault at site {site!r} ({rule.describe()})")
        elif rule.kind == "die":
            from ..utils import logging as hvd_logging
            hvd_logging.get_logger().warning(
                "chaos: injected death at site %r (%s); exiting %d",
                site, rule.describe(), DIE_EXIT_CODE)
            # The black box is the whole point of an injected death:
            # dump unconditionally (armed dir or cwd) so the bundle
            # names the fault that killed this rank.
            _frec.RECORDER.dump(
                reason="injected_death",
                extra={"site": site, "rule": rule.describe()})
            os._exit(DIE_EXIT_CODE)


def _claim_once(path: str) -> bool:
    """Atomically claim a cross-process/cross-relaunch once-latch."""
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    except OSError:
        return False   # unwritable latch dir: fail safe (never fire)
    os.close(fd)
    return True


_armed: Optional[FaultInjector] = None
_arm_lock = threading.Lock()


def fire(site: str) -> None:
    """The choke-point hook.  Disarmed cost: one global read."""
    inj = _armed
    if inj is not None:
        inj.fire(site)


def injector() -> Optional[FaultInjector]:
    return _armed


def arm(spec: str, *, rank: Optional[int] = None) -> FaultInjector:
    """Install a fault spec.  Re-arming an IDENTICAL spec keeps the
    running injector (its traversal counters and streams) — ``init()``
    re-arms on elastic re-init and must not reset mid-run state.
    Raises ``ValueError`` on grammar errors: an explicitly requested
    fault plan that cannot be honored must fail loudly, not silently
    run a healthy job."""
    global _armed
    with _arm_lock:
        if _armed is not None and _armed.spec_text == spec:
            return _armed
        rules = parse_spec(spec)
        _armed = FaultInjector(rules, spec_text=spec, rank=rank)
        from ..utils import logging as hvd_logging
        hvd_logging.get_logger().warning(
            "chaos: armed %d fault rule(s): %s", len(rules),
            "; ".join(r.describe() for r in rules))
        return _armed


def disarm() -> None:
    global _armed
    with _arm_lock:
        _armed = None


def arm_from_env() -> Optional[FaultInjector]:
    """Arm from ``HVDTPU_FAULTS`` (all config prefixes) if set; called
    at package import (launcher processes never call ``init()``) and
    again from ``init()``.  Import-time arming logs-and-skips on a bad
    spec — imports must not crash — while ``init()`` re-arms strictly."""
    for prefix in ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_"):
        spec = os.environ.get(prefix + "FAULTS")
        if spec:
            try:
                return arm(spec)
            except ValueError as e:
                from ..utils import logging as hvd_logging
                hvd_logging.get_logger().error(
                    "chaos: ignoring bad %sFAULTS: %s", prefix, e)
                return None
    return None


arm_from_env()
