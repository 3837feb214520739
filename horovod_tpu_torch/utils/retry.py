"""Unified retry/backoff policy for every transient-failure path.

Before this module each subsystem invented its own loop: ``kv_get_blob``
restarted its full timeout per chunk, the elastic driver slept a fixed
poll interval through discovery-script crashes, the obs publisher gave
up for a whole interval on the first ``ConnectionError``, and the
metrics server abandoned its port on one ``EADDRINUSE``.  Retrying is a
*policy* decision — how long, how fast, which errors — and policies
multiply badly when each call site hand-rolls one.  This module is the
single place the runtime answers those questions:

- :class:`RetryPolicy` — declarative knobs: an overall **deadline**
  (the caller's budget, shared across every attempt — not per attempt),
  an optional attempt cap, capped exponential backoff, and
  **deterministic jitter** (seeded per ``(op, attempt)``, so two runs
  of the same job schedule identical sleeps — the property the chaos
  harness's reproducibility assertion rides on);
- :func:`retry_call` — run a callable under a policy (call-shaped
  sites: a KV chunk read, a socket bind);
- :class:`Backoff` — the iterator form for hand-written loops that
  interleave retrying with other work (the elastic slot wait, the
  publisher thread);
- :func:`retryable_error` — the shared transient-vs-permanent
  classifier (connection/timeout trouble retries; ``ValueError`` and
  friends never do — retrying a programming error just hides it).

Every retry and give-up increments an obs counter labeled by ``op``,
so a scrape answers "what is flaky right now" before anyone reads logs:
``hvd_retries_total{op}``, ``hvd_retry_giveups_total{op}``,
``hvd_retry_sleep_seconds_total{op}``.

Stdlib-only; safe to import from anywhere (including the launcher,
which never calls ``hvd.init()``).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Optional, Tuple, Type

from ..obs import REGISTRY as _obs

_m_retries = _obs.counter(
    "hvd_retries_total",
    "retried attempts after a transient failure, by operation", ("op",))
_m_giveups = _obs.counter(
    "hvd_retry_giveups_total",
    "operations that exhausted their retry budget (deadline or attempt "
    "cap) and surfaced the last error", ("op",))
_m_sleep = _obs.counter(
    "hvd_retry_sleep_seconds_total",
    "seconds spent in retry backoff sleeps, by operation", ("op",))

#: default transient classification: connection trouble, timeouts, and
#: OS-level I/O errors retry; everything else (ValueError, KeyError,
#: programming errors) surfaces immediately.
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError)


class Permanent(Exception):
    """Mix-in that vetoes retrying regardless of the other base classes
    — e.g. an overall-deadline-expired ``TimeoutError`` must surface,
    not burn more of a budget that is already gone."""


def retryable_error(err: BaseException,
                    retryable: Tuple[Type[BaseException], ...]
                    = DEFAULT_RETRYABLE) -> bool:
    """The shared transient-vs-permanent verdict."""
    if isinstance(err, Permanent):
        return False
    return isinstance(err, retryable)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How to retry: budget, schedule, classification.

    ``deadline_s`` is an OVERALL budget measured from the first attempt
    — every retry and every backoff sleep draws from the same clock, so
    a flaky dependency can never stretch the caller's wait to
    ``attempts x deadline`` (the bug this module replaced in
    ``kv_get_blob``).  ``max_attempts=None`` means attempts are bounded
    by the deadline alone; with both ``None`` the first failure
    surfaces (no retry).
    """

    max_attempts: Optional[int] = 3
    deadline_s: Optional[float] = None
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    #: +/- fraction of the delay, drawn from a DETERMINISTIC stream
    #: seeded by (seed, op, attempt) — reproducible schedules.
    jitter: float = 0.1
    seed: int = 0
    retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE

    def delay_for(self, op: str, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based), jittered
        deterministically."""
        d = self.base_delay_s * (self.multiplier ** (attempt - 1))
        d = min(d, self.max_delay_s)
        if self.jitter:
            rng = random.Random(f"{self.seed}:{op}:{attempt}")
            d *= 1.0 + rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)


#: conservative default for control-plane (KV store) round trips.
KV_POLICY = RetryPolicy(max_attempts=None, base_delay_s=0.02,
                        max_delay_s=0.5)


class Backoff:
    """Stateful backoff schedule for hand-written retry loops.

    ``next_delay()`` advances the exponential schedule — and counts the
    retry/sleep in the same obs series :func:`retry_call` maintains, so
    loop-shaped retriers (elastic discovery) are just as visible on a
    scrape as call-shaped ones.  ``reset()`` snaps back to the base
    delay after a success (a probing loop whose dependency recovered
    should probe fast again).
    """

    def __init__(self, policy: RetryPolicy, op: str) -> None:
        self.policy = policy
        self.op = op
        self._attempt = 0

    def next_delay(self) -> float:
        self._attempt += 1
        delay = self.policy.delay_for(self.op, self._attempt)
        _m_retries.labels(op=self.op).inc()
        _m_sleep.labels(op=self.op).inc(delay)
        return delay

    def reset(self) -> None:
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt


def retry_call(fn: Callable[[], Any], *, op: str,
               policy: RetryPolicy = RetryPolicy(),
               clock: Callable[[], float] = time.monotonic,
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Optional[Callable[[BaseException, int], None]]
               = None) -> Any:
    """Call ``fn()`` under ``policy``; return its value.

    Non-retryable errors surface immediately.  Retryable errors are
    retried on the backoff schedule until the attempt cap or the
    overall deadline runs out, then the LAST error is re-raised — the
    caller's except clauses keep matching the real failure type on
    every exhaustion path.  ``on_retry(err, attempt)`` observes each
    scheduled retry — loggers and tests hook it.
    """
    deadline = (clock() + policy.deadline_s
                if policy.deadline_s is not None else None)
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as err:  # noqa: BLE001 - classified below
            if not retryable_error(err, policy.retryable):
                raise
            attempt += 1
            if policy.max_attempts is not None \
                    and attempt >= policy.max_attempts:
                _m_giveups.labels(op=op).inc()
                raise
            delay = policy.delay_for(op, attempt)
            if deadline is not None:
                remaining = deadline - clock()
                if remaining <= 0:
                    _m_giveups.labels(op=op).inc()
                    raise
                delay = min(delay, remaining)
            _m_retries.labels(op=op).inc()
            _m_sleep.labels(op=op).inc(delay)
            if on_retry is not None:
                on_retry(err, attempt)
            if delay > 0:
                sleep(delay)
