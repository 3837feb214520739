"""SLO-driven elastic autoscaling: the sense -> decide -> act loop.

A copy of ``horovod_tpu/autoscale``.

The observability plane publishes what the job feels (per-rank engine
queue depth, straggler gauges, the SLO engine's Google-SRE fast/slow
burn-rate pair on ``/cluster``) and the elastic driver knows how to
re-form the job on a new assignment — this package closes the loop
between them:

- :mod:`.policy` — the pure decision function.  Signals in, a
  ``Decision`` out; hysteresis band, per-direction cooldowns, fast AND
  slow burn gating, a blacklist-aware capacity clamp, and a
  frozen-signal no-op.  Injectable clock, no I/O, unit-testable without
  sleeping.
- :mod:`.controller` — the actuator.  Polls the cluster aggregator over
  the job's KV store, feeds the policy, records every decision as
  ``hvd_autoscale_*`` metrics + flight-recorder events, and drives
  elastic rendezvous: grow and voluntary shrink both go through the
  membership-epoch bump (workers retire cooperatively at their next
  commit boundary — state committed, exit with the reserved restart
  code, relaunch on the resized assignment).

Enabled by ``hvdrun --autoscale`` (elastic mode only); knobs ride the
usual three surfaces (``HVDTPU_AUTOSCALE_*`` env / CLI / YAML).
"""

from .policy import Decision, PolicyConfig, ScalePolicy, Signals  # noqa: F401
from .controller import (  # noqa: F401
    AutoscaleController,
    signals_from_families,
)
