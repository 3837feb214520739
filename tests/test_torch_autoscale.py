"""Port parity: autoscale (``horovod_tpu_torch/autoscale/``), copies of the
JAX package's policy and controller.

The policy's decisions equal the reference's on the same ``Signals``
sequences under the same fake clock (random walks over every signal and
every knob, and the reference test's named cases); ``signals_from_families``
distils the same snapshots alike; the controller, with a fake collect and
bump, grows, records an observed shrink, survives a failing collect and
forecasts, as in ``tests/test_autoscale.py``.  Tolerance: equality.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from horovod_tpu import autoscale as ref
from horovod_tpu_torch import autoscale as port
from horovod_tpu_torch.obs import REGISTRY


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _pair(**kw):
    clock = FakeClock()
    cfg = dict(min_np=1, max_np=8, scale_up_cooldown_s=30.0,
               scale_down_cooldown_s=120.0)
    cfg.update(kw)
    return (ref.ScalePolicy(ref.PolicyConfig(**cfg), clock=clock),
            port.ScalePolicy(port.PolicyConfig(**cfg), clock=clock), clock)


def _decide_both(rp, pp, **sig):
    a = rp.decide(ref.Signals(**sig))
    b = pp.decide(port.Signals(**sig))
    assert dataclasses.asdict(b) == dataclasses.asdict(a), sig
    return b


def _random_signals(rng: random.Random) -> dict:
    cur = rng.randint(1, 8)
    return dict(
        current_np=cur, available_slots=rng.randint(0, 10),
        queue_depth=rng.choice([0.0, 0.5, 1.0, 4.0, 8.0, 20.0]),
        stragglers=rng.choice([0, 0, 1]),
        burn_fast=rng.choice([0.0, 0.5, 1.5, 30.0]),
        burn_slow=rng.choice([0.0, 0.9, 1.2, 10.0]),
        signal_age_s=rng.choice([0.0, 1.0, 12.0, float("inf")]),
        queue_forecast=rng.choice([None, 2.0, 9.0]),
        burn_forecast=rng.choice([None, 0.5, 3.0]))


@pytest.mark.parametrize("seed", range(6))
def test_policy_decisions_equal_the_references_on_random_sequences(seed):
    rng = random.Random(seed)
    knobs = dict(queue_high=rng.choice([4.0, 8.0]),
                 queue_low=rng.choice([0.0, 1.0]),
                 burn_threshold=rng.choice([1.0, 2.0]),
                 stale_after_s=10.0, shrink_divisor=rng.choice([2, 3]),
                 forecast_horizon_s=rng.choice([0.0, 30.0]),
                 min_np=rng.choice([1, 2]), max_np=rng.choice([4, 8]))
    rp, pp, clock = _pair(**knobs)
    actions = set()
    for _ in range(300):
        clock.t += rng.choice([0.0, 1.0, 15.0, 60.0, 200.0])
        actions.add(_decide_both(rp, pp, **_random_signals(rng)).action)
    assert "hold" in actions and len(actions) >= 2, actions


@pytest.mark.parametrize("case", [
    dict(queue_depth=20.0),                                  # grow
    dict(queue_depth=0.0, current_np=4),                     # shrink
    dict(queue_depth=4.0),                                   # band: hold
    dict(burn_fast=50.0, burn_slow=0.2),                     # one window
    dict(burn_fast=1.5, burn_slow=1.5),                      # both burn
    dict(queue_depth=20.0, available_slots=3),               # clamp
    dict(queue_depth=0.0, stragglers=1),                     # veto
    dict(queue_depth=20.0, signal_age_s=99.0),               # stale
    dict(queue_depth=2.0, queue_forecast=12.0),              # predicted
])
def test_policy_named_cases_equal_the_references(case):
    rp, pp, clock = _pair(forecast_horizon_s=30.0)
    clock.t += 1000.0                  # past the warm-up grace
    sig = {**dict(current_np=2, available_slots=8), **case}
    _decide_both(rp, pp, **sig)
    clock.t += 5.0                     # inside the cooldowns
    _decide_both(rp, pp, **sig)


def _fam(name, *samples):
    return {"name": name,
            "samples": [{"labels": lb, "value": v} for lb, v in samples]}


_FAMS = [
    _fam("horovod_tpu_rank_snapshot_age_seconds",
         ({"rank": "0"}, 1.0), ({"rank": "1"}, 99.0), ({"rank": "2"}, 3.0)),
    _fam("hvd_engine_queue_depth",
         ({"rank": "0"}, 3.0), ({"rank": "1"}, 50.0), ({"rank": "2"}, 7.0)),
    _fam("horovod_tpu_straggler",
         ({"rank": "0", "tensor": "t"}, 0.0),
         ({"rank": "1", "tensor": "t"}, 2.0),
         ({"rank": "2", "tensor": "u"}, 1.0)),
    _fam("hvd_serving_pool_info",
         ({"rank": "0", "pool": "prefill"}, 1.0),
         ({"rank": "2", "pool": "decode"}, 1.0)),
    _fam("hvd_slo_burn_rate",
         ({"rank": "0", "slo": "s", "window": "5m"}, 2.5),
         ({"rank": "0", "slo": "s", "window": "1h"}, 1.5),
         ({"rank": "1", "slo": "s", "window": "5m"}, 90.0)),
]


@pytest.mark.parametrize("pool", [None, "prefill", "decode", "mixed"])
def test_signals_from_families_equal_the_references(pool):
    for fams in (_FAMS, []):
        kw = dict(current_np=2, available_slots=4, stale_after_s=10.0,
                  pool=pool)
        a = ref.signals_from_families(fams, **kw)
        b = port.signals_from_families(fams, **kw)
        assert dataclasses.asdict(b) == dataclasses.asdict(a)


def _controller(fams, *, current_np, capacity, prev_np=None, **kw):
    clock = FakeClock()
    policy = port.ScalePolicy(port.PolicyConfig(
        **{**dict(min_np=1, max_np=8, scale_up_cooldown_s=30.0,
                  scale_down_cooldown_s=120.0), **kw}), clock=clock)
    clock.t += 1000.0
    bumps, targets = [], []
    c = port.AutoscaleController(
        policy, current_np=current_np, prev_np=prev_np,
        collect=lambda: fams, bump=lambda: bumps.append(1),
        capacity=lambda: capacity, set_target=targets.append)
    return c, bumps, targets


def test_controller_grow_bumps_and_sets_target():
    fams = [_fam("horovod_tpu_rank_snapshot_age_seconds", ({"rank": "0"},
                                                           0.5)),
            _fam("hvd_engine_queue_depth", ({"rank": "0"}, 20.0))]
    c, bumps, targets = _controller(fams, current_np=2, capacity=4)
    d = c.poll_once()
    assert d.action == "grow" and bumps == [1] and targets == [4]
    # the cooldown makes the next tick a hold: no duplicate bump
    assert c.poll_once().action == "hold" and bumps == [1]


def test_controller_records_observed_shrink():
    c, bumps, _ = _controller([], current_np=2, capacity=2, prev_np=4)
    metric = REGISTRY.get("hvd_autoscale_decisions_total")
    before = metric.labels(action="shrink").value
    c.start()
    c.stop()
    assert metric.labels(action="shrink").value == before + 1
    assert not bumps          # observed, not initiated: nothing to signal
    assert c.decisions and c.decisions[0].action == "shrink"


def test_controller_survives_collect_failure():
    policy = port.ScalePolicy(port.PolicyConfig())

    def boom():
        raise ConnectionError("kv down")

    c = port.AutoscaleController(policy, current_np=2, collect=boom,
                                 bump=lambda: None, capacity=lambda: 2)
    d = c.poll_once()
    assert d.action == "hold" and "stale" in d.reason, d


def test_predictive_grow_leg_of_the_scenario():
    from horovod_tpu_torch.chaos import run as chaos_run
    chaos_run._predictive_grow_leg()


def test_launcher_builds_the_policy_from_the_knobs(monkeypatch, tmp_path):
    """``--autoscale`` hands ``run_job`` a PolicyConfig from the
    ``HVDTPU_AUTOSCALE_*`` knobs, as the reference's ``run_elastic``."""
    from horovod_tpu_torch.runner import elastic as E
    from horovod_tpu_torch.runner import launch as L
    seen = {}

    def fake_run_job(self, command, **kw):
        seen.update(kw)
        return 0

    monkeypatch.setattr(E.ElasticDriver, "run_job", fake_run_job)
    monkeypatch.setattr(L, "_install_sigterm_exit", lambda: None)
    monkeypatch.setenv("HVDTPU_AUTOSCALE_QUEUE_HIGH", "12")
    script = tmp_path / "d.sh"
    script.write_text("#!/bin/sh\necho localhost:2\n")
    script.chmod(0o755)
    assert L.main(["-np", "2", "--min-np", "1", "--max-np", "4",
                   "--host-discovery-script", str(script), "--autoscale",
                   "--autoscale-interval", "0.5", "--", "true"]) == 0
    pc = seen["autoscale"]
    assert (pc.min_np, pc.max_np, pc.queue_high) == (1, 4, 12.0)
    assert seen["autoscale_interval_s"] == 0.5
