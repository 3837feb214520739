"""Port parity: the SLO engine, ``horovod_tpu_torch.obs.slo``.

Held against the JAX package's ``horovod_tpu.obs.slo`` on the same
inputs, with equality as the tolerance (both are the same stdlib
arithmetic): spec parsing and its errors, the good fraction and quantile
of histograms made from a seed, burn rates over windows under a fake
clock (the cases of ``tests/test_obs.py``), bounded history, and the
process-wide arm / status / disarm.  The signal aliases name the
histograms the port's engine, negotiator and serving API register.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from horovod_tpu.obs import export as ref_export
from horovod_tpu.obs import slo as ref_slo
from horovod_tpu.obs.registry import MetricRegistry as RefRegistry
from horovod_tpu_torch.obs import export, slo
from horovod_tpu_torch.obs.registry import MetricRegistry

PKGS = {"ref": (RefRegistry, ref_slo, ref_export),
        "port": (MetricRegistry, slo, export)}

SPECS = ["p99(ttft) < 250ms over 5m", "p95(itl)<=50ms",
         "p50(my_hist_seconds) < 2s over 1h", "p99.9(queue_wait) < 1s over 30s",
         "p90(cycle) < 10us", "p75(negotiate_wait) <= 3 over 2m",
         "  p99 ( hvd_cycle_seconds ) < 0.5s over 90s  "]
BAD = ["p99(ttft)", "ttft < 250ms", "p0(ttft) < 1s", "p100(ttft) < 1s",
       "p99(ttft) < 0ms", "p99(ttft) < 1parsec", "p99(ttft) < 1s over 5d", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_reference(spec):
    assert dataclasses.asdict(slo.parse_spec(spec)) == \
        dataclasses.asdict(ref_slo.parse_spec(spec))
    assert slo.parse_spec(spec, name="x").describe() == \
        ref_slo.parse_spec(spec, name="x").describe()


@pytest.mark.parametrize("bad", BAD)
def test_parse_spec_rejects_in_both(bad):
    msgs = []
    for mod in (ref_slo, slo):
        with pytest.raises(mod.SLOError) as err:
            mod.parse_spec(bad)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_parse_spec_list_and_signals_match_reference():
    text = "a=p99(ttft) < 250ms over 5m; p95(itl) < 50ms;; cycle=p99(cycle)<1s"
    assert [dataclasses.asdict(s) for s in slo.parse_spec_list(text)] == \
        [dataclasses.asdict(s) for s in ref_slo.parse_spec_list(text)]
    assert slo.SIGNALS == ref_slo.SIGNALS
    assert slo.BURN_WINDOWS == ref_slo.BURN_WINDOWS


def test_signals_name_the_ports_histograms():
    """Every alias names a histogram the port registers by that name."""
    from horovod_tpu_torch.obs import REGISTRY
    from horovod_tpu_torch.ops import engine, negotiator  # noqa: F401
    from horovod_tpu_torch.serving import api  # noqa: F401
    for alias, name in slo.SIGNALS.items():
        edges, cum = slo.cum_counts(name, REGISTRY)
        assert edges is not None, (alias, name)


def _histogram(seed: int):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 8)
    edges = tuple(float(e) for e in np.cumsum(rng.uniform(0.01, 1.0, n)))
    counts = rng.randint(0, 20, n + 1)
    if seed % 5 == 0:
        counts[:] = 0                    # an empty window
    return edges, [int(c) for c in np.cumsum(counts)]


@pytest.mark.parametrize("seed", range(12))
def test_good_fraction_and_quantile_match_reference(seed):
    edges, cum = _histogram(seed)
    rng = np.random.RandomState(100 + seed)
    thresholds = list(edges) + list(rng.uniform(0, edges[-1] * 1.5, 6))
    for t in thresholds:
        assert slo.good_fraction(edges, cum, t) == \
            ref_slo.good_fraction(edges, cum, t), t
    for q in (0.01, 0.5, 0.9, 0.99, 0.999):
        assert slo.quantile(edges, cum, q) == ref_slo.quantile(edges, cum, q)
    vals = list(rng.uniform(0, 2, 9))
    assert slo.attainment_of(vals, 0.7) == ref_slo.attainment_of(vals, 0.7)


def _burn_run(pkg: str) -> tuple:
    """The burn-rate case of tests/test_obs.py, every evaluation kept."""
    Reg, mod, exp = PKGS[pkg]
    reg = Reg()
    h = reg.histogram("lat_seconds", buckets=(1.0, 2.0))
    now = [0.0]
    eng = mod.SLOEngine(registry=reg, clock=lambda: now[0], tick_s=1.0,
                        burn_windows=(("fast", 60.0), ("slow", 600.0)))
    eng.add("p90(lat_seconds) < 1s over 60s", name="lat")
    eng.add("p50(lat_seconds) < 1.5s over 5m", name="med")
    outs = []
    eng.tick()
    rng = np.random.RandomState(7)
    for t, n_good, n_bad in ((30.0, 18, 2), (60.0, 0, 10), (150.0, 0, 0),
                             (400.0, 5, 40), (1200.0, 3, 0)):
        for v in rng.permutation([0.5] * n_good + [1.5] * n_bad):
            h.observe(float(v))
        h.observe(float(rng.uniform(2.0, 9.0)))       # one overflow
        now[0] = t
        eng.tick()
        outs.append(eng.evaluate())
    return outs, exp.to_prometheus(reg.snapshot())


def test_burn_rates_windows_and_violations_match_reference():
    (ref_outs, ref_text), (outs, text) = _burn_run("ref"), _burn_run("port")
    assert outs == ref_outs
    assert text == ref_text
    assert outs[1]["lat"]["met"] is False
    assert 'hvd_slo_violations_total{slo="lat"}' in text


def test_cum_counts_matches_reference():
    snaps = []
    for Reg, mod, _ in PKGS.values():
        reg = Reg()
        h = reg.histogram("cc_seconds", buckets=(0.1, 1.0),
                          labelnames=("k",))
        h.labels(k="a").observe(0.05)
        h.labels(k="b").observe(0.5)
        h.labels(k="b").observe(5.0)
        reg.counter("not_hist_total").inc()
        snaps.append([mod.cum_counts(n, reg) for n in
                      ("cc_seconds", "missing", "not_hist_total")])
    assert snaps[0] == snaps[1]
    assert snaps[1][0] == ((0.1, 1.0), [1, 2, 3])


def test_history_stays_bounded_as_in_reference():
    rings = []
    for Reg, mod, _ in PKGS.values():
        reg = Reg()
        h = reg.histogram("lat_seconds", buckets=(1.0,))
        now = [0.0]
        eng = mod.SLOEngine(registry=reg, clock=lambda: now[0], tick_s=10.0,
                            burn_windows=(("fast", 60.0), ("slow", 600.0)))
        eng.add("p90(lat_seconds) < 1s over 60s", name="lat")
        for i in range(300):
            h.observe(0.5 if i % 7 else 1.5)
            now[0] = float(i * 10)
            eng.tick()
        rings.append((list(eng._hist["lat_seconds"].snaps),
                      eng.evaluate()))
    assert rings[0] == rings[1]
    assert len(rings[1][0]) <= 640 / 10 + 3


def test_arm_status_disarm_roundtrip():
    spec = "rt=p99(ttft) < 250ms over 5m; cyc=p90(cycle) < 1s"
    got = []
    for mod in (ref_slo, slo):
        eng = mod.arm(spec, tick_s=3600)
        try:
            assert eng is not None and mod.status() != {}
            got.append({k: {f: v for f, v in d.items()}
                        for k, d in mod.status().items()})
        finally:
            mod.disarm()
        assert mod.status() == {}
        assert mod.arm("", tick_s=3600) is None
    assert got[0].keys() == got[1].keys() == {"rt", "cyc"}
    for name in got[0]:
        assert got[0][name]["spec"] == got[1][name]["spec"]
        assert got[0][name]["objective"] == got[1][name]["objective"]
