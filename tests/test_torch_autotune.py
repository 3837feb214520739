"""Port parity: the online autotuner, ``horovod_tpu_torch.utils.autotune``.

The port's tuner searches what the JAX package's searches in a
multi-process job (``engine.distributed``): fusion threshold, cycle time
and bucket cap, with wire precision, schedule and hierarchy pinned.  Both
tuners are fed the same deterministic scores (made from a seed) through a
fake state, as ``tests/test_aux.py`` drives the reference, and every
decision is compared exactly: the knobs committed to the config after
every cycle, the samples and their scores, the final knobs and the log
lines (without their time stamps).  Wall clock is never compared.

Also here: the engine's fusion under a bucket cap against the JAX
engine's ``_fuse`` on the same entries, and the cap every rank agrees on
through the echoed negotiation metas.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from horovod_tpu import config as ref_config
from horovod_tpu.ops import engine as ref_engine
from horovod_tpu.utils import autotune as ref_at
from horovod_tpu_torch import config as port_config
from horovod_tpu_torch.ops import engine as port_engine
from horovod_tpu_torch.ops.collectives import ReduceOp
from horovod_tpu_torch.utils import autotune as at


class _Engine:
    distributed = True


class _State:
    pass


def _tuner(pkg: str, log, **cfg):
    mod, cfg_mod = (ref_at, ref_config) if pkg == "ref" else (at, port_config)
    st = _State()
    st.engine, st.size = _Engine(), 2
    st.config = cfg_mod.Config(autotune=True, autotune_log=str(log), **cfg)
    return mod.Autotuner(st), st.config


def _score(knobs, rng, shape: str) -> tuple:
    """(payload bytes, cycle seconds) of one busy cycle under ``knobs``."""
    t, c, _, _, _, b = knobs
    if shape == "threshold":
        bias = 1.0 + (np.log2(t) - 20) * 0.1
    elif shape == "bowl":
        bias = 2.0 - abs(np.log2(t) - 23) * 0.1 - abs(np.log2(c)) * 0.05
    else:                                   # flat and noisy
        bias = 1.0
    bias += {0: 0.0, 4 << 20: 0.04, 32 << 20: -0.02}.get(b, 0.01)
    return int(1e6 * bias + rng.randint(0, 1000)), 0.001 + rng.rand() * 1e-5


def _run(pkg: str, log, shape: str, seed: int, cycles: int = 400, **cfg):
    tuner, config = _tuner(pkg, log, **cfg)
    rng = np.random.RandomState(seed)
    commits = []
    for i in range(cycles):
        if tuner._done:
            break
        payload, secs = _score(tuner._current, rng, shape)
        if i % 17 == 5:
            payload = 0                     # an idle cycle scores nothing
        tuner.record_cycle(payload, secs)
        commits.append((config.fusion_threshold, config.cycle_time_ms,
                        config.bucket_bytes))
    lines = [ln.split(" ", 1)[1] for ln in log.read_text().splitlines()]
    return {"commits": commits, "raw": tuner._samples_raw,
            "X": tuner._samples_X, "y": tuner._samples_y,
            "current": tuner._current, "done": tuner._done, "log": lines,
            "pinned": (config.wire_precision, config.sched_mode,
                       config.hierarchical_allreduce)}


CASES = [("threshold", 0, {}),
         ("bowl", 1, {"autotune_warmup_samples": 1,
                      "autotune_steps_per_sample": 2}),
         ("noisy", 2, {"autotune_warmup_samples": 0,
                       "autotune_steps_per_sample": 1, "cycle_time_ms": 2.5}),
         ("bowl", 3, {"bucket_bytes": 7 << 20, "fusion_threshold": 1 << 22}),
         ("threshold", 4, {"autotune_steps_per_sample": 3,
                           "cycle_time_ms": 0.5})]


@pytest.mark.parametrize("shape,seed,cfg", CASES)
def test_decisions_match_reference_multi_process_mode(tmp_path, shape, seed,
                                                      cfg):
    ref = _run("ref", tmp_path / "ref.log", shape, seed, **cfg)
    port = _run("port", tmp_path / "port.log", shape, seed, **cfg)
    assert port == ref
    assert port["y"] and any("sample #" in ln for ln in port["log"])
    assert port["pinned"] == ("fp32", "monolithic", False)


def test_grid_and_pins_match_reference(tmp_path):
    ref, _ = _tuner("ref", tmp_path / "r.log", bucket_bytes=7 << 20)
    port, _ = _tuner("port", tmp_path / "p.log", bucket_bytes=7 << 20)
    assert port._grid_raw == ref._grid_raw
    assert np.array_equal(port._grid, ref._grid)
    assert port._buckets == ref._buckets == at._BUCKET_BYTES + [7 << 20]
    assert (at._THRESHOLDS, at._CYCLE_TIMES, at._SETTLE_CYCLES) == \
        (ref_at._THRESHOLDS, ref_at._CYCLE_TIMES, ref_at._SETTLE_CYCLES)
    assert {g[2:5] for g in port._grid_raw} == \
        {("fp32", "monolithic", "flat")}


def test_converged_knobs_are_exact_grid_values(tmp_path):
    tuner, config = _tuner("port", tmp_path / "a.log", cycle_time_ms=2.5,
                           autotune_warmup_samples=0,
                           autotune_steps_per_sample=1)
    rng = np.random.RandomState(0)
    for _ in range(400):
        if tuner._done:
            break
        tuner.record_cycle(int(1e6 + rng.randint(0, 1000)), 0.001)
    assert tuner._done
    t, c, _, _, _, b = tuner._current
    assert (config.fusion_threshold, config.cycle_time_ms,
            config.bucket_bytes) == (t, c, b)
    assert t in at._THRESHOLDS and c in at._CYCLE_TIMES + [2.5]
    assert b in at._BUCKET_BYTES
    for (rt, *_), (xt, *_) in zip(tuner._samples_raw, tuner._samples_X):
        assert 2.0 ** xt == pytest.approx(rt)


def test_settle_cycles_are_discarded(tmp_path):
    tuner, _ = _tuner("port", tmp_path / "s.log", autotune_warmup_samples=0,
                      autotune_steps_per_sample=1)
    tuner.record_cycle(1000, 0.001)          # sample #1 -> propose -> apply
    assert tuner._settle_left == at._SETTLE_CYCLES
    n = len(tuner._samples_y)
    for _ in range(at._SETTLE_CYCLES):
        tuner.record_cycle(10 ** 12, 5.0)
    assert len(tuner._samples_y) == n and tuner._acc_cycles == 0
    tuner.record_cycle(1000, 0.001)
    assert len(tuner._samples_y) == n + 1
    tuner._settle_left = at._SETTLE_CYCLES
    tuner.record_cycle(0, 0.001)             # idle: settles nothing
    assert tuner._settle_left == at._SETTLE_CYCLES


def test_metrics_follow_commits(tmp_path):
    from horovod_tpu_torch.obs import REGISTRY
    tuner, config = _tuner("port", tmp_path / "m.log",
                           autotune_warmup_samples=0,
                           autotune_steps_per_sample=1)
    before = REGISTRY.get("hvd_autotune_trials_total").value
    for _ in range(5):
        tuner.record_cycle(4096, 0.002)
    assert REGISTRY.get("hvd_autotune_trials_total").value == before + 2
    assert REGISTRY.get("hvd_autotune_fusion_threshold_bytes").value == \
        config.fusion_threshold
    assert REGISTRY.get("hvd_autotune_cycle_time_ms").value == \
        config.cycle_time_ms
    assert REGISTRY.get("hvd_autotune_score_bytes_per_s").value == \
        pytest.approx(4096 / 0.002)


# ---------------------------------------------------------------------------
# the engine's side: the bucket cap and the cap every rank agrees on
# ---------------------------------------------------------------------------

class _FuseSelf:
    def __init__(self, engine_cls, config):
        self._state = _State()
        self._state.config = config
        self._entry_bytes = engine_cls._entry_bytes
        self._group_cap = lambda: port_engine.CollectiveEngine._group_cap(self)


def _entries(seed: int):
    """Entries made from a seed, as both engines hold them: the same names,
    verbs, ops, dtypes and sizes (numpy payloads for the JAX engine, torch
    tensors for the port's)."""
    rng = np.random.RandomState(seed)
    ref, port = [], []
    for i in range(40):
        verb = "allreduce" if rng.rand() < 0.85 else "allgather"
        op = ["average", "sum"][rng.randint(2)]
        dt = ["float32", "bfloat16"][rng.randint(2)] if verb == "allreduce" \
            else "float32"
        n = int(rng.choice([1, 7, 1000, 1 << 18, 1 << 20]))
        a = np.zeros(n, np.float32 if dt == "float32" else np.float16)
        ref.append(ref_engine.TensorTableEntry(
            name=f"t{i}", verb=verb, payload=a,
            op=ref_engine.C.ReduceOp(op)))
        port.append(port_engine.TensorTableEntry(
            name=f"t{i}", verb=verb, payload=torch.zeros(
                n, dtype=getattr(torch, dt)), op=ReduceOp(op)))
    return ref, port


@pytest.mark.parametrize("threshold,bucket", [
    (64 << 20, 0), (64 << 20, 4 << 20), (1 << 20, 32 << 20),
    (4 << 20, 4 << 20), (3 << 20, 1 << 20)])
@pytest.mark.parametrize("seed", range(2))
def test_bucket_cap_splits_groups_as_the_reference(seed, threshold, bucket):
    ref_entries, port_entries = _entries(seed)
    names = []
    for mod, cfg_mod, entries in (
            (ref_engine, ref_config, ref_entries),
            (port_engine, port_config, port_entries)):
        cfg = cfg_mod.Config(fusion_threshold=threshold)
        cfg.bucket_bytes = bucket        # what the tuner commits
        me = _FuseSelf(mod.CollectiveEngine, cfg)
        groups = mod.CollectiveEngine._fuse(me, entries)
        names.append([[e.name for e in g] for g in groups])
    assert names[0] == names[1]
    assert sum(len(g) for g in names[1]) == len(port_entries)


def test_ranks_agree_on_the_cap_through_echoed_metas():
    """Two ranks whose tuners committed different caps fuse one cycle into
    the same groups: each fuses by the least cap among the metas the
    coordinator echoes to both."""
    _, entries = _entries(0)
    caps = {0: 1 << 20, 1: 32 << 20}
    metas = {}
    for r in (1, 0):                          # the lowest rank's meta wins
        for e in entries:
            e.cap = caps[r]
            metas[e.name] = e.meta()
    assert all(json.loads(m)["fc"] == caps[0] for m in metas.values())
    groups = []
    for r in (0, 1):
        cfg = port_config.Config(fusion_threshold=caps[r])
        me = _FuseSelf(port_engine.CollectiveEngine, cfg)
        cap = port_engine._agreed_cap(entries, metas, me._group_cap())
        groups.append([[e.name for e in g] for g in
                       port_engine.CollectiveEngine._fuse(me, entries, cap)])
    assert groups[0] == groups[1]
    assert port_engine._agreed_cap(entries, {}, 5) == 5
    # a joined rank still rebuilds the entry from the echoed meta
    m = port_engine._parse_joinable_meta(metas["t0"])
    assert m is None or m["fc"] == caps[0]
