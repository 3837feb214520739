"""Port parity: the performance model, ``horovod_tpu_torch.obs.perfmodel``.

Held against the JAX package's ``horovod_tpu.obs.perfmodel`` on the same
inputs, with equality as the tolerance (both are the same stdlib
arithmetic): ``expected_*`` and ``busbw_factor`` over a grid of verbs,
payload sizes, rank counts, wire modes and chunk counts, the
flat-vs-hierarchical ``hier_split_table``, and ``PerfModel`` folding the
same timings under a configured link and under its rolling peak (the
cases of ``tests/test_perfmodel.py``).  The engine's feed at two ranks
is ``tests/test_torch_obs_plane.py``'s.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

from horovod_tpu.obs import perfmodel as ref_pm
from horovod_tpu_torch.obs import perfmodel as pm

MODES = ("fp32", "bf16", "fp16", "int8", "fp8")
VERBS = ("allreduce", "grouped_allreduce", "adasum_allreduce", "allgather",
         "reducescatter", "alltoall", "broadcast")
SIZES = (0, 4096, 1 << 20, 3 * (1 << 22) + 12)
NS = (1, 2, 3, 4, 8)


def _asdict(cost):
    return dataclasses.asdict(cost)


@pytest.mark.parametrize("n", NS)
def test_busbw_factor_and_wire_widths_match_reference(n):
    for verb in VERBS:
        assert pm.busbw_factor(verb, n) == ref_pm.busbw_factor(verb, n)
    for mode, block, itemsize in itertools.product(MODES, (128, 512),
                                                   (2, 4)):
        assert pm.wire_per_elem(mode, itemsize, block) == \
            ref_pm.wire_per_elem(mode, itemsize, block)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mode", MODES)
def test_expected_allreduce_and_zero_match_reference(mode, n):
    for nbytes, k, compiled in itertools.product(SIZES, (1, 2, 4),
                                                 (False, True)):
        kw = dict(mode=mode, chunks=k, block=256, compiled=compiled)
        assert _asdict(pm.expected_allreduce(nbytes, n, **kw)) == \
            _asdict(ref_pm.expected_allreduce(nbytes, n, **kw))
        assert _asdict(pm.expected_zero_step(nbytes, n, param_bytes=nbytes // 2,
                                             **kw)) == \
            _asdict(ref_pm.expected_zero_step(nbytes, n,
                                              param_bytes=nbytes // 2, **kw))


@pytest.mark.parametrize("verb", VERBS[3:])
def test_expected_collective_matches_reference(verb):
    for nbytes, n, itemsize in itertools.product(SIZES, NS, (2, 4)):
        assert _asdict(pm.expected_collective(verb, nbytes, n,
                                              itemsize=itemsize)) == \
            _asdict(ref_pm.expected_collective(verb, nbytes, n,
                                               itemsize=itemsize))


@pytest.mark.parametrize("n_local,n_cross", [(1, 1), (2, 2), (4, 2), (8, 4)])
def test_expected_hierarchical_matches_reference(n_local, n_cross):
    for nbytes, mode, cross, k in itertools.product(
            SIZES, ("fp32", "bf16"), ("", "int8", "fp8"), (1, 3)):
        kw = dict(mode=mode, cross_mode=cross, chunks=k)
        assert _asdict(pm.expected_hierarchical(nbytes, n_local, n_cross,
                                                **kw)) == \
            _asdict(ref_pm.expected_hierarchical(nbytes, n_local, n_cross,
                                                 **kw))


@pytest.mark.parametrize("n,n_local", [(4, 2), (8, 4), (16, 8), (16, 4)])
def test_hier_split_table_matches_reference(n, n_local):
    """NVLink inside a node as the local tier, the inter-node fabric as
    the cross one: the flat ring is scored at the cross rate."""
    sizes = [1 << p for p in range(10, 28, 3)]
    for gbs_local, gbs_cross, cross in ((450.0, 50.0, ""),
                                        (450.0, 25.0, "int8"),
                                        (10.0, 10.0, "")):
        kw = dict(gbs_local=gbs_local, gbs_cross=gbs_cross,
                  cross_mode=cross, latency_us=2.0)
        assert pm.hier_split_table(sizes, n, n_local, **kw) == \
            ref_pm.hier_split_table(sizes, n, n_local, **kw)
    for mod in (pm, ref_pm):
        with pytest.raises(ValueError):
            mod.hier_split_table(sizes, n, 3, gbs_local=1.0, gbs_cross=1.0)


def _timings(seed: int):
    rng = np.random.RandomState(seed)
    for _ in range(30):
        verb = VERBS[rng.randint(len(VERBS))]
        yield (verb, int(rng.choice(SIZES)), int(rng.choice(NS)),
               float(rng.choice([0.0, -1.0, rng.uniform(1e-5, 1e-1)])),
               MODES[rng.randint(len(MODES))])


@pytest.mark.parametrize("link", [(0.0, 1.0), (25.0, 3.0)])
@pytest.mark.parametrize("seed", range(3))
def test_model_folds_timings_as_reference(seed, link):
    rows = []
    for mod in (ref_pm, pm):
        model = mod.PerfModel()
        model.configure(link_gbs=link[0], link_latency_us=link[1])
        got = [model.observe(verb, nbytes, n, secs, mode=mode)
               for verb, nbytes, n, secs, mode in _timings(seed)]
        got.append(model.observe_tiers(1 << 22, 4, 2, 0.01,
                                       tier_seconds={"cross": 0.007}))
        got.append(model.observe_schedule(
            descriptor="rs_ag:2", mode="fp32", payload_bytes=1 << 20, n=4,
            chunks=2, comm_windows=[(0.0, 0.002), (0.001, 0.004)],
            compute_windows=[(0.0005, 0.001)]))
        rows.append((got, model.summary()))
    assert rows[0] == rows[1]
    assert any(r is not None for r in rows[1][0])


def test_one_rank_and_degenerate_timings_are_ignored_in_both():
    for mod in (ref_pm, pm):
        model = mod.PerfModel()
        assert model.observe("allreduce", 1 << 20, 1, 0.01) is None
        assert model.observe("allreduce", 0, 4, 0.01) is None
        assert model.observe("allreduce", 1 << 20, 4, 0.0) is None
        assert model.summary() == []
