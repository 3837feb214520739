"""The trace reduction: unions over streams, idle share, the runtime's
exposed time and the breakdown."""

from __future__ import annotations

import pytest

from portbench.harness import layers, trace
from portbench.harness.trace import Interval, Profile


def _profile(device, region=(0.0, 10.0), steps=1):
    return Profile(device=[Interval(n, s, e, st) for n, s, e, st in device],
                   host=[Interval("aten::mm", 0.0, 10.0),
                         Interval("Optimizer.step", 6.0, 7.5)],
                   region=region, steps=steps)


def test_union_and_subtract():
    assert trace.union([(3, 4), (0, 2), (1, 3), (6, 6)]) == [(0, 4)]
    assert trace.subtract([(0, 10)], [(1, 2), (4, 6)]) == \
        [(0, 1), (2, 4), (6, 10)]
    assert trace.subtract([(0, 3), (5, 9)], [(2, 6)]) == [(0, 2), (6, 9)]


@pytest.mark.parametrize("overlap", [0.0, 1.0, 4.0])
def test_idle_share_never_below_zero_with_overlapping_streams(overlap):
    # Compute on stream 7 for the whole region; the runtime's kernels on
    # other streams overlap it by ``overlap`` seconds or all of it.
    p = _profile([("gemm", 0.0, 10.0, 7), ("ncclKernel_AllReduce",
                                           10.0 - overlap, 10.0, 9),
                  ("copy", 2.0, 3.0, 9)])
    assert trace.busy_s(p) == pytest.approx(10.0)
    ctx = type("Ctx", (), {"profiles": [p]})
    assert layers.idle_share_pct(ctx) == pytest.approx(0.0)
    assert layers.exposed_ms(p) == 0.0
    assert layers.runtime_ms(p) == pytest.approx(
        1e3 * (1.0 + overlap if overlap <= 7 else 10.0))


def test_exposed_runtime_and_idle():
    p = _profile([("gemm", 0.0, 4.0, 7), ("nccl_allreduce", 3.0, 6.0, 9),
                  ("adam", 7.5, 9.0, 7)], steps=2)
    assert layers.exposed_ms(p) == pytest.approx(1e3 * 2.0 / 2)
    assert layers.runtime_ms(p) == pytest.approx(1e3 * 3.0 / 2)
    assert trace.idle_gaps(p) == [(6.0, 7.5), (9.0, 10.0)]
    ctx = type("Ctx", (), {"profiles": [p]})
    assert layers.idle_share_pct(ctx) == pytest.approx(25.0)
    b = trace.breakdown(p)
    assert b["device_ops"][0] == ["gemm", 2.0]
    assert b["idle_gaps"][0] == ["Optimizer.step", 1.5]


def test_short_names_and_round_trip():
    assert trace.short_name("void flash_fwd_kernel<128, true>(CUtensorMap)"
                            ) == "flash_fwd_kernel"
    assert trace.short_name("void at::native::(anonymous namespace)::"
                            "multi_tensor_apply_kernel<T>(int)") == \
        "at::native::multi_tensor_apply_kernel"
    p = _profile([("a", 0.0, 1.0, 1), ("b", 2.0, 3.0, 2)])
    q = trace.from_json(trace.to_json(p))
    assert [(d.name, d.start, d.end, d.stream) for d in q.device] == \
        [(d.name, d.start, d.end, d.stream) for d in p.device]
    assert q.region == p.region and q.steps == p.steps


def test_roofline_share_from_launches():
    p = _profile([("void flash_fwd_kernel<128>", 0.0, 2e-3, 7),
                  ("void flash_fwd_kernel<128>", 3e-3, 5e-3, 7)])
    ctx = type("Ctx", (), {"profiles": [p]})
    assert layers.roofline_pct(ctx, {"flash_fwd_kernel": 1e-3}) == \
        pytest.approx(50.0)
    assert layers.roofline_pct(ctx, {"flash_bwd_dq_kernel": 1e-3}) is None
