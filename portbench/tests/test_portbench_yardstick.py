"""The copied arithmetic against hand counts."""

from __future__ import annotations

import pytest

from portbench.harness import spec, yardstick

MISTRAL = spec.read_json(spec.BENCH_DIR / "configs" / "mistral-7b.json")
RESNET = spec.read_json(spec.BENCH_DIR / "configs" / "resnet50.json")


def test_mistral_parameters():
    # per layer: wq, wo 4096^2; wk, wv 4096 x 1024; three 4096 x 14336
    # MLP matrices; two norms.  Embedding and head 32768 x 4096 each.
    layer = 2 * 4096 ** 2 + 2 * 4096 * 1024 + 3 * 4096 * 14336 + 2 * 4096
    assert layer == 218_112_000
    assert yardstick.llama_params(MISTRAL) == 7_248_023_552
    assert yardstick.llama_params(MISTRAL) == \
        32 * layer + 2 * 32768 * 4096 + 4096


def test_mistral_flops_per_token():
    f = yardstick.llama_flops_per_token(MISTRAL, 4096)
    assert f == 6 * 7_248_023_552 + 12 * 32 * 4096 * 4096
    assert f / 1e9 == pytest.approx(49.93, abs=0.005)


def test_flash_forward_bound():
    B, S, H, KV, D = 1, 4096, 32, 8, 128
    flops = yardstick.flash_flops(B, S, H, D, True, 2)
    assert flops == 2 * 2 * H * (S * (S + 1) // 2) * D
    nbytes = yardstick.flash_bytes(B, S, H, KV, D, "fwd")
    assert nbytes == 2 * (2 * S * H * D + 2 * S * KV * D) + 4 * H * S
    t = yardstick.bound_s(nbytes, flops)
    assert t * 1e3 == pytest.approx(0.139, abs=0.0005)
    assert flops / yardstick.BF16_FLOPS > nbytes / yardstick.HBM_BYTES_PER_S


def test_flash_backward_bounds():
    B, S, H, KV, D = 1, 4096, 32, 8, 128
    dq = yardstick.bound_s(yardstick.flash_bytes(B, S, H, KV, D, "dq"),
                           yardstick.flash_flops(B, S, H, D, True, 3))
    dkv = yardstick.bound_s(yardstick.flash_bytes(B, S, H, KV, D, "dkv"),
                            yardstick.flash_flops(B, S, H, D, True, 4))
    assert dq * 1e3 == pytest.approx(0.209, abs=0.0005)
    assert dkv * 1e3 == pytest.approx(0.278, abs=0.0005)


def test_resnet50_macs_match_the_port():
    from horovod_tpu_torch.models import resnet

    macs = yardstick.resnet_forward_macs(RESNET["stage_sizes"],
                                         RESNET["width"],
                                         RESNET["num_classes"],
                                         RESNET["image_size"])
    model = resnet.resnet50(num_classes=1000, device="meta")
    assert macs == resnet.forward_macs(model, 224)
    assert 3 * 2 * macs / 1e9 == pytest.approx(24.5, abs=0.2)
