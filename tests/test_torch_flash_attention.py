"""Port parity: flash attention of ``horovod_tpu_torch`` against the JAX
package's Pallas kernels.

The same inputs, drawn with numpy from a seed, go through the JAX
package's ``_flash_forward`` / ``_flash_backward`` (``interpret=True``, as
its own tests run them on the CPU) and through the port's wrappers on CPU
tensors, which run the kernels' plain PyTorch versions.  The CUDA kernels
run only on the card; ``chip_smoke.py`` holds them against the plain
versions there.  Tolerances are those of ``tests/test_flash_attention.py``:
2e-5 for the forward, 2e-4 for gradients (fp32, sums in another order).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as JFA
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as FA

B, S, H, D = 2, 256, 4, 64
SCALE = 1.0 / np.sqrt(D)


def _qkv(seed, kv):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, kv, D).astype(np.float32)
    v = rng.randn(B, S, kv, D).astype(np.float32)
    do = rng.randn(B, S, H, D).astype(np.float32)
    return q, k, v, do


def _jax_fwd(q, k, v, causal):
    o, lse = JFA._flash_forward(*map(jnp.asarray, (q, k, v)), scale=SCALE,
                                causal=causal, block_q=128, block_k=128,
                                interpret=True)
    return np.array(o), np.array(lse).reshape(B, H, S)


@pytest.mark.parametrize("kv,causal", [(4, True), (4, False), (2, True),
                                       (2, False)])
def test_forward_reference_matches_pallas(kv, causal):
    q, k, v, _ = _qkv(0, kv)
    jo, jlse = _jax_fwd(q, k, v, causal)
    to, tlse = FA.flash_forward(*map(torch.from_numpy, (q, k, v)), SCALE,
                                causal)
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (B, H, S)
    np.testing.assert_allclose(to.numpy(), jo, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), jlse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv,causal", [(4, True), (2, True), (2, False)])
def test_backward_references_match_pallas(kv, causal):
    """dq, dk, dv from the same (q, k, v, o, lse, dO) through the JAX
    backward kernels and the port's plain versions; delta is computed
    outside the kernels on both sides."""
    q, k, v, do = _qkv(1, kv)
    jo, jlse = _jax_fwd(q, k, v, causal)
    jdq, jdk, jdv = JFA._flash_backward(
        *map(jnp.asarray, (q, k, v, jo)), jnp.asarray(jlse.reshape(B * H, S)),
        jnp.asarray(do), scale=SCALE, causal=causal, block_q=128,
        block_k=128, interpret=True)
    tq, tk, tv, tdo, to = map(torch.from_numpy, (q, k, v, do, jo))
    tlse = torch.from_numpy(jlse)
    delta = FA.flash_delta(to, tdo)
    dq = FA.flash_backward_dq(tq, tk, tv, tdo, tlse, delta, SCALE, causal)
    dk, dv = FA.flash_backward_dkv(tq, tk, tv, tdo, tlse, delta, SCALE,
                                   causal)
    assert tuple(dk.shape) == tuple(dv.shape) == (B, S, kv, D)
    for name, t, j in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("kv", [4, 2])
def test_flash_attention_grad_matches_jax(kv):
    """``torch.autograd.grad`` of ``sum(flash_attention(q, k, v) ** 2)``
    through the autograd Function against ``jax.grad`` of the JAX custom
    VJP with the Pallas kernels in interpret mode."""
    q, k, v, _ = _qkv(2, kv)

    def jloss(q, k, v):
        return jnp.sum(JFA.flash_attention(q, k, v, None, True, 128, 128,
                                           True) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FA.flash_attention(tq, tk, tv)
    tg = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for name, t, j in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_plain_versions_match_dense_oracles():
    """The port's dense oracle equals the JAX one, and the plain flash
    forward equals it (bf16 inputs, where only p's rounding differs)."""
    q, k, v, _ = _qkv(3, 2)
    for causal in (True, False):
        jd = JFA.dense_attention(*map(jnp.asarray, (q, k, v)), SCALE, causal)
        td = FA.dense_attention(*map(torch.from_numpy, (q, k, v)), SCALE,
                                causal)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-5,
                                   atol=2e-5)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    o, _ = FA.flash_forward(tq, tk, tv, SCALE, True)
    ref = FA.dense_attention(tq, tk, tv, SCALE, True)
    assert o.dtype == torch.bfloat16
    # Two bf16 roundings of values of order 1: within 2^-6 of each other.
    np.testing.assert_allclose(o.float().numpy(), ref.float().numpy(),
                               atol=2 ** -6)


@pytest.mark.parametrize("shape,dtype,kv,ok", [
    ((1, 4096, 32, 128), torch.bfloat16, 32, True),
    ((2, 2048, 32, 128), torch.bfloat16, 8, True),
    ((2, 1024, 16, 64), torch.bfloat16, None, True),
    ((1, 4096, 32, 128), torch.float32, 32, False),
    ((1, 4096, 32, 96), torch.bfloat16, 32, False),
    ((1, 4000, 32, 128), torch.bfloat16, 32, False),
    ((1, 4096, 32, 128), torch.bfloat16, 12, False),
])
def test_supported_gates_the_kernels(shape, dtype, kv, ok):
    assert FA.supported(shape, dtype, kv) is ok
    assert FA.default_blocks(shape[1]) == (FA.FLASH_BLOCK, FA.FLASH_BLOCK)


@pytest.mark.parametrize("edit,match", [
    (dict(dtype=torch.float32), "bf16"),
    (dict(D=96), "head dim"),
    (dict(S=100), "multiple of 64"),
])
def test_kernel_input_checks_refuse(edit, match):
    """What the CUDA kernels do not take raises before any launch (checked
    on CPU tensors; the wrappers run it for CUDA tensors)."""
    kw = dict(S=128, D=64, dtype=torch.bfloat16)
    kw.update(edit)
    q = torch.zeros(1, kw["S"], 4, kw["D"], dtype=kw["dtype"])
    k = torch.zeros(1, kw["S"], 2, kw["D"], dtype=kw["dtype"])
    with pytest.raises(ValueError, match=match):
        FA._check_flash_kernel_inputs(q, k, k)


def test_kernel_input_checks_accept_the_training_layout():
    q = torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    FA._check_flash_kernel_inputs(q, k, k, q)
    with pytest.raises(ValueError, match="must be"):
        FA._check_flash_kernel_inputs(q, k, k, q.float())
    with pytest.raises(ValueError, match="divide"):
        FA.flash_attention(q, k[:, :, :1].expand(1, 128, 3, 64), k[:, :, :1]
                           .expand(1, 128, 3, 64))


@pytest.mark.parametrize("bad", ["dtype", "shape", "misaligned"])
def test_backward_input_checks_refuse_bad_lse(bad):
    """The backward kernels stage lse and delta as 16-byte copies of
    contiguous fp32 [B, H, S] rows; anything else raises before a launch."""
    q = torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 128)
    FA._bwd_inputs(q, k, k, q, lse, lse)
    bad_lse = {"dtype": lse.double(), "shape": lse[:, :2],
               "misaligned": torch.zeros(4 * 128 + 1)[1:].view(1, 4, 128)}
    with pytest.raises(ValueError, match="lse must be"):
        FA._bwd_inputs(q, k, k, q, bad_lse[bad], lse)


def test_cpu_calls_leave_the_launch_counters_at_zero():
    before = (FA.flash_forward.launches, FA.flash_backward_dq.launches,
              FA.flash_backward_dkv.launches)
    q, k, v, _ = _qkv(4, 2)
    tq, tk, tv = (torch.from_numpy(x[:, :64]).requires_grad_()
                  for x in (q, k, v))
    FA.flash_attention(tq, tk, tv).sum().backward()
    FA.flash_attention(tq, tk, tv, plain=True).sum().backward()
    assert (FA.flash_forward.launches, FA.flash_backward_dq.launches,
            FA.flash_backward_dkv.launches) == before


def test_flash_flops_counts_the_causal_triangle():
    # One causal S x S x D product over 32 heads at S=4096, D=128:
    # 68.7 GFLOP; the forward runs two of them.
    one = FA.flash_flops((1, 4096, 32, 128), True, 1)
    assert abs(one - 68.7e9) < 0.1e9
    assert FA.flash_flops((1, 4096, 32, 128), True, 2) == 2 * one
    assert FA.flash_flops((2, 1024, 16, 64), False, 1) == \
        2 * 2 * 16 * 1024 * 1024 * 64


def test_kernel_sources_export_bound_symbols():
    """Each flash library's ctypes signatures name functions its CUDA
    source exports with C linkage; every source notes the TPU kernel it
    replaces; the build hash covers the shared header."""
    for lib in ("flash_fwd", "flash_bwd"):
        sigs = FA._SIGNATURES[lib]
        src = (_build.SRC_DIR / f"{lib}.cu").read_text()
        c_block = src[src.index('extern "C"'):]
        for fn in sigs:
            assert re.search(rf"\b{fn}\s*\(", c_block), (lib, fn)
        assert "Replaces" in src and "horovod_tpu/ops/flash_attention.py" \
            in src, lib
        assert '#include "flash_common.cuh"' in src, lib
    common = (_build.SRC_DIR / "flash_common.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in common
