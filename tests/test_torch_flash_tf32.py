"""The fp32 route of the ``flash_simple`` kernels (forward, dQ, dK/dV): 3xTF32.

On the card the three kernels multiply fp32 on the tensor cores in three
TF32 products: each operand x splits into ``hi = tf32(x)`` (round to
nearest) and ``lo = x - hi``, of which the tensor cores read the TF32
bits (its top 11 significant bits), and a product is ``lo.hi + hi.lo +
hi.hi`` (``lo.lo`` dropped), summed in fp32.  The kernels run only on the
card; here a plain PyTorch emulation of that product (:func:`tf32` rounds
by bit arithmetic on int32 views) computes the forward, dQ and dK/dV the
way the kernels do, and is held against the port's fp32 plain versions and
against the JAX package's Pallas kernels in interpret mode: every output
row within 1e-5 of its scale, the bar ``chip_smoke.py`` holds the card's
fp32 kernels to.  The emulation is a test helper, never on the main path.

The source test checks that the three kernels are tensor-core kernels fed
by asynchronous copies (bf16's forward and dQ at head dim 256 ``wgmma``
ones), and that the CUDA-core helpers the old dQ kernel used are gone.
"""

from __future__ import annotations

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as JFA
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as FA

B, H, S = 2, 4, 128
# chip_smoke.FLASH_ROW_TOL_FP32 and FLOOR_SHARE: a row's error against the
# larger of its own largest value and 1/8 of the median row's.
ROW_TOL = 1e-5
FLOOR_SHARE = 2.0 ** -3


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: half of the 13 dropped bits
    added to the magnitude, then the 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 register given as TF32: its
    top 10 mantissa bits, the low 13 dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' split: ``hi = tf32(x)`` and ``lo = x - hi`` (exact),
    as the tensor cores read them."""
    hi = tf32(x)
    return hi, tf32_read(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 as the kernels compute it: hi.hi in one sum, the
    cross terms lo.hi + hi.lo in another, added at the end."""
    ah, al = split(a.float())
    bh, bl = split(b.float())
    return torch.matmul(ah, bh) + (torch.matmul(al, bh) + torch.matmul(ah, bl))


def _scores(q, k, scale, causal):
    """Scaled, masked scores ``[B, H, S, S]`` of q against k (repeated to
    q's heads), the product in 3xTF32."""
    k = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    s = mm3(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale
    return FA._mask(s, causal)


def forward_3xtf32(q, k, v, scale, causal):
    """(o, lse) with both products in 3xTF32."""
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    vr = v.repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    return mm3(p, vr.transpose(1, 2)).transpose(1, 2), lse


def dkv_3xtf32(q, k, v, do, lse, delta, scale, causal):
    """(dk, dv) with all four products in 3xTF32, each kv group's q heads
    summed."""
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    vr = v.repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    dp = mm3(do.transpose(1, 2), vr.permute(0, 2, 3, 1))
    ds = p * (dp - delta[..., None]) * scale
    dv = mm3(p.transpose(-1, -2), do.transpose(1, 2)).transpose(1, 2)
    dk = mm3(ds.transpose(-1, -2), q.transpose(1, 2)).transpose(1, 2)
    return FA._group_sum(dk, k.shape[2]), FA._group_sum(dv, v.shape[2])


# Keys a tile of flash_simple_dq by padded head dim (csrc/flash_simple.cu
# DqCfg): each tile's dS K is summed from zero and added to dQ in fp32.
DQ_KEY_TILE = {32: 64, 64: 64, 128: 32, 256: 16}


def dq_3xtf32(q, k, v, do, lse, delta, scale, causal):
    """dq as flash_simple_dq computes it: S in 3xTF32; dP = dO V^T in
    3xTF32, except on the tiles the mask cuts (a warp's 16 rows against a
    key tile on the causal diagonal, or the ragged last key tile), where it
    is the plain versions' own fp32 product (an fp32 ``matmul``, which sums
    each element as one FMA chain over the head dim, as the kernel's
    ``fma_nt`` and cuBLAS's fp32 GEMM do); dS K in 3xTF32 a key tile at a
    time, each tile's product added to dq in fp32."""
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    rep = q.shape[2] // k.shape[2]
    S = q.shape[1]
    vt = v.repeat_interleave(rep, dim=2).permute(0, 2, 3, 1)
    dot = do.transpose(1, 2)
    tile = DQ_KEY_TILE[FA.flash_plan(torch.float32, q.shape[-1])[1]]
    row0 = torch.arange(S)[:, None] // 16 * 16      # a warp's first row
    key0 = torch.arange(S)[None, :] // tile * tile  # a key tile's first key
    cut = (key0 + tile > S) | (causal & (key0 + tile - 1 > row0))
    dp = torch.where(cut, torch.matmul(dot, vt), mm3(dot, vt))
    ds = p * (dp - delta[..., None]) * scale
    kr = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    dq = torch.zeros_like(q.transpose(1, 2))
    for k0 in range(0, S, tile):
        dq = dq + mm3(ds[..., k0:k0 + tile], kr[:, :, k0:k0 + tile])
    return dq.transpose(1, 2)


def worst_row(got, ref) -> float:
    got, ref = (np.asarray(t, dtype=np.float64) for t in (got, ref))
    err = np.abs(got - ref).max(axis=-1)
    mag = np.abs(ref).max(axis=-1)
    floor = FLOOR_SHARE * np.median(mag)
    return float((err / np.maximum(mag, floor)).max())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10            # a TF32 value: kept
    below = 1.0 + 2.0 ** -11 - 2.0 ** -23   # under half an ulp: down
    tie = 1.0 + 2.0 ** -11            # a tie: away from zero
    x = torch.tensor([one, below, tie, -tie, 0.0], dtype=torch.float32)
    np.testing.assert_array_equal(
        tf32(x).numpy(), np.array([one, 1.0, one, -one, 0.0], np.float32))
    hi, lo = split(torch.tensor([math.pi], dtype=torch.float32))
    assert (hi.view(torch.int32) & 0x1FFF).item() == 0
    assert (lo.view(torch.int32) & 0x1FFF).item() == 0
    # |lo| <= half an ulp of hi (2^-11 of it), read to 11 bits of its own
    assert abs((hi + lo).item() - math.pi) <= 2.0 ** -21 * math.pi


CASES = [
    pytest.param(D, kv, causal,
                 id=f"D{D}-kv{kv}-{'causal' if causal else 'full'}")
    for D in (16, 64, 128, 256)
    for kv, causal in ((2, True), (4, False))
]


def _inputs(seed, D, kv):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, S, heads, D).astype(np.float32)
                 for heads in (H, kv, kv, H))


@pytest.mark.parametrize("D,kv,causal", CASES)
def test_3xtf32_forward_holds_fp32_and_pallas(D, kv, causal):
    """o and lse from 3xTF32 products against the fp32 plain version and
    the Pallas forward (interpret mode, fp32): worst row within 1e-5."""
    q, k, v, _ = _inputs(D + kv, D, kv)
    sc = 1.0 / math.sqrt(D)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o3, lse3 = forward_3xtf32(tq, tk, tv, sc, causal)
    ro, rlse = FA.flash_forward_reference(tq, tk, tv, sc, causal)
    jo, jlse = JFA._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=sc,
        causal=causal, block_q=128, block_k=128, interpret=True)
    assert worst_row(o3, ro) <= ROW_TOL
    assert worst_row(o3, np.asarray(jo)) <= ROW_TOL
    np.testing.assert_allclose(lse3.numpy(), rlse.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse3.numpy(),
                               np.asarray(jlse).reshape(B, H, S),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("D,kv,causal", CASES)
def test_3xtf32_dkv_holds_fp32_and_pallas(D, kv, causal):
    """dK and dV from 3xTF32 products against the fp32 plain version and
    the Pallas backward (interpret mode), on the Pallas forward's o and
    lse: worst row within 1e-5."""
    q, k, v, do = _inputs(2 * D + kv, D, kv)
    sc = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = JFA._flash_forward(jq, jk, jv, scale=sc, causal=causal,
                                  block_q=128, block_k=128, interpret=True)
    _, jdk, jdv = JFA._flash_backward(
        jq, jk, jv, jo, jlse, jdo, scale=sc, causal=causal, block_q=128,
        block_k=128, interpret=True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    lse = torch.from_numpy(np.asarray(jlse).reshape(B, H, S))
    delta = FA.flash_delta(torch.from_numpy(np.asarray(jo)), tdo)
    dk3, dv3 = dkv_3xtf32(tq, tk, tv, tdo, lse, delta, sc, causal)
    rdk, rdv = FA.flash_backward_dkv_reference(tq, tk, tv, tdo, lse, delta,
                                               sc, causal)
    for name, got, ref, jref in (("dk", dk3, rdk, jdk), ("dv", dv3, rdv, jdv)):
        assert worst_row(got, ref) <= ROW_TOL, name
        assert worst_row(got, np.asarray(jref)) <= ROW_TOL, name


@pytest.mark.parametrize("D,kv,causal", CASES)
def test_3xtf32_dq_holds_fp32_and_pallas(D, kv, causal):
    """dQ as the kernel computes it (:func:`dq_3xtf32`) against the fp32
    plain version and the Pallas backward (interpret mode), on the Pallas
    forward's o and lse: worst row within 1e-5."""
    q, k, v, do = _inputs(3 * D + kv, D, kv)
    sc = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = JFA._flash_forward(jq, jk, jv, scale=sc, causal=causal,
                                  block_q=128, block_k=128, interpret=True)
    jdq, _, _ = JFA._flash_backward(
        jq, jk, jv, jo, jlse, jdo, scale=sc, causal=causal, block_q=128,
        block_k=128, interpret=True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    lse = torch.from_numpy(np.asarray(jlse).reshape(B, H, S))
    delta = FA.flash_delta(torch.from_numpy(np.asarray(jo)), tdo)
    rdq = FA.flash_backward_dq_reference(tq, tk, tv, tdo, lse, delta, sc,
                                         causal)
    assert worst_row(dq_3xtf32(tq, tk, tv, tdo, lse, delta, sc, causal),
                     rdq) <= ROW_TOL
    # The Pallas backward takes delta = rowsum(dO O) in its own sum order.
    jdelta = torch.from_numpy(np.asarray(jnp.sum(
        jdo * jo, axis=-1)).transpose(0, 2, 1).copy())
    assert worst_row(dq_3xtf32(tq, tk, tv, tdo, lse, jdelta, sc, causal),
                     np.asarray(jdq)) <= ROW_TOL


def test_3xtf32_is_far_closer_than_one_tf32_product():
    """The bar is not met by a single TF32 product (what ``allow_tf32``
    would give): the split is what makes the route fp32-accurate."""
    q, k, v, _ = _inputs(7, 128, 4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    sc = 1.0 / math.sqrt(128)
    ro, _ = FA.flash_forward_reference(tq, tk, tv, sc, True)
    s = FA._mask(torch.matmul(tf32(tq.transpose(1, 2)),
                              tf32(tk.permute(0, 2, 3, 1))) * sc, True)
    p = torch.softmax(s, dim=-1)
    o1 = torch.matmul(tf32(p), tf32(tv.transpose(1, 2))).transpose(1, 2)
    o3, _ = forward_3xtf32(tq, tk, tv, sc, True)
    assert worst_row(o1, ro) > 30 * ROW_TOL
    assert worst_row(o3, ro) < ROW_TOL / 2


def _kernel_body(src: str, name: str) -> str:
    """The text of kernel ``name``'s definition up to the next top-level
    definition."""
    start = src.index(f"{name}(")
    end = src.find("\ntemplate <", start)
    return src[start:end if end > 0 else len(src)]


def test_forward_and_dkv_sources_are_tensor_core_kernels():
    """flash_simple_fwd, flash_simple_dq and flash_simple_dkv multiply on
    the tensor cores (mma.sync: TF32 operands split into hi, rounded to
    nearest as tf32() rounds, and lo for fp32; bf16 operands through
    ldmatrix) on tiles that asynchronous copies fill; bf16's forward and
    dQ at head dim 256 are wgmma kernels on TMA-fed tiles; the CUDA-core
    helpers the old dQ kernel used are gone, and every entry point stays
    exported under its name."""
    src = (_build.SRC_DIR / "flash_simple.cu").read_text()
    for needle in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                   "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "(__float_as_uint(x) + 0x1000u) & 0xffffe000u",
                   "ldmatrix.sync.aligned.m8n8.x4.trans",
                   "cp.async.cg.shared.global", "cp.async.wait_group",
                   "bar.arrive", '#include "hopper_common.cuh"'):
        assert needle in src, needle
    for kernel in ("flash_simple_fwd_kernel", "flash_simple_dq_kernel",
                   "flash_simple_dkv_kernel"):
        body = _kernel_body(src, kernel)
        for call in ("mma_nt<", "mma_nn<", "async_tile<", "cp_async_wait<0>"):
            assert call in body, (kernel, call)
        assert "fmaf(av" not in body and "accumulate<" not in body, kernel
    for helper in ("load_tile", "store_scores", "acc_col", "store_acc",
                   "smem_bytes", "kLdP", "struct Tile"):
        assert not re.search(rf"\b{helper}\b", src), helper
    for ns, needles in (
            ("wg256", ("wgmma_m64n64k16_ss", "wgmma_m64n128k16_rs_tb")),
            ("wgdq", ("wgmma_m64n32k16_ss", "wgmma_m64n128k16_rs_tb"))):
        wg = src[src.index(f"namespace {ns} {{"):
                 src.index(f"}}  // namespace {ns}")]
        for needle in needles + ("tma_load_4d", "reg_alloc<", "mbar_wait",
                                 "__grid_constant__ CUtensorMap"):
            assert needle in wg, (ns, needle)
    assert "wgdq::launch<" in _kernel_body(src, "launch_dq")
    assert "atomicAdd" not in src
    c_block = src[src.index('extern "C"'):]
    for fn in ("flash_simple_fwd", "flash_simple_dq", "flash_simple_dkv"):
        assert fn in FA._SIGNATURES["flash_simple"]
        assert re.search(rf"\b{fn}\s*\(", c_block), fn
    assert FA.SIMPLE_HEAD_DIMS == (32, 64, 128, 256)
