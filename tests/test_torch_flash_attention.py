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
from pathlib import Path

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


def _qkv(seed, kv, s=S):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, s, H, D).astype(np.float32)
    k = rng.randn(B, s, kv, D).astype(np.float32)
    v = rng.randn(B, s, kv, D).astype(np.float32)
    do = rng.randn(B, s, H, D).astype(np.float32)
    return q, k, v, do


def _jax_fwd(q, k, v, causal, block=128):
    s = q.shape[1]
    o, lse = JFA._flash_forward(*map(jnp.asarray, (q, k, v)), scale=SCALE,
                                causal=causal, block_q=block, block_k=block,
                                interpret=True)
    return np.array(o), np.array(lse).reshape(B, H, s)


# S = 192 is a multiple of 64 but not of 128: `supported` takes it, and
# flash_fwd's 128-row tiles then end half full (the JAX side runs it at
# 64-row blocks).
@pytest.mark.parametrize("kv,causal,s", [
    pytest.param(4, True, S, id="4-True"),
    pytest.param(4, False, S, id="4-False"),
    pytest.param(2, True, S, id="2-True"),
    pytest.param(2, False, S, id="2-False"),
    pytest.param(2, True, 192, id="2-True-S192"),
    pytest.param(4, False, 192, id="4-False-S192"),
])
def test_forward_reference_matches_pallas(kv, causal, s):
    q, k, v, _ = _qkv(0, kv, s)
    jo, jlse = _jax_fwd(q, k, v, causal, block=128 if s % 128 == 0 else 64)
    assert FA.supported((B, s, H, D), torch.bfloat16, kv)
    to, tlse = FA.flash_forward(*map(torch.from_numpy, (q, k, v)), SCALE,
                                causal)
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (B, H, s)
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


# fp32, a head dim of 96 or 320, an S no multiple of 64, fp16, a kv head
# count that does not divide H: the flash kernels take fp32 and bf16 at
# any head dim up to 256 and any S, as the JAX package's `supported` takes
# any dtype up to 256.
@pytest.mark.parametrize("shape,dtype,kv,ok", [
    ((1, 4096, 32, 128), torch.bfloat16, 32, True),
    ((2, 2048, 32, 128), torch.bfloat16, 8, True),
    ((2, 1024, 16, 64), torch.bfloat16, None, True),
    ((1, 4096, 32, 128), torch.float32, 32, True),
    ((1, 4096, 32, 96), torch.bfloat16, 32, True),
    ((1, 4000, 32, 128), torch.bfloat16, 32, True),
    ((1, 4096, 32, 128), torch.bfloat16, 12, False),
    ((2, 100, 4, 16), torch.float32, 2, True),
    ((1, 1, 1, 256), torch.bfloat16, 1, True),
    ((1, 128, 4, 320), torch.float32, 4, False),
    ((1, 128, 4, 64), torch.float16, 4, False),
    ((1, 128, 4, 64), torch.bfloat16, 3, False),
])
def test_supported_gates_the_kernels(shape, dtype, kv, ok):
    assert FA.supported(shape, dtype, kv) is ok
    assert FA.default_blocks(shape[1]) == (FA.FLASH_BLOCK, FA.FLASH_BLOCK)


@pytest.mark.parametrize("edit,match", [
    (dict(D=320), "head dim 1 to 256"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(KV=3), "kv heads dividing"),
    (dict(misaligned=True), "16-byte aligned"),
])
def test_kernel_input_checks_refuse(edit, match):
    """What the CUDA kernels do not take raises before any launch (checked
    on CPU tensors; the wrappers run it for CUDA tensors): a head dim past
    256, a dtype other than fp32 and bf16, kv heads not dividing q heads,
    a view that does not start 16-byte aligned."""
    kw = dict(S=128, D=64, dtype=torch.bfloat16, KV=2, misaligned=False)
    kw.update(edit)
    q = torch.zeros(1, kw["S"], 4, kw["D"], dtype=kw["dtype"])
    if kw["misaligned"]:
        q = torch.zeros(q.numel() + 1, dtype=kw["dtype"])[1:].view(q.shape)
    k = torch.zeros(1, kw["S"], kw["KV"], kw["D"], dtype=kw["dtype"])
    with pytest.raises(ValueError, match=match):
        FA._check_flash_kernel_inputs(q, k, k)


@pytest.mark.parametrize("edit", [
    dict(dtype=torch.float32), dict(D=96), dict(S=100), dict(D=256),
    dict(D=16, dtype=torch.float32, S=1)])
def test_kernel_input_checks_accept_the_new_domain(edit):
    """fp32, a bf16 head dim of 96 (padded to 128), an S no multiple of 64,
    a head dim of 256: what the checks once refused the kernels now take."""
    kw = dict(S=128, D=64, dtype=torch.bfloat16)
    kw.update(edit)
    q = torch.zeros(1, kw["S"], 4, kw["D"], dtype=kw["dtype"])
    k = torch.zeros(1, kw["S"], 2, kw["D"], dtype=kw["dtype"])
    FA._check_flash_kernel_inputs(q, k, k, q)


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
              FA.flash_backward_dkv.launches, dict(FA.KERNEL_LAUNCHES))
    q, k, v, _ = _qkv(4, 2)
    tq, tk, tv = (torch.from_numpy(x[:, :64]).requires_grad_()
                  for x in (q, k, v))
    FA.flash_attention(tq, tk, tv).sum().backward()
    FA.flash_attention(tq, tk, tv, plain=True).sum().backward()
    assert (FA.flash_forward.launches, FA.flash_backward_dq.launches,
            FA.flash_backward_dkv.launches, dict(FA.KERNEL_LAUNCHES)) == before


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
    replaces and includes the shared numerics header, which holds the
    Pallas kernels' mask value and the helpers both kernels use."""
    for lib in ("flash_fwd", "flash_bwd", "flash_simple"):
        sigs = FA._SIGNATURES[lib]
        src = (_build.SRC_DIR / f"{lib}.cu").read_text()
        c_block = src[src.index('extern "C"'):]
        for fn in sigs:
            assert re.search(rf"\b{fn}\s*\(", c_block), (lib, fn)
        assert "Replaces" in src and "horovod_tpu/ops/flash_attention.py" \
            in src, lib
        assert '#include "flash_common.cuh"' in src, lib
    common = (_build.SRC_DIR / "flash_common.cuh").read_text()
    for needle in ("kNegInf = -1e30f", "ex2.approx", "pack_bf16",
                   "quad_sum", "allow_smem"):
        assert needle in common, needle


def test_forward_source_is_a_hopper_kernel():
    """flash_fwd is built from wgmma products on TMA-loaded tiles, with its
    tensor maps passed as __grid_constant__ kernel parameters, and
    warp-specialised (a producer warpgroup hands its registers to the
    consumers)."""
    fwd = (_build.SRC_DIR / "flash_fwd.cu").read_text()
    hop = (_build.SRC_DIR / "hopper_common.cuh").read_text()
    both = fwd + hop
    assert '#include "hopper_common.cuh"' in fwd
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "setmaxnreg",
                   "cuTensorMapEncodeTiled"):
        assert needle in both, needle
    assert len(re.findall(r"__grid_constant__\s+CUtensorMap", fwd)) == 3
    assert "mma.sync.aligned" not in fwd


def test_backward_source_is_a_hopper_kernel():
    """flash_bwd_dq and flash_bwd_dkv are built from wgmma products on
    TMA-loaded tiles, with their tensor maps passed as __grid_constant__
    kernel parameters, and warp-specialised; no mma.sync is left, and the
    kernels keep the names the profile reads."""
    bwd = (_build.SRC_DIR / "flash_bwd.cu").read_text()
    hop = (_build.SRC_DIR / "hopper_common.cuh").read_text()
    both = bwd + hop
    assert '#include "hopper_common.cuh"' in bwd
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "setmaxnreg",
                   "cuTensorMapEncodeTiled"):
        assert needle in both, needle
    # q, k, v and dO maps for each of the two kernels
    assert len(re.findall(r"__grid_constant__\s+CUtensorMap", bwd)) == 8
    assert "mma.sync" not in bwd and "atomicAdd" not in bwd
    for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        assert re.search(rf"\b{name}\s*\(", bwd), name


@pytest.mark.parametrize("lib", ["flash_fwd", "flash_bwd", "flash_simple"])
def test_build_hash_covers_the_hopper_header(tmp_path, monkeypatch, lib):
    """Editing csrc/hopper_common.cuh rebuilds each flash library: its
    name carries a hash of every csrc/*.cuh."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.SRC_DIR.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setenv("HOROVOD_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    before = _build._target(lib)[1]
    hdr = src / "hopper_common.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _build._target(lib)[1] != before


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_needs_a_card(monkeypatch, capsys):
    """chip_smoke.py runs only on the card: without one it exits 2 and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _chip_smoke().main(["--phases", "device"]) == 2
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the port's package exits
    non-zero and prints no result: it drives the checkout's own package,
    never an installed one."""
    import shutil
    import subprocess
    import sys
    shutil.copy(Path(__file__).resolve().parent.parent / "chip_smoke.py",
                tmp_path)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert p.returncode != 0
    assert p.stdout == ""
