"""Port parity: the paged decode attention of ``horovod_tpu_torch``.

The same inputs, drawn with numpy from a seed, go through the JAX
package's Pallas kernel (``interpret=True``, as its own tests run it on the
CPU) and through the port's wrapper on CPU tensors, which runs the
kernel's plain PyTorch version.  The CUDA kernel itself runs only on the
card; ``chip_smoke.py`` holds it against the plain version there.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as JFA
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.serving.kv_pager import gather_blocks


def _case(seed, B, H, KV, Dh, NB, BS, n_cols, lengths):
    """q, pools, tables (each row's live pages drawn without replacement
    from blocks 1.., padded columns at scratch block 0), lengths."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Dh).astype(np.float32)
    kp = rng.randn(NB, BS, KV, Dh).astype(np.float32)
    vp = rng.randn(NB, BS, KV, Dh).astype(np.float32)
    pages = [-(-n // BS) for n in lengths]
    ids = rng.choice(np.arange(1, NB), size=sum(pages), replace=False)
    tables = np.zeros((B, n_cols), np.int32)
    at = 0
    for b, n in enumerate(pages):
        tables[b, :n] = ids[at:at + n]
        at += n
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("n_cols", [4, 6])
def test_paged_attention_matches_pallas(rep, n_cols):
    """rep query heads per kv head; partial last pages (5, 17, 30 of
    8-token pages) and padded columns (n_cols beyond the live pages)."""
    KV, Dh, BS = 2, 64, 8
    lengths = [5, 17, 30]
    q, kp, vp, tables, lens = _case(rep, 3, KV * rep, KV, Dh, 16, BS,
                                    n_cols, lengths)
    ref = np.asarray(JFA.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True))
    launches = FA.paged_attention.launches
    out = FA.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(tables),
                             torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert FA.paged_attention.launches == launches, \
        "CPU tensors run the plain version and launch nothing"


def test_paged_reference_matches_gather_path():
    """The plain version equals the engine's gather path (contiguous
    gather + grouped masked attention) on the same pool."""
    q, kp, vp, tables, lens = _case(7, 3, 8, 2, 32, 16, 8, 4, [1, 9, 32])
    tq, tk, tv = map(torch.from_numpy, (q, kp, vp))
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    out = FA.paged_attention_reference(tq, tk, tv, tt, tl)
    keys, vals = gather_blocks(tk, tt), gather_blocks(tv, tt)
    mask = (torch.arange(keys.shape[1])[None, :] < tl[:, None])[:, None, :]
    ref = tllama._cached_attend(tq[:, None], keys, vals, mask,
                                1.0 / np.sqrt(32))[:, 0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_paged_attention_bf16_cpu_rounds_once():
    """bf16 inputs: the plain version computes in fp32 and rounds the
    output once; the JAX kernel rounds p to bf16 before P.V, so the two
    agree to bf16 resolution."""
    q, kp, vp, tables, lens = _case(3, 2, 4, 2, 64, 12, 8, 4, [11, 32])
    b16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    out = FA.paged_attention(b16(q), b16(kp), b16(vp),
                             torch.from_numpy(tables), torch.from_numpy(lens))
    assert out.dtype == torch.bfloat16
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = np.asarray(JFA.paged_attention(
        j16(q), j16(kp), j16(vp), jnp.asarray(tables), jnp.asarray(lens),
        interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


def test_paged_attention_validates_shapes():
    q, kp, vp, tables, lens = map(torch.from_numpy, _case(
        0, 2, 6, 4, 16, 8, 8, 2, [3, 9]))
    with pytest.raises(ValueError, match="must divide"):
        FA.paged_attention(q, kp, vp, tables, lens)
    with pytest.raises(ValueError, match="lengths"):
        FA.paged_attention(q[:, :4], kp, vp, tables, lens[:1])


def _kernel_case(dtype=torch.bfloat16, BS=8, Dh=64, offset=0):
    """CPU tensors shaped as a kernel launch; ``offset`` elements shift
    both pools off their allocation's start."""
    q, kp, vp, tables, lens = _case(5, 2, 4, 2, Dh, 8, BS, 4, [3, 9])

    def pool(a):
        flat = torch.zeros(a.size + offset, dtype=dtype)
        flat[offset:] = torch.from_numpy(a).reshape(-1).to(dtype)
        return flat[offset:].view(a.shape)

    return (torch.from_numpy(q).to(dtype), pool(kp), pool(vp),
            torch.from_numpy(tables), torch.from_numpy(lens))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_input_checks_accept_the_served_layout(dtype):
    FA._check_kernel_inputs(*_kernel_case(dtype))


@pytest.mark.parametrize("kw,edit,match", [
    (dict(dtype=torch.float16), None, "float32 or bfloat16"),
    (dict(BS=4), None, "block_size % 8"),
    (dict(Dh=4), None, "16-byte pieces"),
    (dict(offset=1), None, "16-byte aligned"),
    ({}, lambda a: (a[0], a[1], a[2].float(), a[3], a[4]), "one dtype"),
    ({}, lambda a: (a[0], a[1], a[2], a[3].long(), a[4]), "int32"),
    ({}, lambda a: (a[0], a[1].transpose(0, 1).contiguous().transpose(0, 1),
                    a[2], a[3], a[4]), "contiguous"),
])
def test_kernel_input_checks_refuse(kw, edit, match):
    """What the CUDA kernel does not take raises before any launch: the
    wrapper runs these checks for every CUDA tensor."""
    args = _kernel_case(**kw)
    if edit is not None:
        args = edit(args)
    with pytest.raises(ValueError, match=re.escape(match)):
        FA._check_kernel_inputs(*args)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_gqa_expand_matches_jax(H, KV):
    rng = np.random.RandomState(H + KV)
    q = rng.randn(2, 5, H, 8).astype(np.float32)
    k = rng.randn(2, 5, KV, 8).astype(np.float32)
    v = rng.randn(2, 5, KV, 8).astype(np.float32)
    tk, tv = FA.gqa_expand(*map(torch.from_numpy, (q, k, v)))
    jk, jv = JFA.gqa_expand(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="divide"):
        FA.gqa_expand(torch.from_numpy(q[:, :, :3]), torch.from_numpy(k),
                      torch.from_numpy(v))


@pytest.mark.parametrize("bs,dh,ok", [(16, 128, True), (8, 256, True),
                                      (4, 64, False), (16, 512, False)])
def test_paged_supported_matches_jax(bs, dh, ok):
    assert FA.paged_supported(bs, dh) == JFA.paged_supported(bs, dh) == ok


def test_paged_bytes_counts_live_pages_once():
    pool = torch.zeros(10, 16, 4, 8, dtype=torch.bfloat16)
    # 1 + 2 + 4 live pages (lengths 1, 17, 64), the last capped at n_cols.
    assert FA.paged_bytes(pool, [1, 17, 80], n_cols=4) == \
        2 * 7 * 16 * 4 * 8 * 2


def test_kernel_source_exports_bound_symbols():
    """The ctypes signatures name functions the CUDA source exports with
    C linkage, and the build targets sm_90a."""
    src = (_build.SRC_DIR / "paged_decode.cu").read_text()
    c_block = src[src.index('extern "C"'):]
    for fn in FA._SIGNATURES["paged_decode"]:
        assert re.search(rf"\b{fn}\s*\(", c_block), fn
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_target_tracks_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_TORCH_BUILD_DIR", str(tmp_path))
    _, so = _build._target("paged_decode")
    assert so.parent == tmp_path and so.name.startswith("paged_decode-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("paged_decode")[1] != so
    with pytest.raises(FileNotFoundError):
        _build._target("no_such_kernel")
    assert Path(_build.SRC_DIR).name == "csrc"


# ---------------------------------------------------------------------------
# The kernel's split over table columns, in plain PyTorch
# ---------------------------------------------------------------------------

# Rows of 1, 9 and 50 tokens in 8-token pages: 1, 2 and 7 live columns of 8.
# With 7 splits (2 columns each) the first row's splits 1-6 and the second
# row's splits 1-6 hold no live column, and both rows have fewer live
# columns than splits.
_SPLIT_LENGTHS = [1, 9, 50]


def _split_case(rep, dtype):
    KV, Dh, BS = 2, 16, 8
    q, kp, vp, tables, lens = _case(11 + rep, 3, KV * rep, KV, Dh, 24, BS, 8,
                                    _SPLIT_LENGTHS)
    return q, kp, vp, tables, lens, (
        torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
        torch.from_numpy(vp).to(dtype), torch.from_numpy(tables),
        torch.from_numpy(lens))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
def test_split_reference_matches_reference_and_pallas(n_splits, rep, dtype):
    """Each split's (acc, m, l) over its columns, merged by log-sum-exp,
    equals the unsplit plain version and the Pallas kernel.  fp32: 1e-5
    (sums in another order).  bf16: the split version rounds p to bf16
    before P.V, as the kernel and the Pallas kernel do, against its own
    split's max; the unsplit plain version keeps p in fp32, so the two
    differ by bf16 roundings of values of order 1 (atol 2e-2, as
    ``test_paged_attention_bf16_cpu_rounds_once``)."""
    q, kp, vp, tables, lens, args = _split_case(rep, dtype)
    out = FA.paged_attention_split_reference(*args, n_splits)
    ref = FA.paged_attention_reference(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               **tol)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jout = np.asarray(JFA.paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True
    ).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), jout, **tol)


@pytest.mark.parametrize("n_splits", [2, 7])
def test_split_partials_of_empty_splits(n_splits):
    """A split that holds no live column gives m = -1e30, l = 0, acc = 0;
    the others hold the row's live tokens between them."""
    *_, args = _split_case(1, torch.float32)
    acc, m, l = FA.paged_split_partials(*args, n_splits)
    B, H, Dh = args[0].shape
    assert acc.shape == (B, H, n_splits, Dh) and m.shape == l.shape == \
        (B, H, n_splits)
    cps = -(-8 // n_splits)
    for b, n in enumerate(_SPLIT_LENGTHS):
        live_cols = -(-n // 8)
        for s in range(n_splits):
            if s * cps >= live_cols:
                assert (m[b, :, s] == -1e30).all() and (l[b, :, s] == 0).all()
                assert (acc[b, :, s] == 0).all()
            else:
                assert (l[b, :, s] >= 1).all()  # exp(max - max) = 1


def test_split_reference_of_one_token_rows_is_v():
    """A row of length 1 attends to its first token alone: the output is
    that token's V for every split count."""
    *_, args = _split_case(4, torch.float32)
    q, kp, vp, tables, lens = args
    first_v = vp[tables[0, 0].long(), 0]                  # [KV, Dh]
    for n_splits in (1, 2, 7):
        out = FA.paged_attention_split_reference(*args, n_splits)[0]
        np.testing.assert_allclose(
            out.numpy(), first_v.repeat_interleave(4, dim=0).numpy(),
            rtol=1e-6, atol=1e-6)


def test_split_reference_rejects_bad_split_counts():
    *_, args = _split_case(1, torch.float32)
    for n in (0, 9):
        with pytest.raises(ValueError, match="n_splits"):
            FA.paged_split_partials(*args, n)


@pytest.mark.parametrize("B,KV,n_cols,sm", [
    (8, 32, 128, 132), (8, 8, 128, 132), (1, 8, 256, 132), (8, 32, 64, 132),
    (1, 1, 3, 132), (2, 4, 1, 132), (40, 8, 64, 132), (64, 8, 128, 132),
    (3, 2, 1000, 114),
])
def test_paged_splits_policy(B, KV, n_cols, sm):
    """At least 1 split and at most n_cols (a page a split at least); the
    grid reaches about 2 CTAs an SM where the columns allow; 1 split when
    B * KV already fills the card."""
    n = FA.paged_splits(B, KV, n_cols, sm)
    assert 1 <= n <= n_cols
    target = FA.PAGED_CTAS_PER_SM * sm
    if B * KV >= target:
        assert n == 1
    elif n < n_cols:
        assert B * KV * n >= target
        assert B * KV * (n - 1) < target       # no more splits than needed
    assert FA.PAGED_CTAS_PER_SM >= 2


def _c_params(src: str, fn: str) -> list:
    """ctypes types of the parameters of C function ``fn`` in ``src``'s
    extern "C" block: pointers, ints and floats."""
    block = src[src.index('extern "C"'):]
    m = re.search(rf"\b{fn}\s*\(([^)]*)\)", block)
    kinds = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        if "*" in p:
            kinds.append(ctypes.c_void_p)
        elif p.startswith("int "):
            kinds.append(ctypes.c_int)
        elif p.startswith("float "):
            kinds.append(ctypes.c_float)
        else:
            raise AssertionError(f"{fn}: unexpected parameter {p!r}")
    return kinds


@pytest.mark.parametrize("lib", ["paged_decode", "flash_fwd", "flash_bwd"])
def test_c_entry_points_match_signatures(lib):
    """Every C entry point's parameters (pointers, ints, floats, in order)
    are the ctypes argtypes the wrapper binds: a scratch pointer or a size
    added on one side only would shift every later argument."""
    src = (_build.SRC_DIR / f"{lib}.cu").read_text()
    for fn, (restype, argtypes) in FA._SIGNATURES[lib].items():
        if fn.endswith("_error_string"):
            continue
        assert restype is ctypes.c_int
        assert _c_params(src, fn) == list(argtypes), fn



def test_paged_scratch_is_reused_and_grown():
    """One scratch buffer for each (device, stream): a launch that needs no
    more than the buffer holds reuses it (no allocation in a decode tick),
    one that needs more replaces it, and another stream gets its own."""
    dev = torch.device("cpu")
    FA._PAGED_SCRATCH.clear()
    try:
        a = FA._paged_scratch(dev, 1, 100)
        assert a.dtype == torch.float32 and a.numel() == 100
        assert FA._paged_scratch(dev, 1, 60) is a
        b = FA._paged_scratch(dev, 1, 200)
        assert b.numel() == 200 and FA._paged_scratch(dev, 1, 100) is b
        assert FA._paged_scratch(dev, 2, 10) is not b
    finally:
        FA._PAGED_SCRATCH.clear()


def test_kernel_keeps_the_table_in_smem_only_where_the_host_made_room():
    """The kernel copies a split's table columns to shared memory under the
    same test on which the host reserves the room, ``cps <= kTableSmem``,
    never on a request's own live columns: with one split of more than
    kTableSmem columns a short request would write past the reservation."""
    src = (_build.SRC_DIR / "paged_decode.cu").read_text()
    tests = re.findall(r"(\S+)\s*<=\s*kTableSmem", src)
    assert [t.strip("()") for t in tests] == ["cps", "cps"], tests
    assert src.count("const int cps = (n_cols + n_splits - 1) / n_splits;") == 2
