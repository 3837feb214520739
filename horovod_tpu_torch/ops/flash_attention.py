"""Attention kernels of the port: paged decode attention.

:func:`paged_attention` is the decode-step attention of the serving engine
over a block-paged KV pool.  For CUDA tensors it launches the hand-written
kernel in ``csrc/paged_decode.cu`` (built with ``nvcc`` for ``sm_90a`` at
first use, bound with ctypes); for CPU tensors it runs the plain PyTorch
version :func:`paged_attention_reference`.  There is no fallback between
the two: a CUDA tensor goes through the kernel or the call raises.

The kernel replaces the Pallas TPU kernel ``_paged_decode_kernel`` of
``horovod_tpu/ops/flash_attention.py`` (the ``pl.pallas_call`` in
``paged_attention`` there).  It is memory-bound: a launch reads
``sum_b ceil(len_b / BS) * BS * KV * Dh`` elements of K and as many of V,
once each; :func:`paged_bytes` counts them.  The flash-attention forward
and backward kernels wait for the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30

# torch dtype -> the kernel's dtype code (csrc/paged_decode.cu).
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = {
    "paged_decode": (ctypes.c_int, [ctypes.c_void_p] * 6
                     + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "paged_decode_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def gqa_expand(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Repeat grouped K/V ``[B, S, KV, D]`` up to q's head count ``H``
    (for attention paths without native GQA indexing; the kernels index kv
    heads directly and never pay this expansion)."""
    H, KV = q.shape[2], k.shape[2]
    if KV != H:
        if H % KV:
            raise ValueError(f"kv heads {KV} must divide q heads {H}")
        rep = H // KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def paged_supported(block_size: int, head_dim: int) -> bool:
    """Pool geometries the paged decode kernel takes: pages a multiple of
    8 tokens and a head dim of at most 256."""
    return block_size % 8 == 0 and head_dim <= 256


def paged_bytes(k_pool: torch.Tensor, lengths, n_cols: int) -> int:
    """Bytes of K and V pages one :func:`paged_attention` launch must read
    for these lengths (each live page once), the kernel's memory bound."""
    _, BS, KV, Dh = k_pool.shape
    pages = sum(min(-(-int(n) // BS), n_cols) for n in lengths)
    return 2 * pages * BS * KV * Dh * k_pool.element_size()


def _check(q, k_pool, v_pool, tables, lengths):
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"want q [B, H, Dh] and pools [NB, BS, KV, Dh]; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, H, Dh = q.shape
    _, _, KV, Dh2 = k_pool.shape
    if Dh2 != Dh:
        raise ValueError(f"head dim {Dh} of q != {Dh2} of the pool")
    if H % KV:
        raise ValueError(f"kv heads {KV} must divide q heads {H}")
    if tables.dim() != 2 or tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(
            f"want tables [B, n_cols] and lengths [B] for B={B}; got "
            f"{tuple(tables.shape)}, {tuple(lengths.shape)}")


def _check_kernel_inputs(q, k_pool, v_pool, tables, lengths) -> None:
    """Raise ``ValueError`` for inputs the CUDA kernel does not take: a
    pool geometry outside :func:`paged_supported`, a dtype other than
    float32/bfloat16 shared by q and the pools, non-int32 tables or
    lengths, tensors on other devices or not contiguous, a K/V row that is
    not a whole number of 16-byte copies, or a pool not 16-byte aligned."""
    _, BS, _, Dh = k_pool.shape
    if not paged_supported(BS, Dh):
        raise ValueError(
            f"paged decode kernel needs block_size % 8 == 0 and head_dim "
            f"<= 256; got block_size={BS}, head_dim={Dh}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(
            f"paged decode kernel takes float32 or bfloat16 with one dtype "
            f"for q and the pools; got {q.dtype}, {k_pool.dtype}, "
            f"{v_pool.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Dh * q.element_size() % 16:
        raise ValueError(
            f"paged decode kernel copies K/V rows in 16-byte pieces; a row "
            f"of head_dim={Dh} {q.dtype} is {Dh * q.element_size()} bytes")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")


def paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`paged_attention`: gather each
    row's pages into ``[B, n_cols * BS, KV, Dh]``, a masked softmax in
    fp32, and the product with V in fp32.  Returns ``[B, H, Dh]`` in q's
    dtype."""
    _check(q, k_pool, v_pool, tables, lengths)
    B, H, Dh = q.shape
    _, BS, KV, _ = k_pool.shape
    rep = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    tables = tables.long()
    T = tables.shape[1] * BS
    keys = k_pool[tables].reshape(B, T, KV, Dh).float()
    vals = v_pool[tables].reshape(B, T, KV, Dh).float()
    qg = q.float().reshape(B, KV, rep, Dh)
    s = torch.einsum("bgrd,btgd->bgrt", qg, keys) * scale
    live = (torch.arange(T, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                      # [B, T]
    s = torch.where(live[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrt,btgd->bgrd", p, vals)
    return o.reshape(B, H, Dh).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Decode-step attention over a block-paged KV pool, GQA-native.

    q ``[B, H, Dh]`` (one token per request); k_pool/v_pool
    ``[num_blocks, block_size, KV, Dh]``; tables ``[B, n_cols]`` int32
    physical block ids (rows padded with the scratch block 0); lengths
    ``[B]`` int32, each at least 1 — logical positions ``< lengths[b]``
    are live, the rest masked.  Returns ``[B, H, Dh]``.

    A length of 0 is outside the contract: the kernel returns 0 for such
    a row, the Pallas TPU kernel the mean of V.

    CPU tensors run :func:`paged_attention_reference`.  CUDA tensors
    launch the kernel on the current stream and add one to
    ``paged_attention.launches``; an unsupported geometry, dtype or
    layout raises (see :func:`_check_kernel_inputs`), as does a launch
    the runtime refuses.
    """
    _check(q, k_pool, v_pool, tables, lengths)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                                         scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_kernel_inputs(q, k_pool, v_pool, tables, lengths)
    B, H, Dh = q.shape
    _, BS, KV, _ = k_pool.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = _build.load("paged_decode", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, KV, Dh, BS, tables.shape[1], float(scale),
            _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        msg = lib.paged_decode_error_string(rc).decode()
        raise RuntimeError(f"paged_decode launch failed: {msg} ({rc})")
    paged_attention.launches += 1
    return out


#: kernel launches made through :func:`paged_attention` in this process
paged_attention.launches = 0
