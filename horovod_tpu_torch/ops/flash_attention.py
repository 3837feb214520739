"""Attention kernels of the port: flash attention (training) and paged
decode attention (serving).

Every kernel here is hand-written CUDA C++ for ``sm_90a`` under ``csrc/``,
built with ``nvcc`` at first use and bound with ctypes, and has a plain
PyTorch version beside it.  A wrapper runs the plain version for CPU
tensors; for CUDA tensors it launches the kernel or raises.  There is no
fallback between the two.

- :func:`flash_attention` is exact causal or full attention with a
  ``torch.autograd.Function`` around three kernels: ``flash_fwd``
  (``csrc/flash_fwd.cu``, replacing the Pallas ``_fwd_kernel`` of
  ``horovod_tpu/ops/flash_attention.py``), and ``flash_bwd_dq`` and
  ``flash_bwd_dkv`` (``csrc/flash_bwd.cu``, replacing ``_bwd_dq_kernel``
  and ``_bwd_dkv_kernel``).  All three are bound by tensor-core operations
  at training lengths; :func:`flash_flops` counts them.
- :func:`paged_attention` is the decode-step attention of the serving
  engine over a block-paged KV pool (``csrc/paged_decode.cu``, replacing
  ``_paged_decode_kernel``), split over table columns across CTAs
  (:func:`paged_splits`) and merged by log-sum-exp
  (:func:`paged_attention_split_reference` is the algorithm in plain
  PyTorch).  It is memory-bound: a launch reads ``sum_b ceil(len_b / BS) *
  BS * KV * Dh`` elements of K and as many of V, once each;
  :func:`paged_bytes` counts them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30

# torch dtype -> the kernel's dtype code (csrc/paged_decode.cu).
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ERR = (ctypes.c_char_p, [_I])
# library -> function -> (restype, argtypes).  A launch takes device
# pointers, then sizes, then the stream last, and returns a cudaError_t
# that <library>_error_string names.  The flash launches take their
# tensors, then B, S, H, KV, D, scale and causal.
_SIGNATURES = {
    "paged_decode": {
        "paged_decode": (_I, [_P] * 9 + [_I] * 7 + [_F, _I, _P]),
        "paged_decode_error_string": _ERR,
    },
    "flash_fwd": {
        "flash_fwd": (_I, [_P] * 5 + [_I] * 5 + [_F, _I, _P]),
        "flash_fwd_error_string": _ERR,
    },
    "flash_bwd": {
        "flash_bwd_dq": (_I, [_P] * 7 + [_I] * 5 + [_F, _I, _P]),
        "flash_bwd_dkv": (_I, [_P] * 8 + [_I] * 5 + [_F, _I, _P]),
        "flash_bwd_error_string": _ERR,
    },
}


def _launch(lib_name: str, fn: str, device: torch.device, *args,
            stream: Optional[int] = None) -> None:
    """Call ``fn`` of a kernel library with ``args`` and ``stream`` (the
    current stream of ``device`` if not given); raise if the runtime
    refuses the launch."""
    lib = _build.load(lib_name, _SIGNATURES[lib_name])
    with torch.cuda.device(device):
        if stream is None:
            stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = getattr(lib, f"{lib_name}_error_string")(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({rc})")

# ---------------------------------------------------------------------------
# flash attention: plain versions, gating, kernel wrappers, autograd
# ---------------------------------------------------------------------------

#: Head dims the flash kernels are compiled for.
FLASH_HEAD_DIMS = (64, 128)
#: Rows of a consumer warpgroup's tile and of a streamed tile in every
#: flash kernel; S must be a multiple of it.  A CTA covers 128 rows (two
#: warpgroups), so at an S that is not a multiple of 128 the last CTA's
#: second warpgroup lies past S and the kernels mask or skip it.
FLASH_BLOCK = 64


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool) -> torch.Tensor:
    """Dense attention, the test oracle: scores in the input dtype cast to
    fp32 and scaled, a masked fp32 softmax, p cast to v's dtype before the
    product with V.  q ``[B, S, H, D]``, grouped k/v ``[B, S, KV, D]``."""
    k, v = gqa_expand(q, k, v)
    s = _mask(torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale, causal)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _mask(s: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scores ``[..., S, S]`` with the keys after each query set to the
    Pallas kernels' mask value, if ``causal``."""
    if not causal:
        return s
    S = s.shape[-1]
    keep = torch.ones(S, S, dtype=torch.bool, device=s.device).tril()
    return torch.where(keep, s, _NEG_INF)


def default_blocks(seq_len: int) -> tuple[int, int]:
    """(query rows, key rows) that S must be a multiple of: the 64 rows of
    one consumer warpgroup's ``wgmma`` tile.  ``flash_fwd`` covers 128
    query rows and 128-key tiles a CTA, ``flash_bwd_dq`` 128 query rows and
    64-key tiles, ``flash_bwd_dkv`` 128 keys and 64-row query tiles; each
    masks or skips the half-full last CTA of such an S.  Fixed by the
    kernels' register and shared-memory budget, not by the TPU sweep of the
    JAX package."""
    del seq_len
    return FLASH_BLOCK, FLASH_BLOCK


def supported(q_shape: tuple, dtype: torch.dtype,
              kv_heads: Optional[int] = None) -> bool:
    """Shapes and dtypes the flash kernels take on the card: bf16, head
    dim 64 or 128, S a positive multiple of the block, and kv heads
    (default: H) dividing the q heads."""
    B, S, H, D = q_shape
    KV = H if kv_heads is None else kv_heads
    bq, bk = default_blocks(S)
    return (dtype == torch.bfloat16 and D in FLASH_HEAD_DIMS and S > 0
            and S % bq == 0 and S % bk == 0 and KV > 0 and H % KV == 0)


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"want q [B, S, H, D] and k/v [B, S, KV, D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, length or head dim")
    if H % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} must divide q heads {H}")


def _check_flash_kernel_inputs(q, k, v, *others) -> None:
    """Raise ``ValueError`` for inputs the flash kernels do not take: a
    shape or dtype outside :func:`supported`, tensors that differ in dtype
    or device, or a tensor that is not 16-byte aligned (TMA loads every
    tile, and a tensor map's base must be 16-byte aligned)."""
    if not supported(tuple(q.shape), q.dtype, k.shape[2]):
        raise ValueError(
            f"flash kernels take bf16, head dim in {FLASH_HEAD_DIMS}, S a "
            f"multiple of {FLASH_BLOCK} and kv heads dividing q heads; got "
            f"q {tuple(q.shape)} {q.dtype}, k/v {tuple(k.shape)}")
    for t in (k, v) + others:
        if t.dtype != q.dtype:
            raise ValueError(f"all of q, k, v, o, dO must be {q.dtype}; "
                             f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"a tensor is on {t.device}, q on {q.device}")
    for t in (q, k, v) + others:
        if t.data_ptr() % 16:
            raise ValueError("flash kernel inputs must start 16-byte aligned")


def _plain_scores(q, k, v, scale, causal):
    """q, and k/v repeated up to q's heads, in fp32, with the scaled,
    masked fp32 scores ``[B, H, S, S]`` of q against k."""
    _check_qkv(q, k, v)
    qf = q.float()
    kf, vf = (t.float() for t in gqa_expand(q, k, v))
    s = _mask(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, causal)
    return qf, kf, vf, s


def _plain_ds(q, k, v, do, lse, delta, scale, causal):
    """What both backward kernels recompute, in fp32: ``p = exp(s - lse)``
    and ``ds = p * (dO V^T - delta) * scale``, with q, k (repeated up to
    q's heads) and dO."""
    qf, kf, vf, s = _plain_scores(q, k, v, scale, causal)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    return qf, kf, dof, p, p * (dp - delta[..., None]) * scale


def _group_sum(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """Sum ``[B, S, H, D]`` over the ``H / KV`` q heads of each kv group."""
    B, S, H, D = x.shape
    return x.reshape(B, S, kv_heads, H // kv_heads, D).sum(dim=3)


def flash_forward_reference(q, k, v, scale: float, causal: bool
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_fwd``, in fp32: ``(o [B, S, H, D]`` in q's
    dtype, ``lse [B, H, S]`` fp32), lse the log-sum-exp of each row of
    scaled, masked scores."""
    _, _, vf, s = _plain_scores(q, k, v, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype), lse


def flash_backward_dq_reference(q, k, v, do, lse, delta, scale: float,
                                causal: bool) -> torch.Tensor:
    """Plain version of ``flash_bwd_dq``, in fp32: p from the scores and
    ``lse``, ``ds = p * (dO V^T - delta) * scale``, ``dq = ds K``.
    ``lse`` and ``delta = rowsum(dO * O)`` are fp32 ``[B, H, S]``."""
    _, kf, _, _, ds = _plain_ds(q, k, v, do, lse, delta, scale, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)


def flash_backward_dkv_reference(q, k, v, do, lse, delta, scale: float,
                                 causal: bool
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_bwd_dkv``, in fp32: ``dv = P^T dO`` and
    ``dk = dS^T Q`` per q head, summed over each kv group's q heads.
    Returns ``(dk, dv)`` ``[B, S, KV, D]`` in k's and v's dtypes."""
    qf, _, dof, p, ds = _plain_ds(q, k, v, do, lse, delta, scale, causal)
    KV = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return (_group_sum(dk, KV).to(k.dtype), _group_sum(dv, KV).to(v.dtype))


def _flash_launch(lib_name: str, fn: str, q, tensors, scale, causal):
    B, S, H, D = q.shape
    _launch(lib_name, fn, q.device, *(t.data_ptr() for t in tensors),
            B, S, H, tensors[1].shape[2], D, float(scale), int(bool(causal)))


def _on_card(name: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return True


def flash_forward(q, k, v, scale: float, causal: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention forward, ``(o, lse)`` as :func:`flash_forward_reference`
    gives them.  CPU tensors run the plain version; CUDA tensors launch
    ``flash_fwd`` on the current stream and add one to
    ``flash_forward.launches``, or raise."""
    _check_qkv(q, k, v)
    if not _on_card("flash_forward", q):
        return flash_forward_reference(q, k, v, scale, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_flash_kernel_inputs(q, k, v)
    B, S, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    _flash_launch("flash_fwd", "flash_fwd", q, (q, k, v, o, lse), scale,
                  causal)
    flash_forward.launches += 1
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta):
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    _check_flash_kernel_inputs(q, k, v, do)
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, S)
                or not t.is_contiguous() or t.device != q.device
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"fp32 [B, H, S] on {q.device}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    return q, k, v, do


def flash_backward_dq(q, k, v, do, lse, delta, scale: float, causal: bool
                      ) -> torch.Tensor:
    """dQ as :func:`flash_backward_dq_reference` gives it.  CPU tensors run
    the plain version; CUDA tensors launch ``flash_bwd_dq`` and add one to
    ``flash_backward_dq.launches``, or raise."""
    _check_qkv(q, k, v)
    if not _on_card("flash_backward_dq", q):
        return flash_backward_dq_reference(q, k, v, do, lse, delta, scale,
                                           causal)
    q, k, v, do = _bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _flash_launch("flash_bwd", "flash_bwd_dq", q,
                  (q, k, v, do, lse, delta, dq), scale, causal)
    flash_backward_dq.launches += 1
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, scale: float, causal: bool
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) as :func:`flash_backward_dkv_reference` gives them.  CPU
    tensors run the plain version; CUDA tensors launch ``flash_bwd_dkv``
    and add one to ``flash_backward_dkv.launches``, or raise."""
    _check_qkv(q, k, v)
    if not _on_card("flash_backward_dkv", q):
        return flash_backward_dkv_reference(q, k, v, do, lse, delta, scale,
                                            causal)
    q, k, v, do = _bwd_inputs(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_launch("flash_bwd", "flash_bwd_dkv", q,
                  (q, k, v, do, lse, delta, dk, dv), scale, causal)
    flash_backward_dkv.launches += 1
    return dk, dv


#: kernel launches made through each flash wrapper in this process
flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32 ``[B, H, S]``, computed outside
    the kernels as the JAX package does."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    """Flash attention with a hand-written backward.  The residuals are
    ``(q, k, v, o, lse)``, as in the JAX custom VJP; ``plain`` routes CUDA
    tensors through the plain versions (a test hook, never a fallback)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, plain):
        fwd = flash_forward_reference if plain else flash_forward
        o, lse = fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.plain = scale, causal, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = flash_delta(o, do)
        if ctx.plain:
            dq_fn, dkv_fn = (flash_backward_dq_reference,
                             flash_backward_dkv_reference)
        else:
            dq_fn, dkv_fn = flash_backward_dq, flash_backward_dkv
        dq = dq_fn(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, causal: bool = True, *,
                    plain: bool = False) -> torch.Tensor:
    """Exact attention, flash-style, differentiable.  q ``[B, S, H, D]``,
    k/v ``[B, S, KV, D]`` with ``KV`` dividing ``H`` (GQA-native: the
    kernels route q head ``h`` to kv head ``h // (H / KV)``) → ``[B, S, H,
    D]``.  ``scale`` defaults to ``1 / sqrt(D)``.

    The forward runs ``flash_fwd`` and the backward ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` on CUDA tensors (a shape or dtype outside
    :func:`supported` raises), their plain versions on CPU tensors, or,
    with ``plain=True``, the plain versions on either device."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 bool(plain))


def flash_flops(q_shape: tuple, causal: bool, products: int) -> int:
    """Tensor-core operations of a flash kernel whose inner loop runs
    ``products`` S x S x D products per head (2 forward, 3 dQ, 4 dK/dV),
    2 a multiply-add, counting only the score blocks under the causal
    diagonal that this shape needs (the kernels skip the rest)."""
    B, S, H, D = q_shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2 * products * B * H * pairs * D


def gqa_expand(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               heads: Optional[int] = None):
    """Repeat grouped K/V ``[B, S, KV, D]`` up to q's head count ``H``
    (``heads`` when given: the model's, where q holds one tensor-parallel
    rank's heads) for attention paths without native GQA indexing; the
    kernels index kv heads directly and never pay this expansion."""
    H, KV = heads or q.shape[2], k.shape[2]
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


def paged_split_partials(q, k_pool, v_pool, tables, lengths, n_splits: int,
                         scale: Optional[float] = None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What each split of the kernel writes to scratch, in plain PyTorch:
    split ``s`` covers table columns ``[s * cps, min((s + 1) * cps,
    n_live))``, ``cps = ceil(n_cols / n_splits)``, and gives its max score
    ``m``, its sum ``l = sum exp(score - m)`` and its unnormalised ``acc =
    p . V`` with p rounded to q's dtype first.  A split with no live
    column gives ``m = -1e30``, ``l = 0``, ``acc = 0``.  Returns ``(acc [B,
    H, n_splits, Dh], m [B, H, n_splits], l [B, H, n_splits])`` in fp32."""
    _check(q, k_pool, v_pool, tables, lengths)
    B, H, Dh = q.shape
    _, BS, KV, _ = k_pool.shape
    n_cols = tables.shape[1]
    if not 1 <= n_splits <= n_cols:
        raise ValueError(f"n_splits must be in [1, {n_cols}]; got {n_splits}")
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    T = n_cols * BS
    idx = tables.long()
    keys = k_pool[idx].reshape(B, T, KV, Dh).float()
    vals = v_pool[idx].reshape(B, T, KV, Dh).float()
    qg = q.float().reshape(B, KV, H // KV, Dh)
    s = torch.einsum("bgrd,btgd->bgrt", qg, keys) * scale
    lens = lengths.to(q.device).long().clamp_min(0)
    n_live = ((lens + BS - 1) // BS).clamp_max(n_cols)
    end = torch.minimum(lens, n_live * BS)                        # [B]
    pos = torch.arange(T, device=q.device)
    cps = -(-n_cols // n_splits)
    accs, ms, ls = [], [], []
    for sp in range(n_splits):
        live = ((pos[None, :] >= sp * cps * BS)
                & (pos[None, :] < torch.minimum(end, torch.tensor(
                    (sp + 1) * cps * BS, device=q.device))[:, None]))
        live = live[:, None, None, :]                              # [B,1,1,T]
        m = torch.where(live, s, _NEG_INF).amax(dim=-1)
        p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
        accs.append(torch.einsum("bgrt,btgd->bgrd",
                                 p.to(q.dtype).float(), vals))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    return (torch.stack(accs, dim=3).reshape(B, H, n_splits, Dh),
            torch.stack(ms, dim=-1).reshape(B, H, n_splits),
            torch.stack(ls, dim=-1).reshape(B, H, n_splits))


def paged_attention_split_reference(q, k_pool, v_pool, tables, lengths,
                                    n_splits: int,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """The kernel's split-and-merge algorithm in plain PyTorch: the
    partials of :func:`paged_split_partials` merged by log-sum-exp, ``M =
    max_s m_s``, ``L = sum_s l_s e^(m_s - M)``, ``O = sum_s acc_s e^(m_s -
    M) / max(L, 1e-30)``.  Returns ``[B, H, Dh]`` in q's dtype."""
    acc, m, l = paged_split_partials(q, k_pool, v_pool, tables, lengths,
                                     n_splits, scale)
    M = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - M)
    L = (l * w).sum(dim=-1, keepdim=True)
    o = (acc * w[..., None]).sum(dim=2) / L.clamp_min(1e-30)
    return o.to(q.dtype)


#: CTAs a launch of the paged decode kernel aims for on each SM, through
#: its split over table columns (see :func:`paged_splits`).  4 against 2
#: on an H100: faster at GQA, at the serve shape and with uniform long
#: rows, a little slower at the 7B decode shape (PERF.md).
PAGED_CTAS_PER_SM = 4


def paged_splits(B: int, KV: int, n_cols: int, sm_count: int) -> int:
    """How many splits of the table columns the paged decode kernel
    launches: enough that ``B * KV * splits`` reaches
    ``PAGED_CTAS_PER_SM * sm_count`` CTAs, never more than ``n_cols`` (one
    page a split at least), and 1 when ``B * KV`` already fills the card.
    Decided from shapes alone, never from the lengths, which live on the
    card."""
    want = -(-PAGED_CTAS_PER_SM * sm_count // max(1, B * KV))
    return max(1, min(n_cols, want))


@functools.lru_cache(maxsize=256)
def _paged_plan(device: torch.device, B: int, H: int, Dh: int, KV: int,
                n_cols: int) -> tuple[int, int]:
    """A launch's split count and the fp32 scratch it needs (0 for one
    split: the main kernel then writes the output itself), decided once
    per shape and device."""
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    n_splits = paged_splits(B, KV, n_cols, sm)
    return n_splits, (B * H * n_splits * (Dh + 2) if n_splits > 1 else 0)


# Per-split scratch of paged_attention: one fp32 buffer for each (device,
# stream), grown when a launch needs more, so a decode tick allocates
# nothing.  Launches on one stream run in order and may share it; a buffer
# that is outgrown goes back to the caching allocator, which reuses it on
# the same stream only after the work queued there.
_PAGED_SCRATCH: dict = {}


def _paged_scratch(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` fp32 values of scratch for launches on ``stream``."""
    buf = _PAGED_SCRATCH.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = _PAGED_SCRATCH[device, stream] = torch.empty(
            n, dtype=torch.float32, device=device)
    return buf


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
    if not _on_card("paged_attention", q):
        return paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                                         scale)
    _check_kernel_inputs(q, k_pool, v_pool, tables, lengths)
    B, H, Dh = q.shape
    _, BS, KV, _ = k_pool.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    q = q.contiguous()
    if q.data_ptr() % 16:          # q's rows are read as 16-byte chunks
        q = q.clone()
    out = torch.empty_like(q)
    n_cols = tables.shape[1]
    n_splits, n_scratch = _paged_plan(q.device, B, H, Dh, KV, n_cols)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    parts = [None] * 3
    if n_splits > 1:               # per-split acc [B, H, n_splits, Dh], m, l
        rows = B * H * n_splits
        base = _paged_scratch(q.device, stream, n_scratch).data_ptr()
        parts = [base, base + 4 * rows * Dh, base + 4 * rows * (Dh + 1)]
    _launch("paged_decode", "paged_decode", q.device,
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), *parts,
            B, H, KV, Dh, BS, n_cols, n_splits, float(scale),
            _DTYPE_CODE[q.dtype], stream=stream)
    paged_attention.launches += 1
    return out


#: kernel launches made through :func:`paged_attention` in this process
paged_attention.launches = 0
