"""Memory-efficient losses: blockwise softmax cross-entropy.

A port of ``horovod_tpu/ops/losses.py``.  The dense loss materialises fp32
logits ``[T, V]`` (at T = 4096, V = 32000 that is 524 MB, written, read by
the softmax and mirrored by its gradient); this op streams the vocabulary
in blocks instead, an online softmax over the vocab dim:

- forward: one pass over the blocks of ``W`` accumulating the running max,
  the sum of exps and the target column's logit; it saves only ``x``,
  ``w``, ``targets`` and ``lse`` ``[T]``, never a ``[T, V]`` tensor;
- backward: recomputes each block's logits (one more lm_head product) and
  feeds ``(softmax - onehot) * g`` into the two gradient products block by
  block, with the onehot as a scatter at the target column.

Block logits and ``dx`` accumulate in fp32 from operands in the input's
dtype, as the reference's ``preferred_element_type=float32`` does: on a
CUDA device through ``torch.mm(..., out_dtype=torch.float32)`` (a bf16
GEMM with an fp32 output, cuBLAS accumulating in fp32), which raises if
the card's PyTorch lacks it; on the CPU, which has no such product, by
upcasting both operands to fp32 (exact: every bf16 value is an fp32
value), which costs one fp32 copy of the block.  These are plain matrix
products outside any kernel of the reference.
"""

from __future__ import annotations

from typing import Optional

import torch


def _pick_block(vocab: int, requested: Optional[int]) -> int:
    if requested is not None:
        if vocab % requested:
            raise ValueError(
                f"vocab ({vocab}) must divide into blocks of {requested}")
        return requested
    # Largest divisor <= 8192: a few wide blocks, never hundreds of skinny
    # ones (32000 -> 8000).  A vocab without a usable divisor (GPT-2's
    # prime 50257) is padded to a multiple of 4096 instead; padded columns
    # are masked out of the softmax.
    for b in range(min(8192, vocab), 511, -1):
        if vocab % b == 0:
            return b
    return 4096  # no usable divisor: pad to a 4096 multiple


def _blocks(w: torch.Tensor, block: int) -> list:
    """[D, V] -> the column blocks [D, block]; the last one is zero-padded
    up to ``block`` when V is not a multiple (padded columns are masked
    by the callers).  The others are views of ``w``."""
    D, V = w.shape
    n = -(-V // block)
    blocks = [w[:, i * block:(i + 1) * block] for i in range(n)]
    pad = n * block - V
    if pad:
        blocks[-1] = torch.cat([blocks[-1], w.new_zeros((D, pad))], dim=1)
    return blocks


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result accumulated in fp32 (module
    docstring)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _BlockwiseCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, block):
        T = x.shape[0]
        V = w.shape[1]
        blk = _pick_block(V, block)
        wb = _blocks(w, blk)
        tgts = targets.long()
        rows = torch.arange(T, device=x.device)
        m = torch.full((T,), float("-inf"), device=x.device)
        s = torch.zeros(T, device=x.device)
        tgt = torch.zeros(T, device=x.device)
        for i, wblk in enumerate(wb):
            start = i * blk
            logits = _mm32(x, wblk)                             # [T, blk]
            if start + blk > V:                 # padded vocab columns
                cols = start + torch.arange(blk, device=x.device)
                logits = logits.masked_fill(cols[None, :] >= V,
                                            float("-inf"))
            new_m = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - new_m) + torch.exp(
                logits - new_m[:, None]).sum(dim=-1)
            m = new_m
            local = tgts - start
            in_blk = (local >= 0) & (local < blk)
            picked = logits[rows, local.clamp(0, blk - 1)]
            tgt = tgt + torch.where(in_blk, picked, 0.0)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.block = block
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        T, D = x.shape
        V = w.shape[1]
        blk = _pick_block(V, ctx.block)
        wb = _blocks(w, blk)
        tgts = targets.long()
        rows = torch.arange(T, device=x.device)
        g32 = g.float()
        dx = torch.zeros(T, D, device=x.device)
        dw = torch.empty_like(w)
        for i, wblk in enumerate(wb):
            start = i * blk
            p = torch.exp(_mm32(x, wblk) - lse[:, None])   # softmax block
            if start + blk > V:
                cols = start + torch.arange(blk, device=x.device)
                p = p.masked_fill(cols[None, :] >= V, 0.0)
            local = tgts - start
            in_blk = (local >= 0) & (local < blk)
            dlog = p * g32[:, None]
            # Subtract g at each token's target column: a scatter, not a
            # [T, blk] one-hot.
            dlog.index_put_((rows, local.clamp(0, blk - 1)),
                            torch.where(in_blk, -g32, 0.0), accumulate=True)
            dlog = dlog.to(x.dtype)                             # [T, blk]
            dx += _mm32(dlog, wblk.t())
            width = min(blk, V - start)
            dw[:, start:start + width] = _mm32(
                x.t(), dlog)[:, :width].to(w.dtype)
        return dx.to(x.dtype), dw, None, None


def blockwise_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                            targets: torch.Tensor,
                            block: Optional[int] = None) -> torch.Tensor:
    """Per-token negative log-likelihood without materialising logits.

    x: ``[T, D]`` activations (any float dtype; accumulation is fp32).
    w: ``[D, V]`` lm-head weight.
    targets: ``[T]`` integer class ids.
    Returns ``[T]`` fp32 nll (callers take the mean); differentiable in
    ``x`` and ``w``.
    """
    return _BlockwiseCE.apply(x, w, targets, block)
