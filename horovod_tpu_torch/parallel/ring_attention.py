"""Sequence parallelism: exact attention over a sequence sharded across
the ranks of an ``sp`` group.

The port of ``horovod_tpu/parallel/ring_attention.py``.  Two schedules:

- **Ring** (Liu, Zaharia & Abbeel, arXiv:2310.01889): the sequence is
  chunked contiguously over the group; Q stays on its rank while the K/V
  blocks rotate around the ring, each hop folded in with an online
  (flash-style) softmax in fp32.  Rank *i* owns tokens ``[i*C, (i+1)*C)``;
  after *s* hops the resident block came from rank ``(i - s) mod n``:
  fully visible when it is earlier, lower-triangular on the diagonal,
  fully masked when it is later.  A masked block still hops, so every
  rank stays in lockstep.  The rotation is an ``autograd.Function``
  (:class:`_RingShift`) over ``torch.distributed.batch_isend_irecv``
  whose backward sends the cotangents the other way round.
- **Ulysses** (DeepSpeed-Ulysses, arXiv:2309.14509): an all-to-all swaps
  the sharded dim from sequence to heads, every rank attends over the
  whole sequence with ``1/n`` of the heads, and a second all-to-all swaps
  back; the reference's tiled ``lax.all_to_all`` as ``all_to_all_single``
  between the permutes it implies.

Both are plain PyTorch (jnp in the reference, not Pallas): no kernel.
K and V come with q's head count (expand grouped K/V first).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from . import comm

_NEG_INF = -1e30


def _block_attend(q, k, scale, mask):
    """Scores ``[B, H, Lq, Lk]`` of one (local-Q x resident-KV) block in
    q's dtype, masked (``mask`` ``[Lq, Lk]`` bool or None)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, _NEG_INF)
    return s


def _shift(xs, group, step: int) -> list:
    """Every tensor of ``xs`` to the rank ``step`` ahead in ``group``,
    each rank receiving from the rank ``step`` behind: one batch of
    isend/irecv."""
    ranks = dist.get_process_group_ranks(group)
    n, me = len(ranks), dist.get_rank(group)
    dst, src = ranks[(me + step) % n], ranks[(me - step) % n]
    outs, ops = [], []
    for x in xs:
        x = x.contiguous()
        out = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, dst, group))
        ops.append(dist.P2POp(dist.irecv, out, src, group))
        outs.append(out)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    """K and V one hop round the ring forward, their cotangents one hop
    back."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_shift((k, v), group, 1))

    @staticmethod
    def backward(ctx, dk, dv):
        return (None, *_shift((dk, dv), ctx.group, -1))


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, group=None, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over this rank's sequence chunk of q, k, v
    ``[B, L, H, D]`` (the ranks of ``group`` hold the chunks in rank
    order); returns this rank's chunk of the output.  Differentiable."""
    n = dist.get_world_size(group) if group is not None else 1
    my = dist.get_rank(group) if group is not None else 0
    B, L, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    m = torch.full((B, H, L), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, L), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, L, H, D), dtype=torch.float32, device=q.device)
    tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    k_cur, v_cur = k, v
    for step in range(n):
        origin = (my - step) % n
        mask = None
        if causal:
            mask = tri if origin == my else torch.full_like(tri, origin < my)
        s = _block_attend(q, k_cur, scale, mask).float()
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_cur.float())
        o = o * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        if step != n - 1:
            k_cur, v_cur = _RingShift.apply(group, k_cur, v_cur)
    out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh, *, axis_name: str = "sp", causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Standalone entry: every rank passes the global ``[B, S, H, D]``
    q, k, v; each takes its sequence chunk over ``axis_name``, the ring
    computes exact attention, and every rank gets the global output."""
    spec = (None, axis_name, None, None)
    from .sharding import shard
    group, _ = comm.group_of(mesh, (axis_name,))
    out = ring_attention_local(shard(q, spec, mesh), shard(k, spec, mesh),
                               shard(v, spec, mesh), group=group,
                               causal=causal, scale=scale)
    return comm.gather_tensor(out, mesh, (axis_name,), 1)


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[B, L, H, D]`` local sequence -> ``[B, n*L, H/n, D]`` local heads:
    head block ``j`` to rank ``j``, the received blocks concatenated
    along the sequence in rank order."""
    B, L, H, D = x.shape
    blocks = x.reshape(B, L, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = comm._AllToAll.apply(blocks.contiguous(), group)
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * L, H // n, D)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`."""
    B, nL, Hn, D = x.shape
    L = nL // n
    blocks = x.reshape(B, n, L, Hn, D).permute(1, 0, 2, 3, 4)
    got = comm._AllToAll.apply(blocks.contiguous(), group)
    return got.permute(1, 2, 0, 3, 4).reshape(B, L, n * Hn, D)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, group=None,
                            causal: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses sequence parallelism over this rank's sequence chunk of q,
    k, v ``[B, L, H, D]``: an all-to-all to whole sequences of ``H/n``
    heads, dense attention (fp32 softmax), an all-to-all back.  ``n``
    must divide ``H``.  Differentiable."""
    n = dist.get_world_size(group) if group is not None else 1
    B, L, H, D = q.shape
    if H % n:
        raise ValueError(
            f"sp size ({n}) must divide heads ({H}) for Ulysses")
    if n > 1:
        qh, kh, vh = (_seq_to_heads(t, group, n) for t in (q, k, v))
    else:
        qh, kh, vh = q, k, v
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    S = qh.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril() \
        if causal else None
    s = _block_attend(qh, kh, scale, mask).float()
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh.float()).to(q.dtype)
    return _heads_to_seq(out, group, n) if n > 1 else out


def sp_local_attention(mode: str):
    """The sequence-parallel attention of ``LlamaConfig.sp_attention``."""
    if mode == "ulysses":
        return ulysses_attention_local
    if mode == "ring":
        return ring_attention_local
    raise ValueError(f"unknown sp_attention {mode!r} "
                     "(expected 'ring' or 'ulysses')")
