"""Llama-family transformer, forward-only serving path, in PyTorch.

A port of the serving entry points of ``horovod_tpu/models/llama.py``:
:class:`LlamaConfig`, parameter init, :func:`prefill_step` and
:func:`decode_step_paged`, with the helpers they share.  Layouts are the
JAX package's, so parameters move across with :func:`params_from_jax` and
the tests compare like with like:

- parameters are a plain dict; layer weights are stacked over a leading
  layer axis (``wq [L, D, H, Dh]``, ``wk/wv [L, D, KV, Dh]``,
  ``wo [L, H, Dh, D]``, ``w_gate/w_up [L, D, F]``, ``w_down [L, F, D]``),
  matrices in the config's dtype, norm weights in fp32;
- the layer ``lax.scan`` becomes a Python loop over the layer index;
- bf16 activations and weights with RMSNorm, RoPE and softmax in fp32,
  fp32 logits; RoPE is half-split (not interleaved); GQA; SwiGLU.

Training (the flash-attention kernels, the custom VJPs, the train step),
MoE configs, sharded meshes and the multi-token ``extend_step_paged``
wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import context
from ..ops import flash_attention as FA


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    use_moe: bool = False
    n_experts: int = 8

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config, fp32."""
        base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=128, dtype=torch.float32)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                    n_kv_heads=32, d_ff=11008)
        base.update(kw)
        return LlamaConfig(**base)


def _no_moe(cfg: LlamaConfig) -> None:
    if cfg.use_moe:
        raise NotImplementedError(
            "MoE configs wait for the parallel slice of the port")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded serving (mesh=) waits for the parallel slice of the "
            "port; this slice runs on one card")


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters in the JAX package's layout: matrices drawn from
    ``N(0, 1/fan_in)`` in fp32 and cast to ``cfg.dtype``, norm weights
    fp32 ones.  ``generator`` must live on ``device`` (default: the
    process's card).  The values differ from ``jax.random``'s for the
    same seed; tests that compare the two packages draw with numpy and
    use :func:`params_from_jax`."""
    _no_moe(cfg)
    dev = context.device(device)
    L, D, H, KV, Dh, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)

    def rnd(shape, fan_in, stacked=True):
        # One layer at a time, so the fp32 draw never holds the whole
        # stack (7B: 1.4 GB per layer of w_gate at most).
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        s = 1.0 / math.sqrt(fan_in)
        for i in range(shape[0] if stacked else 1):
            part = out[i] if stacked else out
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev, dtype=torch.float32) * s)
        return out

    def norm(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    layers = {
        "attn_norm": norm((L, D)),
        "wq": rnd((L, D, H, Dh), D),
        "wk": rnd((L, D, KV, Dh), D),
        "wv": rnd((L, D, KV, Dh), D),
        "wo": rnd((L, H, Dh, D), H * Dh),
        "mlp_norm": norm((L, D)),
        "w_gate": rnd((L, D, Fd), D),
        "w_up": rnd((L, D, Fd), D),
        "w_down": rnd((L, Fd, D), Fd),
    }
    return {
        "embed": rnd((cfg.vocab_size, D), D, stacked=False),
        "layers": layers,
        "final_norm": norm((D,)),
        "lm_head": rnd((D, cfg.vocab_size), D, stacked=False),
    }


def _leaf_to_torch(a, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")     # writable, owned by torch
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy:
        # move the bits as int16 and reinterpret them.
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_jax(tree: Any, device=None) -> Any:
    """A JAX parameter tree (nested dicts of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) as torch tensors on ``device``
    (default: the process's card), each leaf keeping its shape and dtype."""
    dev = context.device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf_to_torch(node, dev)

    return conv(tree)


def _rmsnorm_impl(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms * w).to(x.dtype)


def _rope_tables(positions: torch.Tensor, theta: float, head_dim: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[B, S, half]`` for these positions, computed once
    per forward and shared by every layer."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]
          ) -> torch.Tensor:
    # x: [B, S, H, Dh]; rope: (cos, sin) each [B, S, Dh // 2]; half-split.
    half = x.shape[-1] // 2
    cos, sin = rope[0][:, :, None, :], rope[1][:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Token embedding.  The JAX package uses a one-hot matmul; a lookup
    gives the same values exactly, since each one-hot row has a single
    nonzero."""
    return F.embedding(tokens.long(), embed).to(dtype)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    D, Hh, Dh = w.shape
    return torch.matmul(x, w.reshape(D, Hh * Dh)).reshape(
        *x.shape[:-1], Hh, Dh)


def _out_proj(attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", attn, wo)`` as one matmul."""
    H, Dh, D = wo.shape
    return torch.matmul(attn.reshape(*attn.shape[:-2], H * Dh),
                        wo.reshape(H * Dh, D))


def _layer_kv(x, lp, rope):
    """Post-RoPE K/V for a normed input chunk (no GQA expand — the cache
    stores kv_heads)."""
    return _rope(_heads(x, lp["wk"]), rope), _heads(x, lp["wv"])


def _cached_attend(q, keys, vals, mask, scale):
    """Attention against a KV cache, GQA-grouped.

    q ``[B, Sq, H, Dh]``; keys/vals ``[B, T, KV, Dh]``; mask ``[Sq, T]``
    bool (shared across the batch) or ``[B, Sq, T]`` (per request).  The
    q heads are grouped ``[KV, rep]`` and contracted against the grouped
    cache directly; the cache is never expanded to H heads."""
    B, Sq, H, Dh = q.shape
    KV = keys.shape[2]
    rep = H // KV
    qg = q.reshape(B, Sq, KV, rep, Dh)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, keys).float() * scale
    m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    s = torch.where(m, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(vals.dtype), vals)
    return o.reshape(B, Sq, H, Dh)


def _swiglu_hidden(x2, lp):
    """SwiGLU gate/up half: ``silu(x @ w_gate) * (x @ w_up)``."""
    return F.silu(torch.matmul(x2, lp["w_gate"])) \
        * torch.matmul(x2, lp["w_up"])


def _dense_mlp(x2, lp):
    return torch.matmul(_swiglu_hidden(x2, lp), lp["w_down"])


def _layer(layers: dict, li: int) -> dict:
    return {k: v[li] for k, v in layers.items()}


def _logits(params, h_last: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_rmsnorm_impl(h_last, params["final_norm"]),
                        params["lm_head"]).float()


@torch.no_grad()
def prefill_step(params, tokens: torch.Tensor, cfg: LlamaConfig, *,
                 mesh=None, last_pos: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prompt prefill for the serving engine.

    tokens ``[B, P]`` int → (logits ``[B, V]`` fp32 at ``last_pos``,
    per-layer K ``[L, B, P, KV, Dh]``, per-layer V).  ``last_pos`` ``[B]``
    selects the logits position per row (bucketed prompts are
    right-padded); None means ``P - 1``.  Causality makes a padded tail
    inert for every real position."""
    _no_moe(cfg)
    _no_mesh(mesh)
    B, P = tokens.shape
    dev = tokens.device
    scale = 1.0 / math.sqrt(cfg.head_dim)
    h = _embed_lookup(params["embed"], tokens, cfg.dtype)
    positions = torch.arange(P, device=dev).expand(B, P)
    rope = _rope_tables(positions, cfg.rope_theta, cfg.head_dim)
    mask = torch.ones(P, P, dtype=torch.bool, device=dev).tril()
    ks, vs = [], []
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        x = _rmsnorm_impl(h, lp["attn_norm"])
        q = _rope(_heads(x, lp["wq"]), rope)
        k, v = _layer_kv(x, lp, rope)
        attn = _cached_attend(q, k, v, mask, scale)
        h = h + _out_proj(attn, lp["wo"])
        h = h + _dense_mlp(_rmsnorm_impl(h, lp["mlp_norm"]), lp)
        ks.append(k)
        vs.append(v)
    if last_pos is None:
        h_last = h[:, -1]
    else:
        h_last = h[torch.arange(B, device=dev), last_pos.long()]
    return _logits(params, h_last), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_step_paged(params, tok: torch.Tensor, positions: torch.Tensor,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      tables: torch.Tensor, cfg: LlamaConfig, *,
                      mesh=None, use_flash: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode tick for the serving engine against the paged pool.

    tok ``[B]`` int (this tick's input token per slot); positions ``[B]``
    int32, its absolute position; k_pool/v_pool ``[L, NB, BS, KV, Dh]``;
    tables ``[B, n_cols]`` int32 block tables (inactive rows all-scratch).
    Each layer writes its fresh K/V into ``tables[b][positions[b] // BS]``
    at offset ``positions[b] % BS`` and attends over the table's window
    with a per-request ``<= position`` mask.  The attention reads the pool
    through :func:`~horovod_tpu_torch.ops.flash_attention.paged_attention`
    (``use_flash``: the CUDA kernel on the card, its plain version on the
    CPU) or through a contiguous gather and :func:`_cached_attend`.

    The writes land in ``k_pool``/``v_pool`` in place (the JAX package
    donates the pools and scatters functionally); they are also returned.
    Inactive slots all write to (block 0, offset 0) — duplicate indices,
    so which one lands is unspecified; block 0 is scratch and never read
    unmasked.  Returns (logits ``[B, V]`` fp32, k_pool, v_pool)."""
    from ..serving.kv_pager import gather_blocks

    _no_moe(cfg)
    _no_mesh(mesh)
    B = tok.shape[0]
    _, _, BS, _, _ = k_pool.shape
    dev = tok.device
    scale = 1.0 / math.sqrt(cfg.head_dim)
    T = tables.shape[1] * BS
    h = _embed_lookup(params["embed"], tok[:, None], cfg.dtype)
    rope = _rope_tables(positions[:, None], cfg.rope_theta, cfg.head_dim)
    pos = positions.long()
    mask = (torch.arange(T, device=dev)[None, :] <= pos[:, None])[:, None, :]
    blk = tables[torch.arange(B, device=dev), pos // BS].long()
    off = pos % BS
    lengths = (positions + 1).to(torch.int32)
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        x = _rmsnorm_impl(h, lp["attn_norm"])
        q = _rope(_heads(x, lp["wq"]), rope)
        k1, v1 = _layer_kv(x, lp, rope)                    # [B, 1, KV, Dh]
        k_pool[li, blk, off] = k1[:, 0]
        v_pool[li, blk, off] = v1[:, 0]
        if use_flash:
            attn = FA.paged_attention(q[:, 0], k_pool[li], v_pool[li],
                                      tables, lengths, scale=scale)[:, None]
        else:
            keys = gather_blocks(k_pool[li], tables)       # [B, T, KV, Dh]
            vals = gather_blocks(v_pool[li], tables)
            attn = _cached_attend(q, keys, vals, mask, scale)
        h = h + _out_proj(attn, lp["wo"])
        h = h + _dense_mlp(_rmsnorm_impl(h, lp["mlp_norm"]), lp)
    return _logits(params, h[:, 0]), k_pool, v_pool
