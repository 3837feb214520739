"""Llama-family transformer in PyTorch: the training step and the serving
entry points.

A port of ``horovod_tpu/models/llama.py``: :class:`LlamaConfig`, parameter
init, the training path (:func:`forward`, :func:`loss_fn`,
:func:`make_train_step`, with RMSNorm's hand-written VJP, attention
through the flash kernels' ``torch.autograd.Function``, per-layer or
save-the-products (``remat="dots"``) recompute and the blockwise
cross-entropy), batch decoding (:func:`generate`) and the serving entry
points :func:`prefill_step`, :func:`decode_step_paged` and
:func:`extend_step_paged`, with the helpers they share.  Layouts are the JAX package's, so parameters move
across with :func:`params_from_jax` and the tests compare like with like:

- parameters are a plain dict; layer weights are stacked over a leading
  layer axis (``wq [L, D, H, Dh]``, ``wk/wv [L, D, KV, Dh]``,
  ``wo [L, H, Dh, D]``, ``w_gate/w_up [L, D, F]``, ``w_down [L, F, D]``;
  an MoE config's ``router [L, D, E]`` in fp32, ``w_gate/w_up
  [L, E, D, F]`` and ``w_down [L, E, F, D]``), matrices in the config's
  dtype, norm weights in fp32;
- the layer ``lax.scan`` becomes a Python loop over the layer index;
- bf16 activations and weights with RMSNorm, RoPE and softmax in fp32,
  fp32 logits; RoPE is half-split (not interleaved); GQA; SwiGLU;
- ``use_moe``: a Switch-MoE MLP of ``n_experts`` SwiGLU experts, top-1
  routing at ``capacity_factor`` (:mod:`..parallel.moe`), its
  load-balancing loss summed over layers and added to the training loss
  times ``moe_aux_weight``.

Training on a rank mesh (``mesh=`` a :func:`~..parallel.build_mesh`
``DeviceMesh`` with ``pp = 1``): every rank holds its block of each
parameter under the JAX package's logical rules (:func:`param_shardings`,
:mod:`..parallel.sharding`), the optimizer's state too, and the layers
run Megatron and ZeRO style over explicit collectives
(:mod:`..parallel.comm`) where GSPMD inserts them in the reference:

- ``dp``, ``fsdp`` and ``ep`` split the batch rows (``ep`` splits the
  reference's MoE tokens; a dense layer treats it as one more data axis),
  ``sp`` the sequence (RoPE at the rank's global positions, ring or
  Ulysses attention, :mod:`..parallel.ring_attention`);
- ``fsdp`` is ZeRO-3: a layer's blocks are all-gathered inside its
  recompute region, their gradients reduce-scattered;
- ``tp`` is Megatron: column-parallel ``wq/wk/wv`` and ``w_gate/w_up``,
  row-parallel ``wo`` and ``w_down``, the embedding's rows and the
  lm_head's columns over ``tp`` with a vocab-parallel cross-entropy;
- ``ep`` shards the experts: the MoE layer exchanges tokens over the
  ``ep`` group (:func:`~..parallel.moe.moe_layer_local`);
- each rank's loss is its share of the global mean, and each gradient is
  summed over the data axes its parameter is replicated along
  (:func:`reduce_gradients`).

With every axis of size 1 the mesh path is the plain path: the same ops
in the same order, no collective.

Still raising ``NotImplementedError``: pipeline parallelism (``pp > 1``),
``mesh=`` in ``generate`` and the serving steps, and MoE configs in
``generate`` and the serving steps, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import context
from ..ops import flash_attention as FA
from ..parallel import comm
from ..parallel import sharding as shd
from ..parallel.mesh import AXES, ROADMAP_ITEM


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
    capacity_factor: float = 1.25
    # Recompute of the layer body in the backward: True = per-layer
    # recompute (the layer inputs are all that is kept; the Llama-2-7B
    # training step needs it to fit one 80 GB card), False = keep every
    # activation, "dots" = keep the outputs of the weight products and
    # recompute the rest (the JAX package's
    # dots_with_no_batch_dims_saveable policy).
    remat: Union[bool, str] = True
    # Weight of the MoE load-balancing loss in loss_fn.
    moe_aux_weight: float = 0.01
    # Loss through ops/losses.py's blockwise cross-entropy: the [B, S, V]
    # logits are never materialised.
    blockwise_ce: bool = False
    # Sequence-parallel attention on sp > 1 meshes: "ring" (K/V blocks
    # rotated over the sp group, any head count) or "ulysses" (all-to-all
    # heads <-> sequence; the local heads must divide by sp).
    sp_attention: str = "ring"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config, fp32, no recompute."""
        base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=128, dtype=torch.float32, remat=False)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                    n_kv_heads=32, d_ff=11008)
        base.update(kw)
        return LlamaConfig(**base)


def _no_moe(cfg: LlamaConfig) -> None:
    """The serving steps refuse MoE configs, with the JAX package's
    serving engine's message."""
    if cfg.use_moe:
        raise NotImplementedError("serving does not support MoE configs")


def _no_mesh(mesh, what: str) -> None:
    """Sharded generation and serving wait for a later slice."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what} on a mesh (mesh=) waits for a later slice of the port: "
            f"sharded serving and generation, ROADMAP section A "
            f"{ROADMAP_ITEM}")


def _check_train_cfg(cfg: LlamaConfig) -> None:
    if cfg.remat not in (True, False, "dots"):
        raise ValueError(
            f"remat must be True, False or 'dots', got {cfg.remat!r}")
    if cfg.remat == "dots":
        _dots_context()


# The products whose outputs remat="dots" keeps: matrix products without
# batch dimensions, the counterpart of
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable.  The seven
# weight products of a layer reach aten.mm (torch.matmul folds
# [B, S, D] @ [D, N] into one); the attention's batched products (bmm, or
# the flash Function's kernels) and every elementwise op are recomputed.
_DOTS_SAVED = ("mm", "addmm")


def _dots_context():
    """The ``context_fn`` of ``torch.utils.checkpoint`` for
    ``remat="dots"``: selective activation checkpointing, which needs
    PyTorch 2.4 or later."""
    try:
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts)
    except ImportError as e:
        raise NotImplementedError(
            f"remat='dots' needs selective activation checkpointing "
            f"(PyTorch >= 2.4); this is PyTorch {torch.__version__}") from e
    saved = {getattr(torch.ops.aten, n).default for n in _DOTS_SAVED}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


# Logical dims of every parameter (leaf name -> dims); the stacked layer
# leaves have a leading "stage" dim (pp).
def param_logical_dims(cfg: LlamaConfig) -> dict:
    layer = {
        "attn_norm": ("stage", None),
        "wq": ("stage", "embed", "heads", "head_dim"),
        "wk": ("stage", "embed", "kv_heads", "head_dim"),
        "wv": ("stage", "embed", "kv_heads", "head_dim"),
        "wo": ("stage", "heads", "head_dim", "embed"),
        "mlp_norm": ("stage", None),
    }
    if cfg.use_moe:
        layer.update({
            "router": ("stage", None, None),
            "w_gate": ("stage", "experts", "embed", "expert_mlp"),
            "w_up": ("stage", "experts", "embed", "expert_mlp"),
            "w_down": ("stage", "experts", "expert_mlp", "embed"),
        })
    else:
        layer.update({
            "w_gate": ("stage", "embed", "mlp"),
            "w_up": ("stage", "embed", "mlp"),
            "w_down": ("stage", "mlp", "embed"),
        })
    return {
        "embed": ("vocab_rows", None),
        "layers": layer,
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def shard_rules(cfg: LlamaConfig, mesh) -> Optional[dict]:
    """Mesh-aware rule overrides for this config: where tp divides
    ``n_heads`` but not ``n_kv_heads`` (kv=2 on tp=4), ``kv_heads``
    degrades to a dividing prefix or replication, and the attention
    expands K/V before it takes its heads (:func:`_attn_block`)."""
    if mesh is None:
        return None
    return shd.fitted_rules(mesh, {"heads": cfg.n_heads,
                                   "kv_heads": cfg.n_kv_heads})


def param_shardings(cfg: LlamaConfig, mesh) -> dict:
    """The spec of every parameter on ``mesh``, in the parameters'
    layout (a tuple an entry a dim; see :mod:`..parallel.sharding`)."""
    rules = shard_rules(cfg, mesh)
    dims = param_logical_dims(cfg)
    out = {k: shd.spec_for(d, rules) for k, d in dims.items()
           if k != "layers"}
    out["layers"] = {k: shd.spec_for(d, rules)
                     for k, d in dims["layers"].items()}
    return out


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, *, mesh=None) -> dict:
    """Random parameters in the JAX package's layout: matrices drawn from
    ``N(0, 1/fan_in)`` in fp32 and cast to ``cfg.dtype``, norm weights
    fp32 ones.  ``generator`` must live on ``device`` (default: the
    process's card).  The values differ from ``jax.random``'s for the
    same seed; tests that compare the two packages draw with numpy and
    use :func:`params_from_jax`.  An MoE config's router is drawn like a
    matrix, rounded to ``cfg.dtype`` and kept in fp32, as the JAX
    package's.

    With ``mesh=``, every rank draws the same full values as without (one
    layer at a time, the same generator calls) and keeps its block under
    :func:`param_shardings`, so a sharded run starts from exactly the
    unsharded weights."""
    dev = context.device(device)
    plan = _Plan(cfg, mesh)
    specs = plan.stack_specs
    L, D, H, KV, Dh, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)

    def rnd(spec, shape, fan_in, stacked=True):
        # One layer at a time, so the fp32 draw never holds the whole
        # stack (7B: 1.4 GB per layer of w_gate at most).
        out = torch.empty(plan.local_shape(shape, spec), dtype=cfg.dtype,
                          device=dev)
        s = 1.0 / math.sqrt(fan_in)
        for i in range(shape[0] if stacked else 1):
            part = out[i] if stacked else out
            full = shape[1:] if stacked else shape
            part.copy_(plan.block(
                torch.randn(full, generator=generator, device=dev,
                            dtype=torch.float32) * s,
                spec[1:] if stacked else spec))
        return out

    def norm(spec, shape):
        return torch.ones(plan.local_shape(shape, spec), dtype=torch.float32,
                          device=dev)

    ls = specs["layers"]
    layers = {
        "attn_norm": norm(ls["attn_norm"], (L, D)),
        "wq": rnd(ls["wq"], (L, D, H, Dh), D),
        "wk": rnd(ls["wk"], (L, D, KV, Dh), D),
        "wv": rnd(ls["wv"], (L, D, KV, Dh), D),
        "wo": rnd(ls["wo"], (L, H, Dh, D), H * Dh),
        "mlp_norm": norm(ls["mlp_norm"], (L, D)),
    }
    if cfg.use_moe:
        E = cfg.n_experts
        layers.update({
            "router": rnd(ls["router"], (L, D, E), D).float(),
            "w_gate": rnd(ls["w_gate"], (L, E, D, Fd), D),
            "w_up": rnd(ls["w_up"], (L, E, D, Fd), D),
            "w_down": rnd(ls["w_down"], (L, E, Fd, D), Fd),
        })
    else:
        layers.update({
            "w_gate": rnd(ls["w_gate"], (L, D, Fd), D),
            "w_up": rnd(ls["w_up"], (L, D, Fd), D),
            "w_down": rnd(ls["w_down"], (L, Fd, D), Fd),
        })
    return {
        "embed": rnd(specs["embed"], (cfg.vocab_size, D), D, stacked=False),
        "layers": layers,
        "final_norm": norm(specs["final_norm"], (D,)),
        "lm_head": rnd(specs["lm_head"], (D, cfg.vocab_size), D,
                       stacked=False),
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


def shard_params(tree: Any, cfg: LlamaConfig, mesh, device=None) -> dict:
    """:func:`params_from_jax` for a rank of ``mesh``: the JAX package's
    full parameters (numpy arrays) as this rank's blocks under
    :func:`param_shardings`, torch tensors on ``device``."""
    dev = context.device(device)
    plan = _Plan(cfg, mesh)

    def conv(node, spec):
        if isinstance(node, dict):
            return {k: conv(v, spec[k]) for k, v in node.items()}
        return _leaf_to_torch(plan.block(np.asarray(node), spec), dev)

    return conv(tree, plan.stack_specs)


def _rmsnorm_impl(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms * w).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the hand-written VJP of the JAX package, whose only
    residuals are ``x`` and ``w``: the backward recomputes the fp32
    normalised activations from ``x`` instead of keeping them."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_impl(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        x32 = x.float()
        r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + ctx.eps)
        u = x32 * r                                   # normalised activations
        dy32 = dy.float()
        du = dy32 * w
        s = (du * u).mean(dim=-1, keepdim=True)
        dx = (r * (du - u * s)).to(x.dtype)
        dw = (dy32 * u).sum(dim=tuple(range(x.dim() - 1))).to(w.dtype)
        return dx, dw, None


def _rmsnorm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    return _RMSNorm.apply(x, w, eps)


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
    """Layer ``li``'s weights: the per-layer optimizer leaves that
    :func:`trainable` made for a stack, else a view of the stack."""
    return {k: (v._layer_leaves[li] if hasattr(v, "_layer_leaves")
                else v[li]) for k, v in layers.items()}


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
    _no_mesh(mesh, "prefill_step")
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
    _no_mesh(mesh, "decode_step_paged")
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


@torch.no_grad()
def extend_step_paged(params, tok: torch.Tensor, positions: torch.Tensor,
                      valid: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, tables: torch.Tensor,
                      cfg: LlamaConfig, *, mesh=None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-token paged forward: S tokens a row in one call.

    It serves (a) the prefix-hit tail prefill: a prompt whose head is
    already in the pool (radix prefix cache) prefills only its tail while
    attending over the cached prefix K/V, and (b) the speculative verify:
    the target scores ``k + 1`` positions (the last accepted token and k
    drafts) in one forward.

    tok ``[B, S]`` int; positions ``[B, S]`` absolute positions; valid
    ``[B, S]`` bool — False slots (right-padding, inactive verify rows)
    route their K/V writes to scratch block 0, so a padded slot repeating
    a real position never writes a live (block, offset) twice; their
    logits are meaningless.  k_pool/v_pool ``[L, NB, BS, KV, Dh]``; tables
    ``[B, n_cols]`` int32.

    Each layer writes all S fresh K/V rows into the pool in place first,
    then attends over the table's window with the per-token mask
    ``pool_pos <= positions[b, s]``: token s sees the cached prefix and the
    earlier tokens of this call, the visibility a monolithic prefill gives
    it.  The pool is read through :func:`gather_blocks` and
    :func:`_cached_attend`, as in the JAX package (the paged kernel takes
    one query a row).  Returns (logits ``[B, S, V]`` fp32, k_pool,
    v_pool)."""
    from ..serving.kv_pager import gather_blocks

    _no_moe(cfg)
    _no_mesh(mesh, "extend_step_paged")
    B, S = tok.shape
    BS = k_pool.shape[2]
    dev = tok.device
    scale = 1.0 / math.sqrt(cfg.head_dim)
    T = tables.shape[1] * BS
    h = _embed_lookup(params["embed"], tok, cfg.dtype)
    rope = _rope_tables(positions, cfg.rope_theta, cfg.head_dim)
    pos = positions.long()
    mask = torch.arange(T, device=dev)[None, None, :] <= pos[:, :, None]
    col = torch.where(valid, pos // BS, 0)
    blk = torch.where(valid, tables.long().gather(1, col), 0)      # [B, S]
    off = torch.where(valid, pos % BS, 0)
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        x = _rmsnorm_impl(h, lp["attn_norm"])
        q = _rope(_heads(x, lp["wq"]), rope)
        k1, v1 = _layer_kv(x, lp, rope)                    # [B, S, KV, Dh]
        k_pool[li, blk, off] = k1
        v_pool[li, blk, off] = v1
        keys = gather_blocks(k_pool[li], tables)           # [B, T, KV, Dh]
        vals = gather_blocks(v_pool[li], tables)
        attn = _cached_attend(q, keys, vals, mask, scale)
        h = h + _out_proj(attn, lp["wo"])
        h = h + _dense_mlp(_rmsnorm_impl(h, lp["mlp_norm"]), lp)
    return _logits(params, h), k_pool, v_pool


def _pick_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                temperature: float, dtype: torch.dtype) -> torch.Tensor:
    """Greedy or temperature sampling from ``[B, V]`` fp32 logits."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(dtype)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(dtype)


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, cfg: LlamaConfig, *,
             max_new_tokens: int, mesh=None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Autoregressive decoding with a per-layer KV cache.

    ``prompt``: ``[B, P]`` int, on the device the parameters live on.
    Returns ``[B, P + max_new_tokens]``, the prompt with the continuation
    appended.  ``temperature == 0`` (the default) decodes greedily;
    ``temperature > 0`` samples from ``softmax(logits / temperature)``
    with ``generator`` (a ``torch.Generator`` on the prompt's device,
    required then; the JAX package's ``key``).  Prefill runs the layer
    stack once over the prompt with dense attention over its own keys and
    writes the ``[L, B, T, KV, Dh]`` cache (``T = P + max_new_tokens``);
    each of the ``max_new_tokens - 1`` decode ticks then writes its K/V
    at its position in place and attends over the cache.  Sharded and
    pipelined generation (``mesh=``) and MoE configs raise
    ``NotImplementedError``."""
    if cfg.use_moe:
        raise NotImplementedError("generate does not support MoE configs")
    _no_mesh(mesh, "generate")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    B, P = prompt.shape
    T = P + max_new_tokens
    dev = prompt.device
    L, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(Dh)
    cache_k = torch.zeros((L, B, T, KV, Dh), dtype=cfg.dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)

    # ---- prefill: attention over the P prompt keys, cache written ------
    h = _embed_lookup(params["embed"], prompt, cfg.dtype)
    rope = _rope_tables(torch.arange(P, device=dev).expand(B, P),
                        cfg.rope_theta, Dh)
    mask = torch.ones(P, P, dtype=torch.bool, device=dev).tril()
    for li in range(L):
        lp = _layer(params["layers"], li)
        x = _rmsnorm_impl(h, lp["attn_norm"])
        q = _rope(_heads(x, lp["wq"]), rope)
        k, v = _layer_kv(x, lp, rope)
        cache_k[li, :, :P] = k
        cache_v[li, :, :P] = v
        h = h + _out_proj(_cached_attend(q, k, v, mask, scale), lp["wo"])
        h = h + _dense_mlp(_rmsnorm_impl(h, lp["mlp_norm"]), lp)
    tok = _pick_token(_logits(params, h[:, -1]), generator, temperature,
                      prompt.dtype)
    new = [tok]

    # ---- decode: one token a tick, appended to the cache ---------------
    steps = torch.arange(T, device=dev)
    for pos in range(P, T - 1):
        h = _embed_lookup(params["embed"], tok[:, None], cfg.dtype)
        rope = _rope_tables(torch.full((B, 1), pos, device=dev),
                            cfg.rope_theta, Dh)
        mask = (steps <= pos)[None, :]                           # [1, T]
        for li in range(L):
            lp = _layer(params["layers"], li)
            x = _rmsnorm_impl(h, lp["attn_norm"])
            q = _rope(_heads(x, lp["wq"]), rope)
            k1, v1 = _layer_kv(x, lp, rope)
            cache_k[li, :, pos] = k1[:, 0]
            cache_v[li, :, pos] = v1[:, 0]
            attn = _cached_attend(q, cache_k[li], cache_v[li], mask, scale)
            h = h + _out_proj(attn, lp["wo"])
            h = h + _dense_mlp(_rmsnorm_impl(h, lp["mlp_norm"]), lp)
        tok = _pick_token(_logits(params, h[:, 0]), generator, temperature,
                          prompt.dtype)
        new.append(tok)
    return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)


# ---------------------------------------------------------------------------
# the rank mesh
# ---------------------------------------------------------------------------

# The axes that split the batch rows, major first: the reference's batch
# axes dp·fsdp and, finer, ep, over which its MoE layer splits the tokens.
BATCH_AXES = ("dp", "fsdp", "ep")
# The axes along which ranks hold different data: each rank's loss is its
# share of the global mean, and a gradient sums over those of them its
# parameter is replicated along.
DATA_AXES = ("dp", "fsdp", "ep", "sp")


class _Plan:
    """How this rank's part of the model lies on ``mesh``: axis sizes and
    this rank's coordinate, every parameter's spec, the rank's block of
    the batch and the collectives of each layer.  With ``mesh=None``, or
    every axis of size 1, every method is the identity and no collective
    is issued, so the mesh path runs the plain path's ops."""

    def __init__(self, cfg: LlamaConfig, mesh):
        sizes = shd.axis_sizes(mesh)
        if sizes.get("pp", 1) > 1:
            raise NotImplementedError(
                f"pipeline parallelism (pp = {sizes['pp']} in mesh=) is not "
                f"ported yet: ROADMAP section A {ROADMAP_ITEM}")
        self.mesh = mesh
        self.size = {a: sizes.get(a, 1) for a in AXES}
        self.trivial = all(n == 1 for n in self.size.values())
        self.coord = (shd.coordinate(mesh) if not self.trivial
                      else {a: 0 for a in AXES})
        self.stack_specs = param_shardings(cfg, mesh)
        self.layer_specs = {k: v[1:]
                            for k, v in self.stack_specs["layers"].items()}
        rules = shard_rules(cfg, mesh)
        tp_of = (lambda dim: self.size["tp"] > 1 and "tp" in
                 shd.entry_axes(shd.spec_for((dim,), rules)[0]))
        self.heads_tp, self.kv_tp = tp_of("heads"), tp_of("kv_heads")
        self.n_batch = math.prod(self.size[a] for a in BATCH_AXES)
        self.n_data = self.n_batch * self.size["sp"]
        self.batch_index = 0
        for a in BATCH_AXES:
            self.batch_index = self.batch_index * self.size[a] + self.coord[a]

    # -- blocks ------------------------------------------------------------

    def local_shape(self, shape, spec) -> tuple:
        if self.trivial:
            return tuple(shape)
        return tuple(sl.stop - sl.start for sl in shd.block_slices(
            shape, spec, self.size, self.coord))

    def block(self, x, spec):
        """This rank's block of the full ``x`` (a view), ``x`` itself on a
        trivial mesh."""
        return x if self.trivial else shd.block(x, spec, self.size,
                                                self.coord)

    def local_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (over dp·fsdp·ep) and sequence chunk (over
        sp) of a global ``[B, S]`` batch."""
        if self.n_batch > 1:
            B = x.shape[0]
            if B % self.n_batch:
                raise ValueError(f"global batch {B} must divide over "
                                 f"dp*fsdp*ep = {self.n_batch}")
            n = B // self.n_batch
            x = x[self.batch_index * n:(self.batch_index + 1) * n]
        sp = self.size["sp"]
        if sp > 1:
            S = x.shape[1]
            if S % sp:
                raise ValueError(
                    f"sp={sp} must divide sequence length {S}")
            n = S // sp
            x = x[:, self.coord["sp"] * n:(self.coord["sp"] + 1) * n]
        return x

    # -- collectives (identities on axes of size 1) ------------------------

    def copy_tp(self, x):
        return x if self.size["tp"] == 1 else comm.copy_to(
            x, self.mesh, ("tp",))

    def reduce_tp(self, x):
        return x if self.size["tp"] == 1 else comm.reduce_from(
            x, self.mesh, ("tp",))

    def gather_fsdp(self, w: torch.Tensor, spec) -> torch.Tensor:
        """ZeRO-3: the fsdp blocks of ``w`` gathered along every dim whose
        spec entry names fsdp (its minor axis, so a ``("tp", "fsdp")``
        entry comes back as this rank's tp block); the gradient
        reduce-scatters."""
        if self.size["fsdp"] == 1:
            return w
        for d, entry in enumerate(spec):
            if "fsdp" in shd.entry_axes(entry):
                w = comm.all_gather(w, self.mesh, ("fsdp",), d)
        return w

    def gather_layer(self, lp: dict) -> dict:
        if self.size["fsdp"] == 1:
            return lp
        return {k: self.gather_fsdp(w, self.layer_specs[k])
                for k, w in lp.items()}

    def data_mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The global mean from this rank's mean of its tokens: each rank
        contributes ``loss / n_data`` and gets the sum; the gradient of
        each rank's share is the sum's."""
        if self.n_data == 1:
            return loss
        return comm.reduce_from(loss * (1.0 / self.n_data), self.mesh,
                                DATA_AXES)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# Test hook, the counterpart of the JAX package's _FORCE_FLASH_INTERPRET:
# when set, attention on CUDA tensors runs the flash kernels' plain
# versions instead of the kernels.  Off by default; nothing in the package
# sets it.
_FORCE_ATTENTION_REFERENCE = False


def _attention(q, k, v, plan: _Plan, causal: bool,
               sp_mode: str = "ring") -> torch.Tensor:
    """Attention of the training path on this rank's block: ring or
    Ulysses attention over the sp group when the sequence is split (K/V
    expanded to q's heads first), else the flash ``autograd.Function``
    (its kernels on CUDA tensors, which raise for a shape outside
    ``FA.supported``; its plain versions on CPU tensors) on the local
    batch rows and heads."""
    if plan.size["sp"] > 1:
        from ..parallel.ring_attention import sp_local_attention
        fn = sp_local_attention(sp_mode)
        k, v = FA.gqa_expand(q, k, v)
        group, _ = comm.group_of(plan.mesh, ("sp",))
        return fn(q, k, v, group=group, causal=causal)
    return FA.flash_attention(q, k, v, None, causal,
                              plain=_FORCE_ATTENTION_REFERENCE)


def _attn_block(h, lp, rope, plan: _Plan, cfg: LlamaConfig,
                causal: bool) -> torch.Tensor:
    """RMSNorm -> QKV -> RoPE -> :func:`_attention` (handed grouped K/V)
    -> output projection + residual.  With heads over tp the products are
    Megatron's: the normed input enters the column-parallel ``wq/wk/wv``
    through :func:`~..parallel.comm.copy_to`, the row-parallel ``wo``'s
    partial sums leave through :func:`~..parallel.comm.reduce_from`.
    Where tp divides the heads but not the kv heads, ``wk/wv`` are whole
    on every rank: K/V are made from the replicated input, expanded to
    every head and this rank's heads kept (their gradient all-gathered
    back), as the reference expands them before its shard_map."""
    x = _rmsnorm(h, lp["attn_norm"])
    xq = plan.copy_tp(x) if plan.heads_tp else x
    q = _rope(_heads(xq, lp["wq"]), rope)
    if plan.heads_tp and not plan.kv_tp:
        k, v = FA.gqa_expand(q, *_layer_kv(x, lp, rope), heads=cfg.n_heads)
        k = comm.scatter(k, plan.mesh, ("tp",), 2)
        v = comm.scatter(v, plan.mesh, ("tp",), 2)
    else:
        k, v = _layer_kv(xq, lp, rope)
    o = _out_proj(_attention(q, k, v, plan, causal, cfg.sp_attention),
                  lp["wo"])
    return h + (plan.reduce_tp(o) if plan.heads_tp else o)


def _mlp(x2, lp, plan: _Plan):
    """The dense SwiGLU MLP, column-parallel ``w_gate/w_up`` and
    row-parallel ``w_down`` over tp."""
    return plan.reduce_tp(_dense_mlp(plan.copy_tp(x2), lp))


def _moe_mlp(h2: torch.Tensor, lp: dict, cfg: LlamaConfig,
             plan: Optional[_Plan] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Switch-MoE MLP: fp32 router logits,
    :func:`~..parallel.moe.switch_route` at ``cfg.capacity_factor``, the
    SwiGLU experts, their hidden dim over tp (row-parallel sum).  Returns
    (output ``[B, S, D]``, the layer's aux loss).  Tokens past capacity
    come back 0 (the residual carries them); the drops are not counted
    here, as in the reference.

    The tokens that route together are the reference's: over ``ep > 1``
    each rank's rows (dp·fsdp·ep) with their whole sequences, exchanged
    with the ``ep`` group by :func:`~..parallel.moe.moe_layer_local`
    (the experts ``P("ep", None, "tp")``); over one expert group the
    whole global batch (the reference's GSPMD-global ``ep=1`` branch: the
    dispatch einsum into ``[E, C, D]`` buffers, the experts as batched
    products over E, the combine einsum), gathered from every data rank.
    The output is this rank's block again."""
    from ..parallel.moe import capacity_of, moe_layer_local, switch_route
    plan = plan or _Plan(cfg, None)
    mesh, ep = plan.mesh, plan.size["ep"]
    x = comm.all_gather(h2, mesh, ("sp",), 1)              # whole sequences
    if ep == 1:
        x = comm.all_gather(x, mesh, BATCH_AXES, 0)         # the global batch
    B, S, D = x.shape
    flat = x.reshape(B * S, D)
    if ep > 1:
        def experts(w, xe):
            # every local expert at once: [E_local, n*C, D]
            xf = plan.copy_tp(xe)
            wg, wu, wd = (w[k].to(xe.dtype)
                          for k in ("w_gate", "w_up", "w_down"))
            y = torch.matmul(F.silu(torch.matmul(xf, wg))
                             * torch.matmul(xf, wu), wd)
            return plan.reduce_tp(y)

        group, _ = comm.group_of(mesh, ("ep",))
        out, aux = moe_layer_local(
            flat, lp["router"].float(), experts,
            {k: lp[k] for k in ("w_gate", "w_up", "w_down")}, group=group,
            capacity_factor=cfg.capacity_factor, batched=True)
    else:
        cap = capacity_of(flat.shape[0], cfg.n_experts, cfg.capacity_factor)
        logits = flat.float() @ lp["router"].float()
        dispatch, combine, aux, _ = switch_route(logits, cap)
        einputs = torch.einsum("tec,td->ecd", dispatch.to(flat.dtype), flat)
        eouts = _mlp(einputs, lp, plan)                   # [E, C, D]
        out = torch.einsum("tec,ecd->td", combine.to(flat.dtype), eouts)
    out = out.reshape(B, S, D)
    if ep == 1 and plan.n_batch > 1:
        n = h2.shape[0]
        out = out[plan.batch_index * n:(plan.batch_index + 1) * n]
    if plan.size["sp"] > 1:
        n = h2.shape[1]
        out = out[:, plan.coord["sp"] * n:(plan.coord["sp"] + 1) * n]
    return out, aux


def _embed(params, tokens: torch.Tensor, cfg: LlamaConfig,
           plan: _Plan) -> torch.Tensor:
    """The token embedding from this rank's rows of the table: its fsdp
    blocks gathered to its tp block, a masked lookup of the tokens in
    that block's vocab range, summed over tp."""
    table = plan.gather_fsdp(params["embed"], plan.stack_specs["embed"])
    if not plan.size["tp"] > 1:
        return _embed_lookup(table, tokens, cfg.dtype)
    rows = table.shape[0]
    t = tokens.long() - plan.coord["tp"] * rows
    inside = (t >= 0) & (t < rows)
    e = F.embedding(torch.where(inside, t, 0), table)
    e = torch.where(inside[..., None], e, 0.0).to(cfg.dtype)
    return plan.reduce_tp(e)


def _nll(logits: torch.Tensor, targets: torch.Tensor,
         plan: _Plan) -> torch.Tensor:
    """``logsumexp(logits) - logits[target]`` a position.  Over tp the
    logits are this rank's vocab columns: the row maximum is all-reduced
    (no gradient: the shift cancels in the derivative), the sum of
    exponentials and the picked logit summed over tp."""
    if not plan.size["tp"] > 1:
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, targets[..., None].long())[..., 0]
        return lse - picked
    mx = comm.all_reduce_max(logits.detach().amax(dim=-1), plan.mesh,
                             ("tp",))
    lse = torch.log(plan.reduce_tp(
        torch.exp(logits - mx[..., None]).sum(dim=-1))) + mx
    cols = logits.shape[-1]
    t = targets.long() - plan.coord["tp"] * cols
    inside = (t >= 0) & (t < cols)
    pl = logits.gather(-1, torch.where(inside, t, 0)[..., None])[..., 0]
    return lse - plan.reduce_tp(torch.where(inside, pl, 0.0))


def _forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
             plan: _Plan, causal: bool, return_hidden: bool
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward` on this rank's block of the batch."""
    B, S = tokens.shape
    dev = tokens.device
    h = _embed(params, tokens, cfg, plan)
    positions = torch.arange(S, device=dev)
    if plan.size["sp"] > 1:                  # the chunk's global positions
        positions = positions + plan.coord["sp"] * S
    rope = _rope_tables(positions.expand(B, S), cfg.rope_theta,
                        cfg.head_dim)
    names = tuple(params["layers"])
    ckpt_kw = {}
    if cfg.remat == "dots":
        ckpt_kw["context_fn"] = _dots_context()

    def layer(h, *weights):
        # An MoE layer returns (h, its aux loss); a dense one h alone.
        lp = plan.gather_layer(dict(zip(names, weights)))
        h = _attn_block(h, lp, rope, plan, cfg, causal)
        x2 = _rmsnorm(h, lp["mlp_norm"])
        if cfg.use_moe:
            mlp_out, moe_aux = _moe_mlp(x2, lp, cfg, plan)
            return h + mlp_out, moe_aux
        return h + _mlp(x2, lp, plan)

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for li in range(cfg.n_layers):
        weights = _layer(params["layers"], li).values()
        if cfg.remat:
            out = checkpoint(layer, h, *weights, use_reentrant=False,
                             **ckpt_kw)
        else:
            out = layer(h, *weights)
        if cfg.use_moe:
            h, moe_aux = out
            aux = aux + moe_aux
        else:
            h = out
    h = _rmsnorm(h, params["final_norm"])
    if return_hidden:
        return h, aux
    lm_head = plan.gather_fsdp(params["lm_head"],
                               plan.stack_specs["lm_head"])
    return torch.matmul(plan.copy_tp(h), lm_head).float(), aux


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
            mesh=None, causal: bool = True, return_hidden: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Logits for next-token prediction: tokens ``[B, S]`` int ->
    (logits ``[B, S, V]`` fp32, aux: the MoE load-balancing loss summed
    over layers, 0 for a dense config).  With ``return_hidden`` the final
    normed hidden states
    ``[B, S, D]`` come back instead of logits (the blockwise loss applies
    the lm_head itself, a vocab block at a time).  With ``cfg.remat`` each
    layer runs under ``torch.utils.checkpoint``: ``True`` keeps only the
    layer inputs, ``"dots"`` also the outputs of the weight products
    (:func:`_dots_context`).

    With ``mesh=``, ``params`` are this rank's blocks, ``tokens`` the
    global batch (the same on every rank), and what comes back is this
    rank's block: its rows (dp·fsdp·ep), its sequence chunk (sp) and its
    vocab columns (tp); aux is this rank's routing groups' sum."""
    _check_train_cfg(cfg)
    plan = _Plan(cfg, mesh)
    return _forward(params, plan.local_batch(tokens), cfg, plan, causal,
                    return_hidden)


def _use_blockwise_ce(cfg: LlamaConfig, mesh) -> bool:
    """The blockwise loss runs on one card and over dp/fsdp; tp shards the
    lm_head's columns and sp/pp restructure the forward, so they take the
    dense loss, as in the reference."""
    if not cfg.blockwise_ce:
        return False
    sizes = shd.axis_sizes(mesh)
    return all(sizes.get(a, 1) == 1 for a in ("tp", "sp", "pp"))


def loss_fn(params: dict, batch: dict, cfg: LlamaConfig, *,
            mesh=None) -> torch.Tensor:
    """Causal LM loss, batch = ``{"tokens": [B, S+1] int}``: the mean over
    positions of ``logsumexp(logits) - logits[target]``, the JAX package's
    form (the log-probabilities are never materialised).  With
    ``cfg.blockwise_ce`` the logits are not materialised either:
    :func:`~horovod_tpu_torch.ops.losses.blockwise_cross_entropy` takes
    the hidden states and the lm_head a vocab block at a time, its block
    logits in fp32 (the dense path rounds its logits to the model's
    dtype first).  The MoE load-balancing loss is added times
    ``cfg.moe_aux_weight``.

    With ``mesh=`` (``params`` this rank's blocks, ``batch`` the global
    batch on every rank), every rank returns the loss of the global batch
    (the mean over it; the aux averaged over the routing groups), and its
    backward gives each rank its share of every gradient, which
    :func:`reduce_gradients` sums."""
    _check_train_cfg(cfg)
    plan = _Plan(cfg, mesh)
    tokens = batch["tokens"]
    inputs = plan.local_batch(tokens[:, :-1])
    targets = plan.local_batch(tokens[:, 1:])
    if _use_blockwise_ce(cfg, mesh):
        from ..ops.losses import blockwise_cross_entropy
        h, aux = _forward(params, inputs, cfg, plan, True, True)
        B, S, D = h.shape
        lm_head = plan.gather_fsdp(params["lm_head"],
                                   plan.stack_specs["lm_head"])
        nll = blockwise_cross_entropy(h.reshape(B * S, D), lm_head,
                                      targets.reshape(-1))
        return plan.data_mean(nll.mean() + cfg.moe_aux_weight * aux)
    logits, aux = _forward(params, inputs, cfg, plan, True, False)
    return plan.data_mean(_nll(logits, targets, plan).mean()
                          + cfg.moe_aux_weight * aux)


def trainable(params: dict) -> list[torch.Tensor]:
    """The optimizer's parameters: ``embed``, ``final_norm``, ``lm_head``
    and, for each stacked layer weight, one leaf per layer.

    A per-layer leaf is ``stack[i].detach().requires_grad_()``: it shares
    storage with the stack, so ``params`` keeps the JAX layout, each
    layer's gradient lands in its own leaf, and the optimizer's in-place
    step updates the stack.  (Autograd through ``stack[i]`` of one leaf
    would give every layer a stack-sized gradient to add in.)  The leaves
    are what :func:`forward` then uses for the layer weights.  On a mesh
    they are this rank's blocks, so the optimizer's state is sharded as
    the parameters are."""
    leaves = []
    for stack in params["layers"].values():
        if not hasattr(stack, "_layer_leaves"):    # one set per stack
            stack._layer_leaves = [stack[i].detach().requires_grad_()
                                   for i in range(stack.shape[0])]
        leaves.extend(stack._layer_leaves)
    for name in ("embed", "final_norm", "lm_head"):
        leaves.append(params[name].requires_grad_())
    return leaves


def named_trainable(params: dict) -> list[tuple[str, torch.Tensor]]:
    """:func:`trainable`'s leaves with names that are the same in every
    process: ``layers.<weight>.<layer>`` (``layers.wq.3``; nine stacked
    weights a layer, ten with an MoE config's router), then ``embed``,
    ``final_norm`` and ``lm_head``.
    ``DistributedOptimizer`` negotiates each gradient by its name, and
    ``broadcast_parameters`` takes the pairs as they are."""
    names = [f"layers.{k}.{i}" for k, stack in params["layers"].items()
             for i in range(stack.shape[0])]
    names += ["embed", "final_norm", "lm_head"]
    return list(zip(names, trainable(params)))


def trainable_specs(params: dict, cfg: LlamaConfig, mesh) -> list[tuple]:
    """The spec of each of :func:`trainable`'s leaves on ``mesh``, in its
    order (a layer leaf's is its stack's without the stage dim)."""
    specs = param_shardings(cfg, mesh)
    out = [specs["layers"][k][1:] for k, stack in params["layers"].items()
           for _ in range(stack.shape[0])]
    return out + [specs[k] for k in ("embed", "final_norm", "lm_head")]


def reduce_gradients(params: dict, cfg: LlamaConfig, mesh) -> None:
    """Sum each of :func:`trainable`'s gradients over the data axes (dp,
    fsdp, ep, sp) of size > 1 that its spec does not name: the ranks
    along them hold the same block of the parameter and their shares of
    its gradient.  (An fsdp block's gradient was reduce-scattered by its
    gather, an expert's summed by the token exchange, and a parameter
    over tp gets its whole gradient on every tp rank.)  One all-reduce a
    set of axes and dtype, in :func:`trainable`'s order on every rank.
    Nothing on a mesh whose data axes all have size 1."""
    plan = _Plan(cfg, mesh)
    if plan.n_data == 1:
        return
    buckets: dict = {}
    for leaf, spec in zip(trainable(params),
                          trainable_specs(params, cfg, mesh)):
        named = shd.spec_axes(spec)
        axes = tuple(a for a in DATA_AXES
                     if plan.size[a] > 1 and a not in named)
        if axes and leaf.grad is not None:
            buckets.setdefault((axes, leaf.grad.dtype), []).append(leaf.grad)
    for (axes, _), grads in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        comm.all_reduce_sum_(flat, mesh, axes)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer, *,
                    mesh=None) -> Callable[[dict, dict], torch.Tensor]:
    """A training step ``step(params, batch) -> loss``: zero the gradients,
    :func:`loss_fn` forward and backward, ``optimizer.step()``.

    ``optimizer`` is built over :func:`trainable` (params), e.g.
    ``torch.optim.Adam(trainable(params), lr, fused=True)``, whose update
    is optax.adam's.  Parameters are updated in place, as the JAX step
    donates its parameter buffers.  The loss comes back as a 0-d tensor on
    the parameters' device; the step makes no host sync.

    With ``mesh=`` (a :func:`~..parallel.build_mesh` mesh, ``pp = 1``) the
    parameters and the optimizer's state are this rank's blocks
    (:func:`init_params` or :func:`shard_params` with the mesh), ``batch``
    is the global batch, and :func:`reduce_gradients` runs between the
    backward and the update; every rank returns the global loss.  The
    reference's mesh step takes a plain optax ``tx`` too, no
    ``DistributedOptimizer``."""
    _check_train_cfg(cfg)
    _Plan(cfg, mesh)

    def step(params: dict, batch: dict) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg, mesh=mesh)
        loss.backward()
        reduce_gradients(params, cfg, mesh)
        optimizer.step()
        return loss.detach()

    return step
