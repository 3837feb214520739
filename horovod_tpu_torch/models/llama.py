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
``DeviceMesh``): every rank holds its block of each parameter under the
JAX package's logical rules (:func:`param_shardings`,
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
- ``pp`` holds the layers stage-resident (rank ``s`` of ``pp`` keeps
  layers ``s L/pp .. (s+1) L/pp - 1``), the other axes inside a stage as
  above; the step runs the 1F1B schedule (default) or GPipe under
  autograd (:mod:`..parallel.pipeline`), over ``cfg.pp_microbatches``
  microbatches (:func:`_pick_microbatches`);
- each rank's loss is its share of the global mean, and each gradient is
  summed over the data axes its parameter is replicated along
  (:func:`reduce_gradients`).

With every axis of size 1 the mesh path is the plain path: the same ops
in the same order, no collective.

Generation and the serving steps take ``mesh=`` too (dp, fsdp and tp;
``generate`` also pp): the batch rows over dp·fsdp, the heads over tp
with row-parallel ``wo`` and ``w_down`` (optionally as the fused chunked
matmul and reduce-scatter, ``cfg.decode_tp_overlap``), the KV cache a
rank's rows and kv heads, the vocab-parallel logits gathered before the
token is picked, so every rank picks the same token; on pp the layers
stay stage-resident and the hidden state goes stage to stage, the last
stage's to every rank.

Still raising ``NotImplementedError``, with the JAX package's messages:
MoE configs in ``generate`` and the serving steps, ``sp`` and ``ep`` in
``generate`` and serving, ``pp`` in serving, and the blockwise loss in the
1F1B step.
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
from ..parallel.mesh import AXES


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
    # Microbatches of the pipeline on pp > 1 meshes (None: the most
    # M <= 2 pp that divides the local batch, _pick_microbatches).  The
    # bubble is (pp - 1) / (M + pp - 1) for both schedules.
    pp_microbatches: Optional[int] = None
    # The tp row-parallel projections of generation (wo, w_down) as the
    # fused chunked matmul + reduce-scatter (ops.sched
    # matmul_reducescatter).  None follows the runtime's sched_mode knob
    # (on when "decomposed").  Bitwise the plain all-reduce at tp = 2.
    decode_tp_overlap: Optional[bool] = None

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


def _serving_mesh(mesh) -> None:
    """The serving steps and the engine run on dp/fsdp/tp meshes, with
    the JAX package's serving engine's refusal of the other axes."""
    sizes = shd.axis_sizes(mesh)
    for a in ("sp", "ep", "pp"):
        if sizes.get(a, 1) > 1:
            raise NotImplementedError(
                "serving supports dp/fsdp/tp meshes; "
                f"{a} is a training-path axis here")


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
        # stack (7B: 1.4 GB per layer of w_gate at most).  On pp every
        # layer is drawn, the other stages' thrown away.
        out = torch.empty(plan.local_shape(shape, spec), dtype=cfg.dtype,
                          device=dev)
        s = 1.0 / math.sqrt(fan_in)
        lo = (shd.block_slices(shape, spec, plan.size, plan.coord)[0].start
              if stacked and not plan.trivial else 0)
        for i in range(shape[0] if stacked else 1):
            full = shape[1:] if stacked else shape
            draw = torch.randn(full, generator=generator, device=dev,
                               dtype=torch.float32)
            if stacked and not 0 <= i - lo < out.shape[0]:
                continue
            part = out[i - lo] if stacked else out
            part.copy_(plan.block(draw * s, spec[1:] if stacked else spec))
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


def _decode_tp_overlap_chunks(cfg: LlamaConfig, tp: int) -> int:
    """Chunks of the fused matmul + reduce-scatter row-parallel
    projections of generation (0: the plain all-reduce).
    ``cfg.decode_tp_overlap`` wins when set; None follows the runtime's
    ``sched_mode`` (on when "decomposed", ``sched_chunks`` chunks, at
    least 2)."""
    if tp <= 1:
        return 0
    state = context.global_state()
    gcfg = state.config if state.initialized else None
    enabled = cfg.decode_tp_overlap
    if enabled is None:
        enabled = gcfg is not None and gcfg.sched_mode == "decomposed"
    if not enabled:
        return 0
    return max(2, gcfg.sched_chunks if gcfg is not None else 2)


def _row_parallel(cfg: LlamaConfig, plan: "_Plan") -> Callable:
    """``proj(x, w, sharded)``: ``x @ w``, summed over tp when ``w``'s
    rows are this rank's tp block (``wo`` with the heads over tp,
    ``w_down``): an all-reduce, or the fused chunked matmul +
    reduce-scatter (:func:`_decode_tp_overlap_chunks`)."""
    chunks = _decode_tp_overlap_chunks(cfg, plan.size["tp"])
    if chunks:
        from ..ops.sched import matmul_reducescatter
        group = comm.group_of(plan.mesh, ("tp",))[0]

    def proj(x, w, sharded: bool):
        if sharded and chunks:
            return matmul_reducescatter(x, w, group, chunks=chunks)
        y = torch.matmul(x, w)
        return plan.reduce_tp(y) if sharded else y

    return proj


def _gen_layer(h, lp, rope, plan: "_Plan", attend: Callable,
               proj: Callable) -> torch.Tensor:
    """One layer of generation and the serving steps on this rank's rows
    and heads: ``attend(q, k, v)`` writes the cache and attends (the q
    heads of the rank, the kv heads they read); the row-parallel
    ``wo`` and ``w_down`` through ``proj`` (:func:`_row_parallel`).  On a
    trivial plan, the plain path's ops."""
    lp = plan.gather_layer(lp)
    x = _rmsnorm_impl(h, lp["attn_norm"])
    q = _rope(_heads(x, lp["wq"]), rope)
    k, v = _layer_kv(x, plan.kv_weights(lp), rope)
    attn = attend(q, k, v)
    wo = lp["wo"]
    h = h + proj(attn.reshape(*attn.shape[:-2], -1),
                 wo.reshape(-1, wo.shape[-1]), plan.heads_tp)
    x2 = _rmsnorm_impl(h, lp["mlp_norm"])
    return h + proj(_swiglu_hidden(x2, lp), lp["w_down"],
                    plan.size["tp"] > 1)


def _gen_logits(params, h_last: torch.Tensor, plan: "_Plan",
                n_rows: int) -> torch.Tensor:
    """fp32 logits ``[n_rows, V]`` (or ``[n_rows, S, V]``) on every rank:
    this rank's vocab columns and rows gathered over tp and dp·fsdp."""
    lm_head = plan.gather_fsdp(params["lm_head"],
                               plan.stack_specs["lm_head"])
    logits = torch.matmul(_rmsnorm_impl(h_last, params["final_norm"]),
                          lm_head).float()
    logits = comm.gather_tensor(logits, plan.mesh, ("tp",), logits.dim() - 1)
    return plan.gather_rows(logits, n_rows)


def _local_layers(cfg: LlamaConfig, plan: "_Plan") -> int:
    """The layers this rank runs: the config's, its stage's share on
    pp (the first of the stack, which may hold more)."""
    return cfg.n_layers // plan.n_stages


@torch.no_grad()
def prefill_step(params, tokens: torch.Tensor, cfg: LlamaConfig, *,
                 mesh=None, last_pos: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prompt prefill for the serving engine.

    tokens ``[B, P]`` int → (logits ``[B, V]`` fp32 at ``last_pos``,
    per-layer K ``[L, B, P, KV, Dh]``, per-layer V).  ``last_pos`` ``[B]``
    selects the logits position per row (bucketed prompts are
    right-padded); None means ``P - 1``.  Causality makes a padded tail
    inert for every real position.

    With ``mesh=`` (dp, fsdp, tp): ``params`` are this rank's blocks; the
    rows split over dp·fsdp when they divide (else every rank runs every
    row), K/V come back for every row and this rank's kv heads, the
    logits whole on every rank."""
    _no_moe(cfg)
    _serving_mesh(mesh)
    plan = _Plan(cfg, mesh)
    B, P = tokens.shape
    dev = tokens.device
    scale = 1.0 / math.sqrt(cfg.head_dim)
    rows = plan.rows(tokens)
    Bl = rows.shape[0]
    h = _embed(params, rows, cfg, plan)
    positions = torch.arange(P, device=dev).expand(Bl, P)
    rope = _rope_tables(positions, cfg.rope_theta, cfg.head_dim)
    mask = torch.ones(P, P, dtype=torch.bool, device=dev).tril()
    proj = _row_parallel(cfg, plan)
    ks, vs = [], []

    def attend(q, k, v):
        ks.append(k)
        vs.append(v)
        return _cached_attend(q, k, v, mask, scale)

    for li in range(_local_layers(cfg, plan)):
        h = _gen_layer(h, _layer(params["layers"], li), rope, plan, attend,
                       proj)
    if last_pos is None:
        h_last = h[:, -1]
    else:
        h_last = h[torch.arange(Bl, device=dev), plan.rows(last_pos).long()]
    return (_gen_logits(params, h_last, plan, B),
            plan.gather_rows(torch.stack(ks), B, 1),
            plan.gather_rows(torch.stack(vs), B, 1))


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
    unmasked.  Returns (logits ``[B, V]`` fp32, k_pool, v_pool).

    With ``mesh=`` (dp, fsdp, tp): the pools hold this rank's kv heads
    and every block; the rows split over dp·fsdp when they divide, each
    layer's fresh K/V gathered over dp·fsdp before the write, so the
    pools stay identical across dp·fsdp; the attention runs on the rank's
    rows and heads (the kernel too); the logits come back whole."""
    from ..serving.kv_pager import gather_blocks

    _no_moe(cfg)
    _serving_mesh(mesh)
    plan = _Plan(cfg, mesh)
    B = tok.shape[0]
    _, _, BS, _, _ = k_pool.shape
    dev = tok.device
    scale = 1.0 / math.sqrt(cfg.head_dim)
    T = tables.shape[1] * BS
    tok_l, pos_l, tables_l = (plan.rows(x) for x in (tok, positions, tables))
    h = _embed(params, tok_l[:, None], cfg, plan)
    rope = _rope_tables(pos_l[:, None], cfg.rope_theta, cfg.head_dim)
    pos = positions.long()
    blk = tables[torch.arange(B, device=dev), pos // BS].long()
    off = pos % BS
    mask = (torch.arange(T, device=dev)[None, :]
            <= pos_l.long()[:, None])[:, None, :]
    lengths = (pos_l + 1).to(torch.int32)
    proj = _row_parallel(cfg, plan)
    for li in range(_local_layers(cfg, plan)):
        def attend(q, k1, v1, li=li):                      # [b, 1, KV, Dh]
            k_pool[li, blk, off] = plan.gather_rows(k1, B)[:, 0]
            v_pool[li, blk, off] = plan.gather_rows(v1, B)[:, 0]
            if use_flash:
                return FA.paged_attention(q[:, 0], k_pool[li], v_pool[li],
                                          tables_l, lengths,
                                          scale=scale)[:, None]
            keys = gather_blocks(k_pool[li], tables_l)     # [b, T, KV, Dh]
            vals = gather_blocks(v_pool[li], tables_l)
            return _cached_attend(q, keys, vals, mask, scale)

        h = _gen_layer(h, _layer(params["layers"], li), rope, plan, attend,
                       proj)
    return _gen_logits(params, h[:, 0], plan, B), k_pool, v_pool


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
    v_pool).  ``mesh=`` as in :func:`decode_step_paged`."""
    from ..serving.kv_pager import gather_blocks

    _no_moe(cfg)
    _serving_mesh(mesh)
    plan = _Plan(cfg, mesh)
    B, S = tok.shape
    BS = k_pool.shape[2]
    dev = tok.device
    scale = 1.0 / math.sqrt(cfg.head_dim)
    T = tables.shape[1] * BS
    tok_l, pos_l, tables_l = (plan.rows(x) for x in (tok, positions, tables))
    h = _embed(params, tok_l, cfg, plan)
    rope = _rope_tables(pos_l, cfg.rope_theta, cfg.head_dim)
    pos = positions.long()
    mask = (torch.arange(T, device=dev)[None, None, :]
            <= pos_l.long()[:, :, None])
    col = torch.where(valid, pos // BS, 0)
    blk = torch.where(valid, tables.long().gather(1, col), 0)      # [B, S]
    off = torch.where(valid, pos % BS, 0)
    proj = _row_parallel(cfg, plan)
    for li in range(_local_layers(cfg, plan)):
        def attend(q, k1, v1, li=li):                      # [b, S, KV, Dh]
            k_pool[li, blk, off] = plan.gather_rows(k1, B)
            v_pool[li, blk, off] = plan.gather_rows(v1, B)
            keys = gather_blocks(k_pool[li], tables_l)     # [b, T, KV, Dh]
            vals = gather_blocks(v_pool[li], tables_l)
            return _cached_attend(q, keys, vals, mask, scale)

        h = _gen_layer(h, _layer(params["layers"], li), rope, plan, attend,
                       proj)
    return _gen_logits(params, h, plan, B), k_pool, v_pool


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
    at its position in place and attends over the cache.  MoE configs
    raise ``NotImplementedError``, as in the JAX package.

    With ``mesh=`` (dp, fsdp, tp, pp; ``params`` this rank's blocks,
    ``prompt`` the whole batch on every rank): the rows split over
    dp·fsdp when they divide, the heads over tp (row-parallel ``wo`` and
    ``w_down``), the cache is this rank's ``[L/pp, B/(dp·fsdp), T,
    KV/tp, Dh]``; on pp the layers stay stage-resident, the hidden state
    goes stage to stage and the last stage's to every rank
    (:meth:`_Plan.pp_chain`); the vocab-parallel logits are gathered
    before the pick, so every rank picks the same token (``generator`` in
    the same state on every rank for sampling).  sp and ep raise, as in
    the JAX package."""
    if cfg.use_moe:
        raise NotImplementedError("generate does not support MoE configs")
    sizes = shd.axis_sizes(mesh)
    if any(sizes.get(a, 1) > 1 for a in ("sp", "ep")):
        raise NotImplementedError(
            "generate supports dp/fsdp/tp/pp meshes; sp/ep are "
            "training-path axes")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    plan = _Plan(cfg, mesh)
    B, P = prompt.shape
    T = P + max_new_tokens
    dev = prompt.device
    Dh = cfg.head_dim
    L = _local_layers(cfg, plan)
    scale = 1.0 / math.sqrt(Dh)
    rows = plan.rows(prompt)
    Bl = rows.shape[0]
    cache_k = torch.zeros((L, Bl, T, plan.kv_local, Dh), dtype=cfg.dtype,
                          device=dev)
    cache_v = torch.zeros_like(cache_k)
    proj = _row_parallel(cfg, plan)

    def run(h, rope, attend_at):
        def stage(h):
            for li in range(L):
                h = _gen_layer(h, _layer(params["layers"], li), rope, plan,
                               functools.partial(attend_at, li), proj)
            return h
        return plan.pp_chain(stage, h)

    # ---- prefill: attention over the P prompt keys, cache written ------
    mask = torch.ones(P, P, dtype=torch.bool, device=dev).tril()

    def prefill_attend(li, q, k, v):
        cache_k[li, :, :P] = k
        cache_v[li, :, :P] = v
        return _cached_attend(q, k, v, mask, scale)

    h = run(_embed(params, rows, cfg, plan),
            _rope_tables(torch.arange(P, device=dev).expand(Bl, P),
                         cfg.rope_theta, Dh), prefill_attend)
    tok = _pick_token(_gen_logits(params, h[:, -1], plan, B), generator,
                      temperature, prompt.dtype)
    new = [tok]

    # ---- decode: one token a tick, appended to the cache ---------------
    steps = torch.arange(T, device=dev)
    for pos in range(P, T - 1):
        mask = (steps <= pos)[None, :]                           # [1, T]

        def decode_attend(li, q, k1, v1, pos=pos, mask=mask):
            cache_k[li, :, pos] = k1[:, 0]
            cache_v[li, :, pos] = v1[:, 0]
            return _cached_attend(q, cache_k[li], cache_v[li], mask, scale)

        h = run(_embed(params, plan.rows(tok)[:, None], cfg, plan),
                _rope_tables(torch.full((Bl, 1), pos, device=dev),
                             cfg.rope_theta, Dh), decode_attend)
        tok = _pick_token(_gen_logits(params, h[:, 0], plan, B), generator,
                          temperature, prompt.dtype)
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
    is issued, so the mesh path runs the plain path's ops.

    ``coord`` stands in for the mesh's coordinate of this rank: with a
    dict of axis sizes as ``mesh`` (``{"pp": 2}``) it makes the plan of
    one stage of a pipeline whose every other axis has size 1, which
    needs no process group (the one-process pipeline driver)."""

    def __init__(self, cfg: LlamaConfig, mesh, coord: Optional[dict] = None):
        sizes = shd.axis_sizes(mesh)
        self.mesh = mesh
        self.size = {a: sizes.get(a, 1) for a in AXES}
        self.trivial = all(n == 1 for n in self.size.values())
        if coord is not None:
            self.coord = {a: coord.get(a, 0) for a in AXES}
        else:
            self.coord = (shd.coordinate(mesh) if not self.trivial
                          else {a: 0 for a in AXES})
        pp, tp = self.size["pp"], self.size["tp"]
        self.stage, self.n_stages = self.coord["pp"], pp
        if pp > 1:
            if cfg.n_layers % pp:
                raise ValueError(
                    f"pp={pp} must divide n_layers={cfg.n_layers} evenly")
            if cfg.n_heads % tp or cfg.n_kv_heads % tp:
                raise ValueError(
                    f"tp={tp} must divide n_heads={cfg.n_heads} and "
                    f"n_kv_heads={cfg.n_kv_heads}")
        self.stack_specs = param_shardings(cfg, mesh)
        self.layer_specs = {k: v[1:]
                            for k, v in self.stack_specs["layers"].items()}
        rules = shard_rules(cfg, mesh)
        tp_of = (lambda dim: tp > 1 and "tp" in
                 shd.entry_axes(shd.spec_for((dim,), rules)[0]))
        self.heads_tp, self.kv_tp = tp_of("heads"), tp_of("kv_heads")
        self.n_batch = math.prod(self.size[a] for a in BATCH_AXES)
        self.n_data = self.n_batch * self.size["sp"]
        self.batch_index = 0
        for a in BATCH_AXES:
            self.batch_index = self.batch_index * self.size[a] + self.coord[a]
        # Generation: the kv heads of the rank's wk/wv (all of them where
        # tp divides the heads but not the kv heads) that its q heads
        # read, a contiguous range.
        H, KV = cfg.n_heads, cfg.n_kv_heads
        if self.heads_tp and not self.kv_tp:
            hl, rep, c = H // tp, H // KV, self.coord["tp"]
            self.kv_range = (c * hl // rep, ((c + 1) * hl - 1) // rep + 1)
        else:
            self.kv_range = (0, KV // tp if self.kv_tp else KV)
        self.kv_local = self.kv_range[1] - self.kv_range[0]
        # Generation's rows split over dp·fsdp (ep and sp are refused).
        self.n_rows = self.size["dp"] * self.size["fsdp"]
        self.row_index = self.coord["dp"] * self.size["fsdp"] \
            + self.coord["fsdp"]

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

    # -- the pipeline and generation ---------------------------------------

    def pp_group(self):
        return comm.group_of(self.mesh, ("pp",))[0]

    def pp_chain(self, stage_fn, h: torch.Tensor) -> torch.Tensor:
        """Generation's stage-resident layers: stage after stage, the last
        stage's output on every stage (no autograd)."""
        if self.n_stages == 1:
            return stage_fn(h)
        from ..parallel.pipeline import pipeline_chain
        return pipeline_chain(stage_fn, h, group=self.pp_group())

    def split_rows(self, n: int) -> bool:
        """Whether generation splits ``n`` rows over dp·fsdp (else every
        rank computes every row)."""
        return self.n_rows > 1 and n % self.n_rows == 0

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``'s rows over dp·fsdp, or ``x``."""
        if not self.split_rows(x.shape[0]):
            return x
        n = x.shape[0] // self.n_rows
        return x[self.row_index * n:(self.row_index + 1) * n]

    def gather_rows(self, x: torch.Tensor, n: int,
                    dim: int = 0) -> torch.Tensor:
        """Every rank's rows of ``x`` (``n`` in all, along ``dim``) back
        in row order."""
        if not self.split_rows(n):
            return x
        return comm.gather_tensor(x, self.mesh, ("dp", "fsdp"), dim)

    def kv_weights(self, lp: dict) -> dict:
        lo, hi = self.kv_range
        if (lo, hi) == (0, lp["wk"].shape[1]):
            return lp
        return {**lp, "wk": lp["wk"][:, lo:hi], "wv": lp["wv"][:, lo:hi]}


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
    batch rows and heads.  A head dim past ``FA.FLASH_MAX_HEAD_DIM`` runs
    dense attention on either device, decided from the shape alone, as
    the JAX package's ``_attention`` does where no Pallas kernel takes it
    (``horovod_tpu/models/llama.py:417``)."""
    if plan.size["sp"] > 1:
        from ..parallel.ring_attention import sp_local_attention
        fn = sp_local_attention(sp_mode)
        k, v = FA.gqa_expand(q, k, v)
        group, _ = comm.group_of(plan.mesh, ("sp",))
        return fn(q, k, v, group=group, causal=causal)
    if q.shape[-1] > FA.FLASH_MAX_HEAD_DIM:
        return FA.dense_attention(q, k, v, 1.0 / math.sqrt(q.shape[-1]),
                                  causal)
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
             plan: Optional[_Plan] = None, local: bool = False
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
    The output is this rank's block again.  With ``local`` (the
    pipeline's stage body, the reference's ``_pp_machinery``) the tokens
    are this rank's alone, its rows and sequence chunk, through
    :func:`~..parallel.moe.moe_layer_local` over the ``ep`` group (no
    exchange at ``ep = 1``)."""
    from ..parallel.moe import (ONE_RANK, capacity_of, moe_layer_local,
                                switch_route)
    plan = plan or _Plan(cfg, None)
    mesh, ep = plan.mesh, plan.size["ep"]
    if local:
        x = h2
    else:
        x = comm.all_gather(h2, mesh, ("sp",), 1)          # whole sequences
        if ep == 1:
            x = comm.all_gather(x, mesh, BATCH_AXES, 0)     # the global batch
    B, S, D = x.shape
    flat = x.reshape(B * S, D)
    if ep > 1 or local:
        def experts(w, xe):
            # every local expert at once: [E_local, n*C, D]
            xf = plan.copy_tp(xe)
            wg, wu, wd = (w[k].to(xe.dtype)
                          for k in ("w_gate", "w_up", "w_down"))
            y = torch.matmul(F.silu(torch.matmul(xf, wg))
                             * torch.matmul(xf, wu), wd)
            return plan.reduce_tp(y)

        group = comm.group_of(mesh, ("ep",))[0] if ep > 1 else ONE_RANK
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
    if local:
        return out, aux
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


def _positions(S: int, plan: _Plan, dev) -> torch.Tensor:
    """Positions ``[S]`` of this rank's chunk of the sequence."""
    positions = torch.arange(S, device=dev)
    if plan.size["sp"] > 1:                  # the chunk's global positions
        positions = positions + plan.coord["sp"] * S
    return positions


def _stack_fn(params: dict, cfg: LlamaConfig, plan: _Plan, rope,
              causal: bool) -> Callable:
    """The rank's resident layers (all of them; its stage's on pp) as
    ``h -> (h, aux)``, each layer under ``cfg.remat``'s recompute; on pp
    the stage body of the reference's ``_pp_machinery`` (its MoE routes
    the rank's own tokens)."""
    names = tuple(params["layers"])
    ckpt_kw = {}
    if cfg.remat == "dots":
        ckpt_kw["context_fn"] = _dots_context()
    local_moe = plan.n_stages > 1

    def layer(h, *weights):
        # An MoE layer returns (h, its aux loss); a dense one h alone.
        lp = plan.gather_layer(dict(zip(names, weights)))
        h = _attn_block(h, lp, rope, plan, cfg, causal)
        x2 = _rmsnorm(h, lp["mlp_norm"])
        if cfg.use_moe:
            mlp_out, moe_aux = _moe_mlp(x2, lp, cfg, plan, local=local_moe)
            return h + mlp_out, moe_aux
        return h + _mlp(x2, lp, plan)

    def run(h):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for li in range(_local_layers(cfg, plan)):
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
        return h, aux

    return run


def _pick_microbatches(batch: int, sizes, requested: Optional[int] = None
                       ) -> int:
    """Microbatches of the pipeline: ``requested`` (cfg.pp_microbatches)
    when set, else the most ``M <= 2 pp`` that divides the local batch
    ``batch / (dp·fsdp·ep)``, as in the reference."""
    sizes = shd.axis_sizes(sizes)
    pp = sizes.get("pp", 1)
    df = sizes.get("dp", 1) * sizes.get("fsdp", 1) * sizes.get("ep", 1)
    if batch % df:
        raise ValueError(
            f"global batch {batch} must divide over dp*fsdp*ep = {df}")
    local = batch // df
    if requested is not None:
        if requested < 1 or local % requested:
            raise ValueError(
                f"pp_microbatches={requested} must divide the local batch "
                f"{local} (= global {batch} / dp*fsdp*ep {df})")
        return requested
    for m in range(min(2 * pp, local), 0, -1):
        if local % m == 0:
            return m
    return 1


def _gpipe(h: torch.Tensor, params: dict, cfg: LlamaConfig, plan: _Plan,
           causal: bool, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer stack on pp: the GPipe schedule over the rank's stage
    (:func:`~..parallel.pipeline.pipeline_apply_local`), microbatch ``m``
    the local rows ``m mb .. (m+1) mb - 1``; the last stage's outputs and
    the aux (summed over the stages, over M) on every rank."""
    from ..parallel.pipeline import pipeline_apply_local
    B, S, D = h.shape
    M = _pick_microbatches(batch, plan.size, cfg.pp_microbatches)
    mb = B // M
    rope = _rope_tables(_positions(S, plan, h.device).expand(mb, S),
                        cfg.rope_theta, cfg.head_dim)
    out, aux = pipeline_apply_local(
        _stack_fn(params, cfg, plan, rope, causal), h.reshape(M, mb, S, D),
        group=plan.pp_group(), with_aux=True)
    return out.reshape(B, S, D), aux


def _forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
             plan: _Plan, causal: bool, return_hidden: bool,
             batch: Optional[int] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward` on this rank's block of the batch (``batch`` rows
    in all)."""
    B, S = tokens.shape
    h = _embed(params, tokens, cfg, plan)
    if plan.n_stages > 1:
        if return_hidden:
            raise NotImplementedError("blockwise CE requires a pp=1 mesh")
        h, aux = _gpipe(h, params, cfg, plan, causal, batch or B)
    else:
        rope = _rope_tables(_positions(S, plan, tokens.device).expand(B, S),
                            cfg.rope_theta, cfg.head_dim)
        h, aux = _stack_fn(params, cfg, plan, rope, causal)(h)
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
    vocab columns (tp); aux is this rank's routing groups' sum.  On pp
    the layers run the GPipe schedule over the rank's stage
    (:func:`_gpipe`) and every stage gets the last stage's outputs; the
    backward of a loss computed from them is that of one loss (the
    embedding's gradient on stage 0, summed over pp by
    :func:`reduce_gradients`)."""
    _check_train_cfg(cfg)
    plan = _Plan(cfg, mesh)
    return _forward(params, plan.local_batch(tokens), cfg, plan, causal,
                    return_hidden, tokens.shape[0])


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
    logits, aux = _forward(params, inputs, cfg, plan, True, False,
                           tokens.shape[0])
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
    On pp (after the GPipe forward's backward) the embedding's gradient,
    which only stage 0's inputs carry, is summed over pp first, so every
    stage updates the replicated embedding alike.  Nothing on a mesh
    whose data axes all have size 1 and whose pp is 1."""
    _reduce_gradients(params, cfg, _Plan(cfg, mesh), pp_embed=True)


def _reduce_gradients(params: dict, cfg: LlamaConfig, plan: _Plan, *,
                      pp_embed: bool) -> None:
    mesh = plan.mesh
    if pp_embed and plan.n_stages > 1:
        e = params["embed"]
        if e.grad is None:
            e.grad = torch.zeros_like(e)
        comm.all_reduce_sum_(e.grad, mesh, ("pp",))
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


# ---------------------------------------------------------------------------
# the 1F1B step
# ---------------------------------------------------------------------------

def _stage_leaves(params: dict) -> list:
    """The rank's per-layer optimizer leaves (its stage's on pp), in
    :func:`trainable`'s order."""
    trainable(params)
    return [leaf for stack in params["layers"].values()
            for leaf in stack._layer_leaves]


def _pp_work(params: dict, batch: dict, cfg: LlamaConfig,
             plan: _Plan, *, embed: bool = True) -> dict:
    """What the 1F1B schedule needs on this rank: the embedding of its
    rows (under autograd; its gradient comes from the returned input
    cotangent), the microbatches, the stage body, its leaves, and the
    loss head over the final norm and the lm_head (fsdp-gathered once a
    step) for microbatch ``m``'s targets.  ``embed=False`` leaves the
    embedding out (``h`` and ``mbs`` None): the one-process driver's
    stages after the first take their input from stage 0's."""
    tokens = batch["tokens"]
    inputs = plan.local_batch(tokens[:, :-1])
    targets = plan.local_batch(tokens[:, 1:])
    B, S = inputs.shape
    M = _pick_microbatches(tokens.shape[0], plan.size, cfg.pp_microbatches)
    mb = B // M
    h = _embed(params, inputs, cfg, plan) if embed else None
    rope = _rope_tables(
        _positions(S, plan, params["embed"].device).expand(mb, S),
        cfg.rope_theta, cfg.head_dim)
    with torch.no_grad():
        lm = plan.gather_fsdp(params["lm_head"], plan.stack_specs["lm_head"])
    lm = lm.detach().requires_grad_()
    norm = params["final_norm"].detach().requires_grad_()
    tgts = targets.reshape(M, mb, S)

    def loss_head(y, m):
        logits = torch.matmul(plan.copy_tp(_rmsnorm(y, norm)), lm).float()
        return _nll(logits, tgts[m], plan).mean()

    return {"h": h,
            "mbs": None if h is None else h.detach().reshape(
                M, mb, S, h.shape[-1]),
            "stage_fn": _stack_fn(params, cfg, plan, rope, True),
            "params": _stage_leaves(params), "loss_head": loss_head,
            "head_params": [norm, lm]}


def _pp_finish(params: dict, work: dict, result: tuple, cfg: LlamaConfig,
               plan: _Plan, *, stage: bool = True, shared: bool = True
               ) -> torch.Tensor:
    """Put one rank's 1F1B gradients into ``.grad`` and return the loss:
    the stage's (``stage``) and the replicated leaves' (``shared``: the
    final norm's, the lm_head's reduce-scattered over fsdp, the
    embedding's from the input cotangent, the same on every pp rank),
    then each summed over the data axes its spec does not name.  The loss
    and the aux are the global means; the loss returned is
    ``loss + moe_aux_weight * aux``."""
    loss, aux, dmbs, grads, (dnorm, dlm) = result
    if stage:
        for leaf in work["params"]:
            # one fp32 accumulator at a time, freed as it is cast
            leaf.grad = grads.pop(0).to(leaf.dtype)
    if shared:
        params["final_norm"].grad = dnorm.to(params["final_norm"].dtype)
        if plan.size["fsdp"] > 1:
            dlm = comm.reduce_scatter(dlm, plan.mesh, ("fsdp",), 0)
        params["lm_head"].grad = dlm.to(params["lm_head"].dtype)
        h = work["h"]
        h.backward(dmbs.reshape(h.shape).to(h.dtype))
    _reduce_gradients(params, cfg, plan, pp_embed=False)
    if plan.n_data > 1:
        both = torch.stack([loss, aux]) * (1.0 / plan.n_data)
        loss, aux = comm.all_reduce_sum_(both, plan.mesh, DATA_AXES)
    return loss + cfg.moe_aux_weight * aux


def _check_schedule(cfg: LlamaConfig, plan: _Plan,
                    pipeline_schedule: str) -> None:
    if pipeline_schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"pipeline_schedule must be '1f1b' or 'gpipe', got "
                         f"{pipeline_schedule!r}")
    if plan.n_stages > 1 and pipeline_schedule == "1f1b" and cfg.blockwise_ce:
        raise NotImplementedError("blockwise CE requires a pp=1 mesh")


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer, *,
                    mesh=None, pipeline_schedule: str = "1f1b"
                    ) -> Callable[[dict, dict], torch.Tensor]:
    """A training step ``step(params, batch) -> loss``: zero the gradients,
    :func:`loss_fn` forward and backward, ``optimizer.step()``.

    ``optimizer`` is built over :func:`trainable` (params), e.g.
    ``torch.optim.Adam(trainable(params), lr, fused=True)``, whose update
    is optax.adam's.  Parameters are updated in place, as the JAX step
    donates its parameter buffers.  The loss comes back as a 0-d tensor on
    the parameters' device; the step makes no host sync.

    With ``mesh=`` (a :func:`~..parallel.build_mesh` mesh) the parameters
    and the optimizer's state are this rank's blocks (:func:`init_params`
    or :func:`shard_params` with the mesh), ``batch`` is the global
    batch, and :func:`reduce_gradients` runs between the backward and the
    update; every rank returns the global loss.  On ``pp > 1``
    ``pipeline_schedule`` picks "1f1b" (the default: explicit gradients,
    at most ``2(pp - 1)`` microbatch inputs held a stage,
    :func:`~..parallel.pipeline.pipeline_train_local`) or "gpipe"
    (autograd through :func:`loss_fn`'s fill-drain forward).  The
    reference's mesh step takes a plain optax ``tx`` too, no
    ``DistributedOptimizer``."""
    _check_train_cfg(cfg)
    plan = _Plan(cfg, mesh)
    _check_schedule(cfg, plan, pipeline_schedule)

    if plan.n_stages > 1 and pipeline_schedule == "1f1b":
        from ..parallel.pipeline import pipeline_train_local

        def step(params: dict, batch: dict) -> torch.Tensor:
            optimizer.zero_grad(set_to_none=True)
            work = _pp_work(params, batch, cfg, plan)
            res = pipeline_train_local(
                work["stage_fn"], work["params"], work["mbs"],
                work["loss_head"], work["head_params"],
                group=plan.pp_group(), aux_weight=cfg.moe_aux_weight,
                seed_scale=1.0 / plan.n_data)
            loss = _pp_finish(params, work, res, cfg, plan)
            optimizer.step()
            return loss.detach()

        return step

    def step(params: dict, batch: dict) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg, mesh=mesh)
        loss.backward()
        reduce_gradients(params, cfg, mesh)
        optimizer.step()
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# every stage of a pipeline in one process
# ---------------------------------------------------------------------------

def _pipeline_stages(params: dict, cfg: LlamaConfig, n: int) -> list[dict]:
    """Stage ``s``'s parameters of a ``pp = n`` pipeline, for each s,
    from the whole model's: layers ``s L/n .. (s+1) L/n - 1`` as views of
    the stacks (sharing :func:`trainable`'s per-layer leaves), the
    embedding, final norm and lm_head the whole model's tensors."""
    if cfg.n_layers % n:
        raise ValueError(f"pp={n} must divide n_layers={cfg.n_layers} "
                         f"evenly")
    trainable(params)
    lp = cfg.n_layers // n
    out = []
    for s in range(n):
        layers = {}
        for k, stack in params["layers"].items():
            view = stack[s * lp:(s + 1) * lp]
            view._layer_leaves = stack._layer_leaves[s * lp:(s + 1) * lp]
            layers[k] = view
        out.append({"layers": layers,
                    **{k: params[k] for k in ("embed", "final_norm",
                                              "lm_head")}})
    return out


def make_pipeline_step_local(cfg: LlamaConfig,
                             optimizer: torch.optim.Optimizer,
                             n_stages: int
                             ) -> Callable[[dict, dict], torch.Tensor]:
    """The 1F1B training step of a ``pp = n_stages`` mesh whose every
    other axis has size 1, with every stage run in this process and the
    handoffs passed in memory (:func:`~..parallel.pipeline.
    pipeline_train_stages`): the same stage bodies, loss head, embedding
    step and tick tables as :func:`make_train_step` on that mesh, one
    rank a stage, and bitwise its result at two stages.  ``params`` are
    the whole model's (:func:`init_params` without a mesh), the
    optimizer built over :func:`trainable` (params).  It drives a
    pipeline's schedule on one card; on one card its stages run one
    after the other, so it measures the schedule's work, never a
    pipelining speed-up."""
    _check_train_cfg(cfg)
    plans = [_Plan(cfg, {"pp": n_stages}, coord={"pp": s})
             for s in range(n_stages)]
    _check_schedule(cfg, plans[0], "1f1b")
    from ..parallel import pipeline as PL

    def step(params: dict, batch: dict) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        stages = _pipeline_stages(params, cfg, n_stages)
        works = [_pp_work(st, batch, cfg, pl, embed=s == 0)
                 for s, (st, pl) in enumerate(zip(stages, plans))]
        results = PL.pipeline_train_stages(
            [{k: w[k] for k in ("stage_fn", "params", "loss_head",
                                "head_params")} for w in works],
            works[0]["mbs"], aux_weight=cfg.moe_aux_weight)
        for s, (w, pl, r) in enumerate(zip(works, plans, results)):
            loss = _pp_finish(params, w, r, cfg, pl, shared=s == 0)
        optimizer.step()
        return loss.detach()

    return step
