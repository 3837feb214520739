"""BERT, the port of ``horovod_tpu/models/bert.py`` (config 3 of
BASELINE.json): :class:`BertConfig` (``tiny``, ``bert_large``),
:class:`EncoderLayer`, :class:`Bert`, :func:`mlm_loss` and
:func:`synthetic_mlm_batch`.

A pre-norm encoder with the JAX package's flax numerics:

- LayerNorms in fp32 with flax's epsilon, 1e-6; so the residual stream
  is fp32 from the embedding's LayerNorm on, and ``h + attn`` adds a
  ``dtype`` attention output to it;
- flax's ``MultiHeadDotProductAttention``, dense, every step in the
  config's dtype: q, k and v projections with bias, q scaled by
  ``1/sqrt(head_dim)``, the scores masked with ``finfo(dtype).min``
  from the ``[B, 1, 1, S]`` padding mask, the softmax, the output
  projection.  The JAX package's attention is dense einsums, not a
  Pallas kernel, so this is plain PyTorch too (no flash kernel, no
  SDPA);
- ``nn.gelu`` is the tanh approximation;
- the MLM head is tied: ``h @ Eᵀ`` in ``dtype`` with no bias, cast to
  fp32.

Parameters stay fp32 and are cast where flax casts them.  The q, k and v
projections are one ``[3 d, d]`` matrix (flax's three ``DenseGeneral``
kernels ``(d, H, hd)``, reshaped and stacked by :func:`params_from_jax`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import context
from . import _common as C


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 1024          # BERT-Large
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    max_seq: int = 512
    type_vocab: int = 2
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    d_ff=128, max_seq=64, dtype=torch.float32)
        base.update(kw)
        return BertConfig(**base)

    @staticmethod
    def bert_large(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
            ) -> torch.Tensor:
    """flax's ``Dense(dtype=)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, *, device, generator) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.ln0 = nn.LayerNorm(d, eps=1e-6, device=device)
        self.qkv = nn.Linear(d, 3 * d, device=device)
        self.out = nn.Linear(d, d, device=device)
        self.ln1 = nn.LayerNorm(d, eps=1e-6, device=device)
        self.fc1 = nn.Linear(d, cfg.d_ff, device=device)
        self.fc2 = nn.Linear(cfg.d_ff, d, device=device)
        for lin in (self.qkv, self.out, self.fc1, self.fc2):
            C.lecun_normal_(lin.weight, lin.in_features, generator)
            if device.type != "meta":
                nn.init.zeros_(lin.bias)

    def attention(self, x: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, _ = x.shape
        q, k, v = _linear(x, self.qkv, dt).view(
            B, S, 3, cfg.n_heads, cfg.head_dim).unbind(2)
        q = q / torch.tensor(math.sqrt(cfg.head_dim), dtype=dt)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        scores = scores.masked_fill(~mask, torch.finfo(dt).min)
        weights = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return _linear(o.reshape(B, S, -1), self.out, dt)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        h = h + self.attention(self.ln0(h), mask)
        y = _linear(self.ln1(h), self.fc1, dt)
        y = _linear(F.gelu(y, approximate="tanh"), self.fc2, dt)
        return h + y


class Bert(nn.Module):
    """Token, position (and with ``token_types=True`` type) embeddings,
    ``n_layers`` encoder layers, a final LayerNorm and the tied MLM head.
    The type embedding exists only when asked for, as the reference's
    exists only when its ``init`` saw token types."""

    def __init__(self, cfg: BertConfig, *, token_types: bool = False,
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        dev, gen = C.resolve(device, generator)
        self.cfg = cfg
        d = cfg.d_model
        self.tok_embed = nn.Parameter(torch.empty(cfg.vocab_size, d,
                                                  device=dev))
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_seq, d,
                                                  device=dev))
        embeds = [self.tok_embed, self.pos_embed]
        if token_types:
            self.type_embed = nn.Parameter(torch.empty(cfg.type_vocab, d,
                                                       device=dev))
            embeds.append(self.type_embed)
        for e in embeds:                 # flax's default_embed_init
            C.normal_(e, 1.0 / math.sqrt(d), gen)
        self.ln_embed = nn.LayerNorm(d, eps=1e-6, device=dev)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device=dev, generator=gen)
            for _ in range(cfg.n_layers))
        self.ln_final = nn.LayerNorm(d, eps=1e-6, device=dev)

    def forward(self, tokens: torch.Tensor,
                token_types: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``tokens`` ``[B, S]``; fp32 MLM logits ``[B, S, vocab]``.
        ``attn_mask`` ``[B, S]``: nonzero where a key may be attended."""
        dt = self.cfg.dtype
        B, S = tokens.shape
        emb = self.tok_embed.to(dt)
        h = F.embedding(tokens, emb) + self.pos_embed[:S].to(dt)
        if token_types is not None:
            h = h + F.embedding(token_types, self.type_embed.to(dt))
        h = self.ln_embed(h.float())
        if attn_mask is None:
            mask = torch.ones((B, 1, 1, S), dtype=torch.bool,
                              device=tokens.device)
        else:
            mask = attn_mask[:, None, None, :].bool()
        for layer in self.layers:
            h = layer(h, mask)
        h = self.ln_final(h)
        return (h.to(dt) @ emb.t()).float()


def mlm_loss(model: Bert, batch: dict) -> torch.Tensor:
    """Masked-LM objective: ``batch`` holds ``tokens`` ``[B, S]`` and
    ``labels`` ``[B, S]`` (-100 at unmasked positions, left out of the
    mean), optionally ``attn_mask``."""
    logits = model(batch["tokens"], attn_mask=batch.get("attn_mask"))
    labels = batch["labels"].long()
    valid = labels >= 0
    losses = F.cross_entropy(logits.flatten(0, 1),
                             torch.where(valid, labels, 0).flatten(),
                             reduction="none").view(labels.shape)
    return (losses * valid).sum() / valid.sum().clamp_min(1)


def synthetic_mlm_batch(cfg: BertConfig, batch: int, seq: int,
                        seed: int = 0, mask_rate: float = 0.15,
                        device=None) -> dict:
    """The JAX package's synthetic batch, drawn the same way from numpy
    (so the same seed gives the same tokens and labels), on ``device``."""
    dev = context.device(device)
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, size=(batch, seq))
    labels = np.full((batch, seq), -100, np.int32)
    mask = rng.rand(batch, seq) < mask_rate
    labels[mask] = tokens[mask]
    tokens[mask] = 0  # [MASK] id
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def params_from_jax(variables: dict, device=None) -> dict:
    """The JAX package's ``Bert`` variables (numpy leaves) as this
    module's ``state_dict`` on ``device``: Dense kernels transposed, the
    attention's ``DenseGeneral`` kernels reshaped (q, k and v stacked
    into one matrix), LayerNorm ``scale`` as ``weight``."""
    dev = context.device(device)
    p = variables["params"]
    sd = {"tok_embed": C.leaf(p["tok_embed"]["embedding"], dev),
          "pos_embed": C.leaf(p["pos_embed"]["embedding"], dev)}
    if "type_embed" in p:
        sd["type_embed"] = C.leaf(p["type_embed"]["embedding"], dev)

    def ln(name: str, q: dict) -> None:
        sd[f"{name}.weight"] = C.leaf(q["scale"], dev)
        sd[f"{name}.bias"] = C.leaf(q["bias"], dev)

    ln("ln_embed", p["LayerNorm_0"])
    ln("ln_final", p["LayerNorm_1"])
    i = 0
    while f"EncoderLayer_{i}" in p:
        lp, pre = p[f"EncoderLayer_{i}"], f"layers.{i}"
        attn = lp["MultiHeadDotProductAttention_0"]
        d = np.asarray(attn["query"]["kernel"]).shape[0]
        sd[f"{pre}.qkv.weight"] = C.leaf(np.concatenate(
            [np.asarray(attn[n]["kernel"]).reshape(d, -1).T
             for n in ("query", "key", "value")]), dev)
        sd[f"{pre}.qkv.bias"] = C.leaf(np.concatenate(
            [np.asarray(attn[n]["bias"]).reshape(-1)
             for n in ("query", "key", "value")]), dev)
        sd[f"{pre}.out.weight"] = C.leaf(
            np.asarray(attn["out"]["kernel"]).reshape(-1, d).T, dev)
        sd[f"{pre}.out.bias"] = C.leaf(attn["out"]["bias"], dev)
        ln(f"{pre}.ln0", lp["LayerNorm_0"])
        ln(f"{pre}.ln1", lp["LayerNorm_1"])
        sd[f"{pre}.fc1.weight"], sd[f"{pre}.fc1.bias"] = C.dense(
            lp["Dense_0"], dev)
        sd[f"{pre}.fc2.weight"], sd[f"{pre}.fc2.bias"] = C.dense(
            lp["Dense_1"], dev)
        i += 1
    return sd
