"""DLRM, the port of ``horovod_tpu/models/dlrm.py`` (config 5 of
BASELINE.json): :class:`DlrmConfig`, :class:`MLP`,
:func:`interact_features`, :class:`DlrmDense`,
:func:`init_embedding_tables`, :func:`sharded_embedding_lookup_local`,
:func:`sharded_embedding_lookup` and :func:`synthetic_batch`.

Dense features go through the bottom MLP; categorical features are
looked up in embedding tables; a pairwise dot-product interaction feeds
the top MLP, which gives the click logit (Naumov et al.,
arXiv:1906.00091).

The tables are model-parallel (each rank owns ``n_sparse / n`` whole
tables), the batch data-parallel.  A step's lookup is the JAX package's
two exchanges, each one ``torch.distributed.all_to_all_single`` over the
process group (the reference's ``lax.all_to_all`` over ``axis_name``):
the batch shards' indices to the tables' owners, then the embeddings
back to the batch shards.  Both go through the autograd ``Function`` of
:func:`~..parallel.comm.all_to_all_group`, so the embeddings' cotangents
take the inverse exchange; the two calls are made even on a group of one
rank.  The gather's gradient is dense (a table-shaped tensor, as
``take_along_axis``'s is in JAX), so Adam updates every row.

Beside ``DistributedOptimizer`` the exchange needs a group of its own
(``torch.distributed.new_group``): the runtime's engine issues the dense
gradients' allreduces on the world group from its thread while the
backward runs the reverse exchange, and one group's collectives must
come in the same order on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import context
from ..parallel.comm import all_to_all_group
from . import _common as C


@dataclasses.dataclass(frozen=True)
class DlrmConfig:
    n_dense: int = 13
    n_sparse: int = 26            # number of categorical tables
    vocab_per_table: int = 1000
    embed_dim: int = 16
    bottom_mlp: Sequence[int] = (64, 32, 16)
    top_mlp: Sequence[int] = (64, 32, 1)
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw) -> "DlrmConfig":
        base = dict(n_dense=4, n_sparse=8, vocab_per_table=64, embed_dim=8,
                    bottom_mlp=(16, 8), top_mlp=(16, 1))
        base.update(kw)
        return DlrmConfig(**base)


class MLP(nn.Module):
    """Dense layers with ReLU between them (and after the last with
    ``final_activation``), each computing in ``dtype``."""

    def __init__(self, in_features: int, sizes: Sequence[int], *,
                 dtype: torch.dtype = torch.float32,
                 final_activation: bool = False, device, generator) -> None:
        super().__init__()
        self.dtype, self.final_activation = dtype, final_activation
        layers = []
        for n in sizes:
            lin = nn.Linear(in_features, n, device=device)
            C.lecun_normal_(lin.weight, in_features, generator)
            if device.type != "meta":
                nn.init.zeros_(lin.bias)
            layers.append(lin)
            in_features = n
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        for i, lin in enumerate(self.layers):
            x = F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
            if i < len(self.layers) - 1 or self.final_activation:
                x = F.relu(x)
        return x


def interact_features(dense_emb: torch.Tensor, sparse_emb: torch.Tensor
                      ) -> torch.Tensor:
    """Pairwise dot-product interaction (arXiv:1906.00091 §2).

    dense_emb: [B, D]; sparse_emb: [B, T, D] → [B, D + T*(T+1)//2]."""
    T = sparse_emb.shape[1]
    all_emb = torch.cat([dense_emb[:, None, :], sparse_emb], dim=1)
    inter = torch.bmm(all_emb, all_emb.transpose(1, 2))
    iu, ju = np.triu_indices(T + 1, k=1)      # the JAX package's order
    flat = inter[:, torch.from_numpy(iu).to(inter.device),
                 torch.from_numpy(ju).to(inter.device)]
    return torch.cat([dense_emb, flat], dim=1)


class DlrmDense(nn.Module):
    """The dense (data-parallel) half: bottom MLP, interaction, top MLP.
    The embedding lookups happen outside (the model-parallel half)."""

    def __init__(self, cfg: DlrmConfig, *, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if cfg.bottom_mlp[-1] != cfg.embed_dim:
            raise ValueError("bottom MLP must end at embed_dim for "
                             "interaction")
        dev, gen = C.resolve(device, generator)
        self.cfg = cfg
        self.bottom = MLP(cfg.n_dense, cfg.bottom_mlp, dtype=cfg.dtype,
                          final_activation=True, device=dev, generator=gen)
        T = cfg.n_sparse
        self.top = MLP(cfg.embed_dim + T * (T + 1) // 2, cfg.top_mlp,
                       dtype=cfg.dtype, device=dev, generator=gen)

    def forward(self, dense_features: torch.Tensor,
                sparse_embeddings: torch.Tensor) -> torch.Tensor:
        """``dense_features`` ``[B, n_dense]``, ``sparse_embeddings``
        ``[B, n_sparse, embed_dim]``; logits ``[B]``."""
        z = interact_features(self.bottom(dense_features), sparse_embeddings)
        return self.top(z)[..., 0]


def init_embedding_tables(cfg: DlrmConfig, generator: torch.Generator,
                          device=None) -> torch.Tensor:
    """``[n_sparse, vocab, dim]`` drawn from ``N(0, 0.05²)`` on
    ``generator``'s device (the card's, for tables of gigabytes), moved
    to ``device``."""
    dev = context.device(device)
    t = torch.randn((cfg.n_sparse, cfg.vocab_per_table, cfg.embed_dim),
                    generator=generator, device=generator.device)
    return (t.mul_(0.05)).to(dev, cfg.dtype)


def sharded_embedding_lookup_local(tables: torch.Tensor,
                                   indices: torch.Tensor, *,
                                   group=None) -> torch.Tensor:
    """One rank's lookup: ``tables`` its ``[T/n, V, D]``, ``indices`` its
    batch shard ``[b, T]`` (for all T tables); returns ``[b, T, D]``.

    Exchange 1 ships each batch shard's indices for a rank's tables to
    that rank; the rank looks its tables up for the whole global batch;
    exchange 2 returns the embeddings to the batch shards.  ``group``:
    the process group the tables are sharded over (None: the world)."""
    n = dist.get_world_size(group)
    b, T = indices.shape
    t_local = tables.shape[0]
    if t_local * n != T:
        raise ValueError(f"{T} tables do not split into {n} shards of "
                         f"{t_local}")
    # [b, T] -> [n, b, T/n]: index columns grouped by owning rank.
    idx_by_owner = indices.reshape(b, n, t_local).transpose(0, 1)
    recv = all_to_all_group(idx_by_owner, group)
    flat_idx = recv.reshape(n * b, t_local).long()
    rows = torch.arange(t_local, device=tables.device)
    looked = tables[rows[None, :], flat_idx]          # [n*b, t_local, D]
    back = all_to_all_group(looked.reshape(n, b, t_local, -1), group)
    # [n, b, t_local, D], leading dim = table owner -> [b, T, D].
    return back.transpose(0, 1).reshape(b, T, -1)


def sharded_embedding_lookup(tables: torch.Tensor, indices: torch.Tensor,
                             *, group=None) -> torch.Tensor:
    """Standalone entry: the full ``tables`` ``[T, V, D]`` and the global
    ``indices`` ``[B, T]`` (the same on every rank); each rank keeps its
    block of the tables and of the batch and returns its batch shard
    ``[B/n, T, D]`` of the lookup.  The batch must split evenly."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    B, T = indices.shape
    if B % n:
        raise ValueError(f"a batch of {B} does not split into {n} equal "
                         f"shards")
    t, b = T // n, B // n
    return sharded_embedding_lookup_local(
        tables[me * t:(me + 1) * t], indices[me * b:(me + 1) * b],
        group=group)


def synthetic_batch(cfg: DlrmConfig, batch: int, seed: int = 0,
                    device=None) -> dict:
    """The JAX package's synthetic batch, drawn the same way from numpy,
    on ``device``."""
    dev = context.device(device)
    rng = np.random.RandomState(seed)
    arrays = {
        "dense": rng.rand(batch, cfg.n_dense).astype(np.float32),
        "sparse": rng.randint(0, cfg.vocab_per_table,
                              size=(batch, cfg.n_sparse)).astype(np.int32),
        "label": rng.randint(0, 2, size=(batch,)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def params_from_jax(variables: dict, device=None) -> dict:
    """The JAX package's ``DlrmDense`` variables (numpy leaves) as this
    module's ``state_dict`` on ``device``."""
    dev = context.device(device)
    p = variables["params"]
    sd = {}
    for name, key in (("bottom", "MLP_0"), ("top", "MLP_1")):
        i = 0
        while f"Dense_{i}" in p[key]:
            sd[f"{name}.layers.{i}.weight"], sd[f"{name}.layers.{i}.bias"] \
                = C.dense(p[key][f"Dense_{i}"], dev)
            i += 1
    return sd
