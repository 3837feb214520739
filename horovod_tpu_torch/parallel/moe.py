"""Expert parallelism: Switch-style MoE with ``all_to_all`` dispatch.

The port of ``horovod_tpu/parallel/moe.py``.  Top-1 routing with a
static capacity (Switch Transformer, arXiv:2101.03961): dispatch and
combine are einsums with one-hot masks, the token exchange one
``all_to_all`` over the ``ep`` group in each direction.  Tokens past
their expert's capacity are dropped (their output row is 0; the caller's
residual carries them) and counted into
``hvd_moe_dropped_tokens_total{layer}``.

Three entries, as in the reference:

- :func:`moe_layer_local` — this rank's tokens and experts over an ``ep``
  process group (the reference's body inside a mapped region);
- :func:`moe_layer` — the standalone entry over a
  :func:`~horovod_tpu_torch.parallel.mesh.build_mesh` mesh: each rank
  passes its own token shard and its own experts and gets its own
  outputs back, with the ``ep``-group mean of the aux loss and the
  ``ep``-group total of the drops;
- :func:`moe_layer_hvd` — the job-scale layer over the engine's
  ``alltoall`` verb: per-expert counts first, then only the kept rows.

The exchanges go through ``torch.distributed.nn.functional``, so
gradients flow back through them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..obs import REGISTRY as _obs

_m_dropped = _obs.counter(
    "hvd_moe_dropped_tokens_total",
    "tokens dropped past expert capacity (the capacity-factor tuning "
    "signal: a persistently nonzero rate means the factor is too low "
    "for the observed routing skew)", ("layer",))


def record_dropped_tokens(count, layer: str = "0") -> None:
    """Count capacity overflow drops into the per-layer counter (host
    side: a tensor count is read here)."""
    c = float(count)
    if c > 0:
        _m_dropped.labels(layer=str(layer)).inc(c)


def capacity_of(tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Slots an expert holds: ``max(1, int(T * factor / E))``, truncated
    as the reference's Python ``int`` truncates."""
    return max(1, int(tokens * capacity_factor / n_experts))


def switch_route(router_logits: torch.Tensor, capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Top-1 routing masks.

    router_logits ``[T, E]``.  Returns (dispatch ``[T, E, C]`` in the
    logits' dtype, combine ``[T, E, C]`` = dispatch times the gate, the
    aux loss ``E * sum(density * density_proxy)`` (its gradient flows
    through the mean router probabilities only), dropped ``[T]`` bool:
    the tokens past their expert's capacity, which take no slot)."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    expert_idx = probs.argmax(dim=-1)                         # [T]
    expert_onehot = F.one_hot(expert_idx, E).to(torch.float32)
    # Load-balancing auxiliary loss († Switch eq. 4).
    density = expert_onehot.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux_loss = E * torch.sum(density * density_proxy)
    # Position of each token within its expert's buffer, a float cumsum.
    position = (torch.cumsum(expert_onehot, dim=0) - 1.0) * expert_onehot
    keep = (position < capacity) & (expert_onehot > 0)        # [T, E]
    slots = torch.arange(capacity, device=router_logits.device)
    pos_onehot = position.to(torch.int32)[..., None] == slots
    dispatch = (keep[..., None] & pos_onehot).to(torch.float32)  # [T, E, C]
    gate = (probs * expert_onehot).sum(dim=-1)                # [T]
    combine = dispatch * gate[:, None, None]
    dropped = ~keep.any(dim=-1)                               # [T]
    return dispatch.to(router_logits.dtype), combine, aux_loss, dropped


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``i`` of dim 0 to rank ``i`` of ``group``; block ``i`` of
    the result came from rank ``i`` (differentiable)."""
    from torch.distributed.nn import functional as dnn
    x = x.contiguous()
    return dnn.all_to_all_single(torch.empty_like(x), x, group=group)


#: ``group=`` of :func:`moe_layer_local` for one expert group of one rank
#: inside a job of several (the pipeline's stage body at ``ep = 1``):
#: this rank's tokens to all the experts, no exchange.
ONE_RANK = "one rank"


def _group_size(group) -> int:
    import torch.distributed as dist
    if group is ONE_RANK:
        return 1
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def moe_layer_local(tokens: torch.Tensor, router_kernel: torch.Tensor,
                    expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    expert_params: Any, *, group=None,
                    capacity_factor: float = 1.25,
                    return_drops: bool = False, batched: bool = False):
    """The MoE layer on this rank's tokens over the ``ep`` group
    ``group``.

    tokens ``[T, D]``; router_kernel ``[D, E_total]``, the same on every
    rank; expert_params this rank's experts, a dict of tensors with
    leading dim ``E_local`` (rank ``r`` of the group owns experts
    ``r*E_local .. (r+1)*E_local-1``); ``expert_fn(params, x)`` runs one
    expert, or, with ``batched``, every local expert at once on
    ``[E_local, n*C, D]`` (the model's tensor-parallel experts, whose
    collectives cannot run under ``vmap``).  The router logits and the
    expert buffers take the dtype jnp would promote the tokens and the
    router to (fp32 for bf16 tokens and an fp32 router).  Returns
    (output ``[T, D]``, aux loss); with ``return_drops``, also the
    dropped-token count (a 0-d tensor)."""
    n = _group_size(group)
    T, D = tokens.shape
    E_total = router_kernel.shape[1]
    if E_total % n:
        raise ValueError(f"experts ({E_total}) must divide ep size ({n})")
    E_local = E_total // n
    capacity = capacity_of(T, E_total, capacity_factor)

    lt = torch.promote_types(tokens.dtype, router_kernel.dtype)
    logits = tokens.to(lt) @ router_kernel.to(lt)             # [T, E]
    dispatch, combine, aux, dropped = switch_route(logits, capacity)
    # Gather tokens into expert buffers [E, C, D]; send each expert's
    # buffer to its owner: block i of [n, E_local, C, D] goes to rank i.
    dt = torch.promote_types(dispatch.dtype, tokens.dtype)   # as jnp
    expert_inputs = torch.einsum("tec,td->ecd", dispatch.to(dt),
                                 tokens.to(dt))
    shaped = expert_inputs.reshape(n, E_local, capacity, D)
    received = _all_to_all(shaped, group) if n > 1 else shaped
    # received [n(source), E_local, C, D]: every rank's tokens for mine.
    per_expert = received.transpose(0, 1).reshape(E_local, n * capacity, D)
    expert_out = expert_fn(expert_params, per_expert) if batched \
        else torch.func.vmap(expert_fn)(expert_params, per_expert)
    back = expert_out.reshape(E_local, n, capacity, D).transpose(0, 1)
    returned = _all_to_all(back, group) if n > 1 else back
    # returned [n(expert owner), E_local, C, D]: my tokens' results.
    results = returned.reshape(E_total, capacity, D)
    dt = torch.promote_types(combine.dtype, results.dtype)
    out = torch.einsum("tec,ecd->td", combine.to(dt), results.to(dt))
    if return_drops:
        return (out.to(tokens.dtype), aux,
                dropped.to(torch.float32).sum())
    return out.to(tokens.dtype), aux


def moe_layer(tokens: torch.Tensor, router_kernel: torch.Tensor,
              expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
              expert_params: Any, mesh, *, axis_name: str = "ep",
              capacity_factor: float = 1.25,
              layer: str = "0") -> tuple[torch.Tensor, torch.Tensor]:
    """Standalone entry over ``mesh`` (a ``DeviceMesh`` from
    :func:`~horovod_tpu_torch.parallel.mesh.build_mesh`): this rank's
    token shard ``[T, D]`` and its experts (leaves ``[E_local, ...]``)
    in, its outputs and the ``axis_name``-group mean of the aux loss out.
    The group's total of dropped tokens is counted into
    ``hvd_moe_dropped_tokens_total{layer}`` on every rank, as the
    reference's does (a cluster sum of the counter so counts each drop
    once per rank of the group)."""
    from torch.distributed.nn import functional as dnn
    group = mesh.get_group(axis_name)
    n = _group_size(group)
    out, aux, drops = moe_layer_local(
        tokens, router_kernel, expert_fn, expert_params, group=group,
        capacity_factor=capacity_factor, return_drops=True)
    if n > 1:
        aux = dnn.all_reduce(aux, group=group) * (1.0 / n)
        drops = dnn.all_reduce(drops.detach(), group=group)
    record_dropped_tokens(drops.item(), layer)
    return out, aux


def moe_layer_hvd(tokens: torch.Tensor, router_kernel: torch.Tensor,
                  expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  expert_params: Any, *, capacity_factor: float = 1.25,
                  layer: str = "0") -> tuple[torch.Tensor, float, int]:
    """Expert parallelism over the engine's negotiated ``hvd.alltoall``,
    one rank a process.

    Routing happens here; the per-expert counts are exchanged first (a
    small uniform alltoall), so the token exchange ships only the kept
    rows, with every split size known on every rank.  ``tokens`` is this
    rank's ``[T, D]``; ``router_kernel`` ``[D, E_total]`` the same on
    every rank; ``expert_params`` this rank's experts, leaves
    ``[E_local, ...]`` (rank ``r`` owns experts ``r*E_local ..
    (r+1)*E_local-1``).  Returns (output ``[T, D]``: the gate times the
    expert's output for a kept token, 0 for a dropped one; this rank's
    aux loss; this rank's dropped-token count, also counted into
    ``hvd_moe_dropped_tokens_total{layer}``).  The reference's function
    takes a list of per-rank tensors, one for each rank its process
    drives; here a process drives one."""
    import horovod_tpu_torch as hvd

    n = hvd.size()
    tok = tokens.float()
    rk = router_kernel.float()
    E_total = rk.shape[1]
    if E_total % n:
        raise ValueError(f"experts ({E_total}) must divide world ({n})")
    E_local = E_total // n
    T = tok.shape[0]
    capacity = capacity_of(T, E_total, capacity_factor)
    probs = torch.softmax(tok @ rk, dim=-1)
    eidx = probs.argmax(dim=-1)
    gate = probs.gather(1, eidx[:, None])[:, 0]
    onehot = F.one_hot(eidx, E_total)
    aux = float(E_total * (onehot.float().mean(0) * probs.mean(0)).sum())
    pos = onehot.cumsum(0).gather(1, eidx[:, None])[:, 0] - 1   # in expert
    counts = onehot.sum(0).clamp(max=capacity).to(torch.int32)  # kept
    keep = pos < capacity
    dropped = int((~keep).sum())
    kept = torch.nonzero(keep)[:, 0]
    order = kept[torch.argsort(eidx[kept], stable=True)]

    # (1) the per-expert counts: rank j learns how many rows each source
    # sends for each of its experts, so every split below is known.
    cnt = hvd.alltoall(counts, splits=[E_local] * n).reshape(n, E_local)
    # (2) the kept tokens, expert-ascending per destination.
    data = hvd.alltoall(tok[order].contiguous(),
                        splits=counts.reshape(n, E_local).sum(1).tolist())

    # (3) the local experts, each on its rows from every source.
    src_off = [0] + cnt.sum(1).cumsum(0).tolist()
    within = torch.cat([torch.zeros(n, 1, dtype=cnt.dtype),
                        cnt.cpu().cumsum(1)], dim=1).tolist()
    out_rows = torch.zeros_like(data)
    for e in range(E_local):
        spans = [(src_off[i] + within[i][e], src_off[i] + within[i][e + 1])
                 for i in range(n)]
        if all(a == b for a, b in spans):
            continue
        x_e = torch.cat([data[a:b] for a, b in spans])
        p_e = {k: v[e] for k, v in expert_params.items()} \
            if isinstance(expert_params, dict) else expert_params[e]
        y_e = expert_fn(p_e, x_e)
        off = 0
        for a, b in spans:
            out_rows[a:b] = y_e[off:off + b - a]
            off += b - a

    # (4) the inverse exchange: each rank returns exactly the rows it got.
    back = hvd.alltoall(out_rows, splits=cnt.sum(1).tolist())
    out = torch.zeros_like(tok)
    out[order] = gate[order, None] * back
    record_dropped_tokens(dropped, layer)
    return out.to(tokens.dtype), aux, dropped
