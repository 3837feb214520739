"""Pipeline parallelism: GPipe and 1F1B microbatch schedules over ``pp``.

The port of ``horovod_tpu/parallel/pipeline.py``.  Each rank of the
``pp`` group holds one stage (a contiguous block of layers) and runs the
ticks of a schedule; activations go forward to stage ``s + 1`` and, in
1F1B, cotangents back to stage ``s - 1``, point to point.

- **GPipe** (:func:`pipeline_apply_local`): fill-drain over
  ``T = M + n - 1`` ticks; at tick ``t`` stage ``s`` runs microbatch
  ``t - s`` when ``0 <= t - s < M`` (:func:`pipeline_apply` is the
  standalone entry).  It runs under autograd: the handoff
  is :class:`~.comm.PipelineHandoff`, whose backward sends the cotangent
  to ``s - 1``, and the last stage's outputs reach every ``pp`` rank
  through :func:`~.comm.from_last_stage`, whose backward keeps only the
  last stage's cotangent, so the backward is that of one loss, not
  ``n`` copies of it.
- **1F1B** (:func:`pipeline_train_local`): ``T = M + 2(n - 1)`` ticks; at
  tick ``t`` stage ``s`` runs the forward of microbatch ``t - s`` and the
  backward of microbatch ``t - 2(n - 1) + s``, the tick its cotangent
  arrives.  A stage keeps the inputs of at most ``K = 2(n - 1)``
  microbatches in flight (a ring of K slots) and its backward recomputes
  the stage from the saved input.  Gradients are explicit, accumulated in
  fp32 and multiplied by ``1/M`` (the reference's ``inv_m``).

Bubble: ``(n - 1) / (M + n - 1)`` for both.

The schedule and its transport are separate.  What stage ``s`` does at
tick ``t`` is a method of a stage object (:class:`GPipeStage`,
:class:`OneFOneBStage`) of its inputs and of the handoffs it receives;
both sides of every handoff derive it from the same tick table
(:func:`gpipe_live`, :func:`fwd_microbatch`, :func:`bwd_microbatch`), so a
dead tick posts nothing and its peer expects nothing.  Two drivers carry
the handoffs: over the ``pp`` process group (:func:`pipeline_apply_local`,
:func:`pipeline_train_local`, one process a stage; ``batch_isend_irecv``
as :mod:`.ring_attention` does), and in memory, every stage in one
process tick by tick (:func:`pipeline_apply_stages`,
:func:`pipeline_train_stages`), the reference's single-program
``ppermute`` at the end of each tick.  The stage-0 to stage-``n - 1``
wrap-around of the reference's ring permutation is never used and never
sent.

No kernel here: the stage bodies are the caller's (the Llama's run the
flash kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from . import comm


# ---------------------------------------------------------------------------
# tick tables
# ---------------------------------------------------------------------------

def gpipe_live(s: int, t: int, M: int) -> bool:
    """GPipe: stage ``s`` runs microbatch ``t - s`` at tick ``t``."""
    return 0 <= t - s < M


def fwd_microbatch(s: int, t: int) -> int:
    """1F1B: the microbatch whose forward stage ``s`` runs at tick ``t``."""
    return t - s


def bwd_microbatch(s: int, t: int, n: int) -> int:
    """1F1B: the microbatch whose backward stage ``s`` runs at tick ``t``
    (on the last stage, the one whose forward it runs)."""
    return t - 2 * (n - 1) + s


def _in(m: int, M: int) -> bool:
    return 0 <= m < M


class GroupTransport:
    """Handoffs between neighbouring stages over the ``pp`` process group:
    one ``batch_isend_irecv`` a tick, the sends and receives both sides
    derived from the same table."""

    def __init__(self, group):
        self.group = group
        self.ranks = dist.get_process_group_ranks(group)
        self.stage = dist.get_rank(group)
        self.n = len(self.ranks)

    def exchange(self, sends: Sequence[tuple], recvs: Sequence[tuple]
                 ) -> list:
        """``sends``: (peer stage, tensor); ``recvs``: (peer stage, like
        tensor).  Returns the received tensors in ``recvs``' order."""
        ops, outs = [], []
        for peer, x in sends:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  self.ranks[peer], self.group))
        for peer, like in recvs:
            out = torch.empty_like(like, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[peer],
                                  self.group))
            outs.append(out)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return outs

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the stages (no gradient)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def from_stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """Stage ``stage``'s ``x`` on every stage (no gradient)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, self.ranks[stage], group=self.group)
        return out


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

class GPipeStage:
    """Stage ``s`` of ``n`` of a GPipe forward over ``M`` microbatches.
    :meth:`tick` runs tick ``t`` on the input handed over from stage
    ``s - 1`` (stage 0 injects microbatch ``t``) and returns what goes to
    stage ``s + 1``; the last stage keeps its outputs."""

    def __init__(self, s: int, n: int, stage_fn: Callable, microbatches,
                 with_aux: bool):
        self.s, self.n, self.fn = s, n, stage_fn
        self.mbs = microbatches
        self.M = len(microbatches)
        self.with_aux = with_aux
        self.outputs: list = [None] * self.M
        self.aux = None

    def live(self, t: int) -> bool:
        return gpipe_live(self.s, t, self.M)

    def sends(self, t: int) -> bool:
        return self.s < self.n - 1 and self.live(t)

    def receives(self, t: int) -> bool:
        """Whether stage ``s - 1`` hands an activation over at the end of
        tick ``t`` (for this stage's tick ``t + 1``)."""
        return self.s > 0 and gpipe_live(self.s - 1, t, self.M)

    def tick(self, t: int, x_in: Optional[torch.Tensor]
             ) -> Optional[torch.Tensor]:
        if not self.live(t):
            return None
        x = self.mbs[t] if self.s == 0 else x_in
        res = self.fn(x)
        y, aux = res if self.with_aux else (res, None)
        if self.with_aux:
            self.aux = aux if self.aux is None else self.aux + aux
        if self.s == self.n - 1:
            self.outputs[t - self.s] = y
        return y


def pipeline_apply_local(stage_fn: Callable, microbatches: torch.Tensor, *,
                         group, with_aux: bool = False):
    """The GPipe forward on this rank's stage of the ``pp`` group
    ``group``, under autograd.

    ``stage_fn(x)`` applies this stage (its parameters closed over) to one
    microbatch ``[mb, ...]`` and returns an output of the same shape (with
    ``with_aux``, ``(y, aux scalar)``).  ``microbatches`` ``[M, mb, ...]``
    is the same on every stage; only stage 0 reads it.  Returns the last
    stage's outputs ``[M, mb, ...]`` on every stage; with ``with_aux``
    also the aux summed over the stages' live ticks and the stages, times
    ``1/M``.  The backward of whatever the caller computes from them is
    that of one loss: each stage's parameters get the gradient through
    the handoffs, stage 0's inputs their cotangent."""
    tr = GroupTransport(group)
    s, n = tr.stage, tr.n
    stage = GPipeStage(s, n, stage_fn, microbatches, with_aux)
    M = stage.M
    like = microbatches[0].detach()
    # The handoffs' autograd chain: every handoff takes and returns a
    # token, so each rank's backward runs its handoffs' backwards, last
    # tick first, even where its received activation is unused.
    tok = torch.zeros((), dtype=torch.float32, device=like.device,
                      requires_grad=True)
    x = None
    for t in range(M + n - 1):
        y = stage.tick(t, x)
        send, recv = stage.sends(t), stage.receives(t)
        if send or recv:
            x, tok = comm.pipeline_handoff(
                y if send else None, tok, tr, like if recv else None)
        else:
            x = None
    outs = torch.stack(stage.outputs) if s == n - 1 else None
    out = comm.from_last_stage(outs, tok, tr, torch.Size((M,)) + like.shape,
                               like.dtype)
    if not with_aux:
        return out
    aux = comm.reduce_from_group(stage.aux, tr.group) * (1.0 / M)
    return out, aux


def pipeline_apply(stage_fn: Callable, stacked_params: Any,
                   microbatches: torch.Tensor, mesh, *,
                   axis_name: str = "pp") -> torch.Tensor:
    """The standalone entry: ``stacked_params`` a dict (or tensor) whose
    leaves have a leading dim of the ``axis_name`` size, stage-major, the
    same on every rank; ``stage_fn(params, x)`` one stage's forward.
    Each rank runs its stage ``params[s]`` in the GPipe schedule over the
    mesh's ``axis_name`` group; returns the ``[M, mb, ...]`` outputs on
    every rank."""
    group = mesh.get_group(axis_name)
    s = dist.get_rank(group)
    mine = ({k: v[s] for k, v in stacked_params.items()}
            if isinstance(stacked_params, dict) else stacked_params[s])
    return pipeline_apply_local(lambda x: stage_fn(mine, x), microbatches,
                                group=group)


def pipeline_apply_stages(stage_fns: Sequence[Callable], microbatches, *,
                          with_aux: bool = False):
    """The GPipe forward of every stage in this process, handoffs in
    memory (the one-process driver: the same ticks as
    :func:`pipeline_apply_local`, stage after stage within a tick)."""
    n = len(stage_fns)
    stages = [GPipeStage(s, n, fn, microbatches, with_aux)
              for s, fn in enumerate(stage_fns)]
    M = stages[0].M
    inbox: list = [None] * n
    for t in range(M + n - 1):
        outs = [st.tick(t, inbox[st.s]) for st in stages]
        inbox = [None] + [outs[s] if stages[s].sends(t) else None
                          for s in range(n - 1)]
    out = torch.stack(stages[-1].outputs)
    if not with_aux:
        return out
    aux = stages[0].aux
    for st in stages[1:]:
        aux = aux + st.aux
    return out, aux * (1.0 / M)


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageResult:
    """One stage's accumulators at the end of the 1F1B ticks, before any
    reduction over the stages."""
    loss: torch.Tensor          # fp32; the last stage's sum over microbatches
    aux: torch.Tensor           # fp32; this stage's aux over its live ticks
    grads: list                 # fp32, one a stage parameter
    head_grads: list            # fp32, one a head parameter (last stage)
    d_microbatches: Optional[list]   # stage 0: the input cotangents


class OneFOneBStage:
    """Stage ``s`` of ``n`` of the 1F1B schedule (the reference's tick
    body).  ``stage_fn(x) -> (y, aux)`` runs the stage on one microbatch;
    ``params`` are the leaves whose gradients it accumulates;
    ``loss_head(y, m) -> scalar`` is microbatch ``m``'s loss (last stage)
    over ``head_params``.  The parameters' ``.grad`` is left None: each
    leaf's gradient is folded into its fp32 accumulator as the backward
    produces it (a post-accumulate hook, removed by :meth:`close`).

    Per tick: the backward's saved input is read before the forward
    writes its slot (at stage 0 the two coincide mod K); the forward runs
    without autograd (except on the last stage, whose backward microbatch
    is its forward's: there the forward runs once, under autograd, the
    loss head's cotangent seeded with ``seed_scale``); the backward
    recomputes the stage from the saved input and takes the cotangent
    from stage ``s + 1``, the aux's seeded with ``aux_weight *
    seed_scale``."""

    def __init__(self, s: int, n: int, stage_fn: Callable, params: list,
                 microbatches, loss_head: Optional[Callable],
                 head_params: list, *, aux_weight: float = 0.0,
                 seed_scale: float = 1.0):
        if n < 2:
            raise ValueError("the 1F1B schedule needs a pp axis of size "
                             ">= 2")
        self.s, self.n, self.fn = s, n, stage_fn
        self.params = list(params)
        self.mbs = microbatches
        self.M = len(microbatches)
        self.K = 2 * (n - 1)
        self.head, self.head_params = loss_head, list(head_params)
        self.aux_weight, self.seed_scale = aux_weight, seed_scale
        dev = microbatches[0].device
        f32 = torch.float32
        self.ring: list = [None] * self.K
        self.gacc = [torch.zeros(p.shape, dtype=f32, device=dev)
                     for p in self.params]
        self.hacc = [torch.zeros(p.shape, dtype=f32, device=dev)
                     for p in self.head_params]
        self.loss_acc = torch.zeros((), dtype=f32, device=dev)
        self.aux_acc = torch.zeros((), dtype=f32, device=dev)
        self.dmbs: Optional[list] = [None] * self.M if s == 0 else None
        self.like = microbatches[0].detach()
        # Each leaf's gradient goes into its fp32 accumulator as autograd
        # produces it and is dropped: a tick never holds the whole
        # stage's gradients (7B: 6.7 GB a stage in bf16).
        self._slot = {id(p): a for p, a in zip(self.params, self.gacc)}
        self._hooks = []
        for p in self.params:
            p.grad = None
            self._hooks.append(p.register_post_accumulate_grad_hook(
                self._fold))

    def _fold(self, p: torch.Tensor) -> None:
        self._slot[id(p)].add_(p.grad.float())
        p.grad = None

    def close(self) -> None:
        """Remove the accumulation hooks from the stage parameters."""
        for h in self._hooks:
            h.remove()
        self._hooks = []

    @property
    def last(self) -> bool:
        return self.s == self.n - 1

    def live_f(self, t: int) -> bool:
        return _in(fwd_microbatch(self.s, t), self.M)

    def live_b(self, t: int) -> bool:
        return _in(bwd_microbatch(self.s, t, self.n), self.M)

    def sends_fwd(self, t: int) -> bool:
        return not self.last and self.live_f(t)

    def sends_bwd(self, t: int) -> bool:
        return self.s > 0 and self.live_b(t)

    def receives_fwd(self, t: int) -> bool:
        """Whether stage ``s - 1`` hands an activation over at the end of
        tick ``t``."""
        return self.s > 0 and _in(fwd_microbatch(self.s - 1, t), self.M)

    def receives_bwd(self, t: int) -> bool:
        """Whether stage ``s + 1`` hands a cotangent back at the end of
        tick ``t``."""
        return not self.last and _in(bwd_microbatch(self.s + 1, t, self.n),
                                     self.M)

    def _accumulate(self, acc: list, grads) -> None:
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g.float())

    def _backward(self, x: torch.Tensor, cot: torch.Tensor):
        """Recompute the stage from its input ``x`` under autograd and
        pull ``cot`` (and the aux seed) back: accumulates the parameter
        gradients, returns the input's cotangent."""
        xg = x.detach().requires_grad_()
        with torch.enable_grad():
            y, aux = self.fn(xg)
        return self._pull(xg, y, aux, cot)

    def _pull(self, xg, y, aux, cot):
        outs, seeds = [y], [cot]
        if aux.requires_grad:
            outs.append(aux)
            seeds.append(torch.full_like(aux, self.aux_weight
                                         * self.seed_scale))
        torch.autograd.backward(outs, seeds, inputs=[xg] + self.params)
        dx, xg.grad = xg.grad, None
        return torch.zeros_like(xg) if dx is None else dx

    def tick(self, t: int, fwd_in: Optional[torch.Tensor],
             bwd_in: Optional[torch.Tensor]) -> tuple:
        """Tick ``t``: returns (activation for stage ``s + 1``, cotangent
        for stage ``s - 1``), each None where nothing is sent."""
        s, K = self.s, self.K
        m_b = bwd_microbatch(s, t, self.n)
        live_b = self.live_b(t)
        x_saved = None
        if live_b and not self.last:
            # Read (and free) the backward's slot before the forward
            # writes this tick's: at stage 0 the two coincide mod K.
            x_saved, self.ring[m_b % K] = self.ring[m_b % K], None
        m_f = fwd_microbatch(s, t)
        y_out = dx = None
        if self.live_f(t):
            x_in = self.mbs[m_f] if s == 0 else fwd_in
            if self.last:
                dx = self._last_tick(x_in, m_f)
            else:
                with torch.no_grad():
                    y_out, aux = self.fn(x_in)
                self.aux_acc += aux.float()
                self.ring[m_f % K] = x_in
        if live_b and not self.last:
            dx = self._backward(x_saved, bwd_in)
        if live_b and s == 0:
            self.dmbs[m_b] = dx
        return y_out, (dx if s > 0 else None)

    def _last_tick(self, x_in: torch.Tensor, m: int) -> torch.Tensor:
        xg = x_in.detach().requires_grad_()
        with torch.enable_grad():
            y, aux = self.fn(xg)
            yd = y.detach().requires_grad_()
            lval = self.head(yd, m)
        hg = torch.autograd.grad(
            lval, self.head_params + [yd],
            torch.full_like(lval, self.seed_scale), allow_unused=True)
        self._accumulate(self.hacc, hg[:-1])
        self.loss_acc += lval.detach().float()
        self.aux_acc += aux.detach().float()
        return self._pull(xg, y, aux, hg[-1])

    def result(self) -> StageResult:
        return StageResult(self.loss_acc, self.aux_acc, self.gacc, self.hacc,
                           self.dmbs)

    def saved_inputs(self) -> int:
        """Inputs held in the ring now (at most K)."""
        return sum(x is not None for x in self.ring)


def _run_1f1b(stage: OneFOneBStage, tr: GroupTransport) -> None:
    fwd_buf = bwd_buf = None
    s = stage.s
    for t in range(stage.M + stage.K):
        y, dx = stage.tick(t, fwd_buf, bwd_buf)
        sends = [(p, x) for p, x in ((s + 1, y), (s - 1, dx))
                 if x is not None]
        rf, rb = stage.receives_fwd(t), stage.receives_bwd(t)
        got = tr.exchange(sends, [(p, stage.like) for p, r in
                                  ((s - 1, rf), (s + 1, rb)) if r])
        fwd_buf = got.pop(0) if rf else None
        bwd_buf = got.pop(0) if rb else None


def pipeline_train_local(stage_fn: Callable, stage_params: list,
                         microbatches, loss_head: Callable,
                         head_params: list, *, group,
                         aux_weight: float = 0.0, seed_scale: float = 1.0):
    """The 1F1B schedule on this rank's stage of the ``pp`` group
    ``group`` (see :class:`OneFOneBStage` for the arguments).

    Returns ``(loss, aux, d_microbatches, d_stage_params,
    d_head_params)`` for the microbatch mean: the loss summed over the
    pipeline (only the last stage holds it) over ``M``, the aux summed
    over the stages over ``M``; the cotangent of stage 0's inputs
    ``[M, mb, ...]`` on every stage, times ``1/M``; this stage's
    parameter gradients (fp32) times ``1/M``; the head's (fp32), summed
    over the stages, times ``1/M``."""
    tr = GroupTransport(group)
    stage = OneFOneBStage(tr.stage, tr.n, stage_fn, stage_params,
                          microbatches, loss_head, head_params,
                          aux_weight=aux_weight, seed_scale=seed_scale)
    try:
        _run_1f1b(stage, tr)
    finally:
        stage.close()
    r, M = stage.result(), stage.M
    inv_m = 1.0 / M
    last = stage.s == stage.n - 1
    loss = tr.sum(r.loss if last else torch.zeros_like(r.loss)) / M
    aux = tr.sum(r.aux) / M
    heads = [tr.sum(h) * inv_m for h in r.head_grads]
    shape = (M,) + tuple(stage.like.shape)
    d0 = (torch.stack(r.d_microbatches) if stage.s == 0 else
          stage.like.new_empty(shape))
    dmbs = tr.from_stage(d0, 0) * inv_m
    return loss, aux, dmbs, [g.mul_(inv_m) for g in r.grads], heads


def pipeline_train_stages(stages: Sequence[dict], microbatches, *,
                          aux_weight: float = 0.0, seed_scale: float = 1.0
                          ) -> list:
    """The 1F1B schedule of every stage in this process, handoffs in
    memory (the one-process driver).  ``stages[s]`` holds stage ``s``'s
    ``stage_fn`` and ``params``, the last one's also ``loss_head`` and
    ``head_params``.  Returns, for each stage, what
    :func:`pipeline_train_local` returns on its rank: the reductions over
    the stages run in memory in stage order (at two stages bitwise a
    two-rank all-reduce's sum)."""
    n = len(stages)
    objs = [OneFOneBStage(s, n, st["stage_fn"], st["params"], microbatches,
                          st.get("loss_head"), st.get("head_params", []),
                          aux_weight=aux_weight, seed_scale=seed_scale)
            for s, st in enumerate(stages)]
    M = objs[0].M
    fwd_in: list = [None] * n
    bwd_in: list = [None] * n
    try:
        for t in range(M + objs[0].K):
            outs = [st.tick(t, fwd_in[st.s], bwd_in[st.s]) for st in objs]
            fwd_in = [outs[s - 1][0] if objs[s].receives_fwd(t) else None
                      for s in range(n)]
            bwd_in = [outs[s + 1][1] if objs[s].receives_bwd(t) else None
                      for s in range(n)]
    finally:
        for st in objs:
            st.close()
    res = [st.result() for st in objs]
    inv_m = 1.0 / M

    def total(xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return acc

    loss = total([r.loss if s == n - 1 else torch.zeros_like(r.loss)
                  for s, r in enumerate(res)]) / M
    aux = total([r.aux for r in res]) / M
    nh = len(res[-1].head_grads)
    heads = [total([r.head_grads[i] if r.head_grads else
                    torch.zeros_like(res[-1].head_grads[i]) for r in res])
             * inv_m for i in range(nh)]
    dmbs = torch.stack(res[0].d_microbatches) * inv_m
    return [(loss, aux, dmbs, [g.mul_(inv_m) for g in r.grads], heads)
            for r in res]


def pipeline_chain(stage_fn: Callable, x: torch.Tensor, *, group
                   ) -> torch.Tensor:
    """One input through every stage in turn (no autograd; generation's
    stage-resident layers, a single microbatch): stage ``s`` receives
    from ``s - 1``, runs ``stage_fn`` (same shape out as in) and sends to
    ``s + 1``; the last stage's output comes back on every stage."""
    tr = GroupTransport(group)
    s, n = tr.stage, tr.n
    if s > 0:
        x = tr.exchange([], [(s - 1, x)])[0]
    y = stage_fn(x)
    if s < n - 1:
        tr.exchange([(s + 1, y)], [])
    return tr.from_stage(y, n - 1)
