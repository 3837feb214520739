"""The serving loop: prefill and decode steps over the page pool.

Transport half of the policy/transport split (the scheduler decides what
runs; this owns how it runs on the device):

- **Page pool** — ``[L, num_blocks, block_size, KV, Dh]`` K and V
  tensors, allocated once on the engine's device; the decode step writes
  them in place and the prefill scatter copies whole pages into them.
- **Bucketed shapes** — prompts may be right-padded to a bucket length
  and decode block tables are padded to a power-of-two column count, as
  in the JAX package (there they bound recompiles; here they keep the
  decode kernel's launch shapes few).
- **Fixed decode batch** — the decode step always runs ``max_active``
  slots; inactive slots carry token 0 at position 0 against an
  all-scratch block table (block 0 is reserved), so their masked writes
  are harmless and their logits are ignored.
- **Greedy decode** — token-identical to the JAX package's engine on the
  same parameters (asserted in ``tests/test_torch_serving.py``).

Decode attention goes through the paged decode kernel
(:func:`~horovod_tpu_torch.ops.flash_attention.paged_attention`) or the
gather path, chosen by :attr:`EngineConfig.use_flash`.  Sharded serving,
the prefix cache, speculative decoding and KV migration wait for later
slices of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from .. import chaos
from .. import context
from ..models import llama
from ..obs import REGISTRY as _obs
from ..obs import trace as _trace
from ..ops import flash_attention as FA
from ..utils import logging as hvd_logging
from .kv_pager import KVPager, OutOfBlocks, PagedKVCache
from .scheduler import Request, RequestState, Scheduler

log = hvd_logging.get_logger()

# Serving-plane health (horovod_tpu_torch.obs), sampled once per step():
_m_queue_depth = _obs.gauge(
    "hvd_serving_queue_depth", "requests waiting for admission")
_m_occupancy = _obs.gauge(
    "hvd_serving_batch_occupancy",
    "active decode slots / max_active (1.0 = the decode batch is full)")
_m_kv_util = _obs.gauge(
    "hvd_serving_kv_utilization",
    "allocated pool blocks / usable blocks (block 0 is scratch)")
_m_steps = _obs.counter(
    "hvd_serving_steps_total", "serving rounds executed")
_m_prefill_tokens = _obs.counter(
    "hvd_serving_prefill_tokens_total", "prompt tokens prefilled")
_m_decode_tokens = _obs.counter(
    "hvd_serving_decode_tokens_total", "tokens emitted by decode ticks")

_WAITS = "waits for a later slice of the port"


def _bucket_pow2(n: int, floor: int = 1) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _paged_kernel_path(device: torch.device, use_flash: str,
                       block_size: int, head_dim: int) -> bool:
    """Whether decode attention takes the paged kernel path (else the
    gather path).  "never" is the caller's choice of the gather path.
    Under "auto" a CUDA device must take the kernel, so a pool geometry
    outside :func:`~horovod_tpu_torch.ops.flash_attention.paged_supported`
    raises there; on the CPU it takes the gather path, as the JAX
    engine's selection does."""
    if use_flash == "never":
        return False
    if FA.paged_supported(block_size, head_dim):
        return True
    if device.type == "cuda":
        raise ValueError(
            f"the paged decode kernel needs block_size % 8 == 0 and "
            f"head_dim <= 256; got block_size={block_size}, "
            f"head_dim={head_dim} (use_flash='never' takes the gather path)")
    return False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-engine knobs (model geometry comes from ``LlamaConfig``)."""

    #: tokens per KV block (pool page size)
    block_size: int = 16
    #: total pool blocks (block 0 is scratch; device memory budget knob)
    num_blocks: int = 128
    #: decode slots — the fixed decode batch
    max_active: int = 8
    #: max prompt tokens admitted to prefill per step (bounds the latency
    #: a decode tick can see; an over-budget prompt still runs, alone)
    prefill_token_budget: int = 512
    #: round prompt lengths up to one of these; empty = exact lengths
    prefill_buckets: tuple = ()
    #: "auto" (the paged decode kernel for CUDA tensors, which raises for
    #: a pool geometry the kernel does not take; for CPU tensors its plain
    #: version, or the gather path for such a geometry, as in the JAX
    #: package) or "never" (the gather path)
    use_flash: str = "auto"
    #: radix prefix cache — waits for the front-door slice
    prefix_cache: bool = False
    #: cap on blocks the cache may pin — waits with the prefix cache
    prefix_cache_max_blocks: Optional[int] = None
    #: speculative decoding draft tokens per round — waits for the
    #: front-door slice (0 = off)
    spec_k: int = 0


class ServingEngine:
    """Continuous-batching engine over one model + page pool.

    Drive it with :meth:`submit` + :meth:`step` (one scheduler round:
    retire, admit+prefill, decode tick); :meth:`run` loops until idle.
    Emitted tokens reach the caller through ``Request.generated`` and the
    per-token callbacks the API layer wires in.  ``device`` is where the
    pool lives and the steps run (default: the process's card); the
    parameters must already be there.
    """

    def __init__(self, params: Any, cfg: llama.LlamaConfig, *,
                 engine_cfg: EngineConfig = EngineConfig(),
                 mesh=None, timeline=None, device=None,
                 draft_params: Any = None,
                 draft_cfg: Optional[llama.LlamaConfig] = None) -> None:
        #: Timeline-v2 sink request traces render on (one lane per
        #: request with QUEUE->PREFILL->DECODE flow arrows); None keeps
        #: traces JSON/flight-recorder-only.
        self.timeline = timeline
        if cfg.use_moe:
            raise NotImplementedError(f"serving MoE configs {_WAITS}")
        if mesh is not None:
            raise NotImplementedError(f"sharded serving (mesh=) {_WAITS}")
        if engine_cfg.prefix_cache \
                or engine_cfg.prefix_cache_max_blocks is not None:
            raise NotImplementedError(f"the prefix cache {_WAITS}")
        if engine_cfg.spec_k or draft_params is not None \
                or draft_cfg is not None:
            raise NotImplementedError(f"speculative decoding {_WAITS}")
        if engine_cfg.use_flash not in ("auto", "never"):
            raise ValueError(
                f"use_flash must be 'auto' or 'never', got "
                f"{engine_cfg.use_flash!r} (the Pallas interpreter mode has "
                f"no counterpart here)")
        self.device = context.device(device)
        for name, t in (("embed", params["embed"]),
                        ("layers.wq", params["layers"]["wq"])):
            if t.device != self.device:
                raise ValueError(
                    f"params[{name!r}] is on {t.device}; the engine runs on "
                    f"{self.device}")
        # On a CUDA device the kernel path launches the CUDA kernel; on
        # the CPU it runs the kernel's plain version.
        self._use_flash = _paged_kernel_path(
            self.device, engine_cfg.use_flash, engine_cfg.block_size,
            cfg.head_dim)
        self.params = params
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.mesh = None

        self.cache = PagedKVCache(
            n_layers=cfg.n_layers, num_blocks=engine_cfg.num_blocks,
            block_size=engine_cfg.block_size, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim)
        self.pager = KVPager(self.cache)
        self.prefix_cache = None
        self.scheduler = Scheduler(
            self.pager, max_active=engine_cfg.max_active,
            prefill_token_budget=engine_cfg.prefill_token_budget)

        self.k_pool = torch.zeros(self.cache.shape, dtype=cfg.dtype,
                                  device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)

        self._slots: list[Optional[Request]] = \
            [None] * engine_cfg.max_active
        self._next_id = 0
        self._steps = 0
        #: decode ticks run (each launches one attention per layer)
        self.decode_ticks = 0

    # -- step bodies -----------------------------------------------------
    def _prefill(self, tokens: torch.Tensor, last_pos: torch.Tensor):
        logits, ks, vs = llama.prefill_step(
            self.params, tokens, self.cfg, last_pos=last_pos)
        return torch.argmax(logits, dim=-1), ks, vs

    @torch.no_grad()
    def _scatter(self, ks: torch.Tensor, vs: torch.Tensor,
                 blocks: list[int]) -> None:
        """Write one request's prefill K/V ([L, 1, P, KV, Dh]) into its
        pool blocks, in place.  P is padded up to a whole number of
        blocks; the tail slots hold pad K/V, masked by position until
        decode overwrites them one at a time."""
        L, _, P = ks.shape[:3]
        BS = self.cache.block_size
        nb = len(blocks)
        pad = nb * BS - P
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for src, pool in ((ks, self.k_pool), (vs, self.v_pool)):
            x = torch.nn.functional.pad(src[:, 0], (0, 0, 0, 0, 0, pad))
            pool[:, idx] = x.reshape(L, nb, BS, *x.shape[2:])

    def _decode(self, tok, pos, tables):
        logits, _, _ = llama.decode_step_paged(
            self.params, tok, pos, self.k_pool, self.v_pool, tables,
            self.cfg, use_flash=self._use_flash)
        return torch.argmax(logits, dim=-1)

    # -- public surface --------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, eos_token=None,
               stream_cb=None, migrate_cb=None, trace_ctx=None) -> Request:
        # Chaos site: admission.  err rejects the request before it
        # queues (the caller sees the raise, nothing leaks into the
        # scheduler); delay throttles intake.
        chaos.fire("serving_admit")
        if migrate_cb is not None:
            raise NotImplementedError(
                f"KV migration (migrate_cb) {_WAITS}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        need = self.cache.blocks_for(int(prompt.size) + 1)
        usable = self.cache.num_blocks - 1
        if need > usable:
            # Reject up front: an unfillable prompt at the head of the
            # strictly-FIFO queue would otherwise livelock admission.
            raise ValueError(
                f"prompt of {prompt.size} tokens needs {need} blocks; the "
                f"pool only has {usable} (raise num_blocks/block_size)")
        req = Request(req_id=self._next_id, prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_token=eos_token,
                      stream_cb=stream_cb)
        self._next_id += 1
        # Admission is the root of the request's causal chain: one trace
        # id covers every phase span from here to the terminal state.
        # trace_ctx joins a trace started upstream instead of opening a
        # fresh one.
        req.trace = _trace.TRACER.start_trace(
            "serving.request", lane=f"req{req.req_id}",
            timeline=self.timeline, parent=trace_ctx, req_id=req.req_id,
            prompt_len=int(prompt.size), max_new_tokens=max_new_tokens)
        self.scheduler.submit(req)
        return req

    def import_migrated(self, *args, **kwargs):
        raise NotImplementedError(f"KV migration (import_migrated) {_WAITS}")

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def pop_failed(self) -> list:
        """Requests the scheduler declared unrunnable, as ``(request,
        exception)`` pairs — callers fail their futures."""
        failed = self.scheduler.failed
        self.scheduler.failed = []
        return failed

    def step(self) -> list[tuple[Request, int]]:
        """One serving round; returns the (request, token) emissions.

        A raise out of here (device failure, injected fault) leaves the
        scheduler/pager bookkeeping consistent enough for
        :meth:`abort_inflight` — the session layer catches, aborts the
        in-flight set with an ``error`` finish_reason, flips health, and
        resumes instead of dying."""
        # Chaos site: one traversal per serving round (decode step).
        chaos.fire("serving_step")
        emitted: list[tuple[Request, int]] = []
        self._steps += 1
        _m_steps.inc()
        for req in self.scheduler.admit():
            self._assign_slot(req)
            _m_prefill_tokens.inc(int(req.prefill_tokens.shape[0]))
            emitted.append((req, self._prefill_one(req)))
        if self.scheduler.running:
            ticked = self._decode_tick()
            _m_decode_tokens.inc(len(ticked))
            emitted.extend(ticked)
        self._sample_gauges()
        return emitted

    def _sample_gauges(self) -> None:
        _m_queue_depth.set(len(self.scheduler.waiting))
        _m_occupancy.set(
            len(self.scheduler.running) / self.ecfg.max_active)
        usable = self.cache.num_blocks - 1
        _m_kv_util.set((usable - self.pager.free_blocks) / usable)

    def run(self, max_steps: Optional[int] = None
            ) -> list[tuple[Request, int]]:
        """Steps until the queue drains; returns all emissions in order."""
        out: list[tuple[Request, int]] = []
        n = 0
        while self.has_work():
            out.extend(self.step())
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return out

    # -- internals -------------------------------------------------------
    def _assign_slot(self, req: Request) -> None:
        i = self._slots.index(None)
        self._slots[i] = req

    def _drop_slot(self, req: Request) -> None:
        self._slots[self._slots.index(req)] = None

    def _sync_slots(self) -> None:
        """Preemption inside scheduler.grow() removes requests from the
        running set behind the engine's back; drop their slots."""
        running = set(id(r) for r in self.scheduler.running)
        for i, r in enumerate(self._slots):
            if r is not None and id(r) not in running:
                self._slots[i] = None

    def _bucket_len(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        return n

    def _prefill_one(self, req: Request) -> int:
        toks = req.prefill_tokens
        P = int(toks.shape[0])
        Pb = self._bucket_len(P)
        sp = req.open_phase("prefill", tokens=P, bucket=Pb)
        # The span is the context's current span while the prefill runs,
        # so nested layers attach their events to this request's chain.
        with sp.use():
            padded = np.zeros((1, Pb), np.int32)
            padded[0, :P] = toks
            tok, ks, vs = self._prefill(
                torch.from_numpy(padded).to(self.device),
                torch.tensor([P - 1], device=self.device))
            blocks = self.pager.table(req.req_id)
            nb = self.cache.blocks_for(P)
            # Only the blocks the P real positions span are written; the
            # +1 slot block (for the emitted token) is untouched here.
            lim = min(Pb, nb * self.cache.block_size)
            self._scatter(ks[:, :, :lim], vs[:, :, :lim], blocks[:nb])
            token = int(tok[0])
        req.close_phase("prefill")
        token = self._emit(req, token)
        if req.state == RequestState.RUNNING:
            # The decode phase opens once and spans every tick until the
            # terminal state (scheduler.finish/preempt closes it).
            req.open_phase("decode")
        return token

    def _decode_tick(self) -> list[tuple[Request, int]]:
        # Reserve the write position for every running request first —
        # growth can preempt, shrinking the running set.
        for req in list(self.scheduler.running):
            if req in self.scheduler.running:
                try:
                    self.scheduler.grow(req)
                except OutOfBlocks as e:
                    # Only reachable when req cannot fit even alone
                    # (grow preempts every other victim first): fail
                    # THIS request and keep the batch serving.
                    self.scheduler.fail_running(req, e)
        self._sync_slots()
        active = [r for r in self._slots if r is not None]
        if not active:
            return []
        R = self.ecfg.max_active
        need_cols = max(
            self.cache.blocks_for(r.context_len + 1) for r in active)
        n_cols = min(_bucket_pow2(need_cols), self.cache.num_blocks)
        tok = np.zeros((R,), np.int32)
        pos = np.zeros((R,), np.int32)
        ids = [-1] * R
        for i, r in enumerate(self._slots):
            if r is None:
                continue
            tok[i] = r.generated[-1]
            pos[i] = r.context_len
            ids[i] = r.req_id
        tables = self.pager.table_matrix(ids, n_cols)
        nxt = self._decode(torch.from_numpy(tok).to(self.device),
                           torch.from_numpy(pos).to(self.device),
                           torch.from_numpy(tables).to(self.device))
        self.decode_ticks += 1
        nxt = nxt.cpu().numpy()
        emitted = []
        for i, r in enumerate(list(self._slots)):
            if r is None:
                continue
            r.context_len += 1          # this tick wrote pos[i]
            emitted.append((r, self._emit(r, int(nxt[i]))))
        return emitted

    def _emit(self, req: Request, token: int) -> int:
        req.generated.append(token)
        eos = req.eos_token is not None and token == req.eos_token
        done = eos or len(req.generated) >= req.max_new_tokens
        if done:
            req.finish_reason = "stop" if eos else "length"
            self.scheduler.finish(req)
            self._drop_slot(req)
        return token

    def abort_inflight(self, exc: BaseException) -> list[Request]:
        """Graceful-degradation half of a step failure: finish every
        queued and running request NOW with ``finish_reason="error"``
        (partial tokens preserved), release their pool blocks, and leave
        the engine empty and reusable.  Returns the aborted requests."""
        aborted: list[Request] = []
        for req in list(self.scheduler.running):
            self.scheduler.running.remove(req)
            self.pager.release(req.req_id)
            aborted.append(req)
        while self.scheduler.waiting:
            aborted.append(self.scheduler.waiting.popleft())
        for req in aborted:
            req.state = RequestState.CANCELLED
            req.finish_reason = "error"
            req.t_finished = time.monotonic()
            req.close_trace("aborted", error=str(exc))
        self._slots = [None] * self.ecfg.max_active
        self._sample_gauges()
        return aborted
