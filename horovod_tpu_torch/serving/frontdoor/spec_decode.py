"""Draft-model speculative decoding as a scheduler mode.

A port of the JAX package's ``serving/frontdoor/spec_decode.py``.  Per
round, for every running request (the whole fixed decode batch at once):

1. **draft** — a small llama config decodes ``k`` tokens sequentially
   over its OWN page pools (same ``num_blocks``/``block_size`` geometry
   as the target, so both models index the pool through the SAME block
   tables — one allocator, two pools).  The draft's decode reads its pool
   through the gather path (``use_flash=False``), as the reference's does;
2. **verify** — ONE target forward
   (:func:`horovod_tpu_torch.models.llama.extend_step_paged`) over the
   ``k + 1`` tokens ``[t_last, d_1..d_k]`` at positions ``C..C+k``
   yields the target's greedy token ``g_j`` after every prefix;
3. **accept** — the agreeing prefix ``d_1..d_m`` (``d_i == g_{i-1}``)
   is emitted plus the bonus token ``g_m``, so every round emits at
   least one token and the emitted stream equals target-only greedy
   decoding exactly, whatever the draft's quality;
4. **roll back** — the table is truncated to the accepted context via
   :meth:`KVPager.truncate`, so rejected positions' stale K/V can never
   be read: positions inside kept blocks are overwritten by the next
   round's contiguous writes before anything attends that far, and whole
   rejected blocks go back to the free list.

The drafts stay on the device through the round: the draft tokens and
the target's verify tokens come to the host together, once, after the
verify (the reference reads each draft token back as it comes, one host
synchronisation per draft token on a card).

The draft mirrors every context-building step of the target (prompt
prefill, prefix-hit tail prefill) into its own pools; because the prefix
cache pins block ids and a shared prefix always occupies the same
absolute positions, the draft-pool contents under pinned blocks stay
valid for every request that matches the prefix.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models import llama
from ...obs import REGISTRY as _obs
from ..kv_pager import OutOfBlocks, PagedKVCache
from ..scheduler import RequestState

_m_rounds = _obs.counter(
    "hvd_spec_rounds_total", "speculative draft/verify rounds executed")
_m_drafted = _obs.counter(
    "hvd_spec_tokens_drafted_total", "draft tokens proposed")
_m_accepted = _obs.counter(
    "hvd_spec_tokens_accepted_total",
    "draft tokens the target verified and accepted")
_m_accept_rate = _obs.gauge(
    "hvd_spec_accept_rate",
    "cumulative accepted/drafted ratio of this engine")


class SpecDecoder:
    """Speculative-decode engine mode: owns the draft model, its page
    pools, and the per-round draft/verify/accept/rollback loop.  Built
    by :class:`~horovod_tpu_torch.serving.engine.ServingEngine` when
    ``EngineConfig.spec_k > 0``; the draft parameters must live on the
    engine's device."""

    def __init__(self, engine, draft_params, draft_cfg: llama.LlamaConfig,
                 *, k: int) -> None:
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        if draft_cfg.use_moe:
            raise NotImplementedError("draft model must be dense")
        if draft_cfg.vocab_size != engine.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{engine.cfg.vocab_size}: drafted ids must be target ids")
        from ..engine import check_params_device
        check_params_device(draft_params, engine.device, "draft_params")
        self.eng = engine
        self.k = int(k)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        # Same block geometry as the target pool -> shared block tables.
        self.cache = PagedKVCache(
            n_layers=draft_cfg.n_layers,
            num_blocks=engine.cache.num_blocks,
            block_size=engine.cache.block_size,
            kv_heads=draft_cfg.n_kv_heads, head_dim=draft_cfg.head_dim)
        self.dk_pool = torch.zeros(self.cache.shape, dtype=draft_cfg.dtype,
                                   device=engine.device)
        self.dv_pool = torch.zeros_like(self.dk_pool)
        self._drafted_total = 0
        self._accepted_total = 0
        #: rounds run by this engine
        self.rounds = 0

    def _decode(self, tok, pos, tables) -> torch.Tensor:
        logits, _, _ = llama.decode_step_paged(
            self.draft_params, tok, pos, self.dk_pool, self.dv_pool, tables,
            self.draft_cfg, use_flash=False)
        return torch.argmax(logits, dim=-1)

    # -- context mirroring ----------------------------------------------
    def mirror_prefill(self, req, padded: torch.Tensor, n_tokens: int
                       ) -> None:
        """Run the draft's prompt prefill and scatter its K/V into the
        draft pools under the request's (shared) block table — the
        draft-side twin of the engine's prefill and scatter."""
        eng = self.eng
        _, ks, vs = llama.prefill_step(
            self.draft_params, padded, self.draft_cfg,
            last_pos=torch.tensor([n_tokens - 1], device=eng.device))
        blocks = eng.pager.table(req.req_id)
        nb = self.cache.blocks_for(n_tokens)
        lim = min(padded.shape[1], nb * self.cache.block_size)
        eng._scatter(ks[:, :, :lim], vs[:, :, :lim], blocks[:nb],
                     (self.dk_pool, self.dv_pool))

    def mirror_extend(self, tok2, pos2, val2, tables) -> None:
        """Mirror a prefix-hit tail prefill into the draft pools (the
        cached head's draft K/V is already there from the insert-time
        request — pinned block ids are never reallocated)."""
        llama.extend_step_paged(
            self.draft_params, tok2, pos2, val2, self.dk_pool, self.dv_pool,
            tables, self.draft_cfg)

    # -- the round -------------------------------------------------------
    def tick(self) -> list:
        """One speculative round for the whole running set; returns the
        (request, token) emissions like ``ServingEngine._decode_tick``."""
        from ..engine import _bucket_pow2
        eng = self.eng
        sched = eng.scheduler
        k = self.k
        dev = eng.device
        # Reserve the whole round's write window (k drafts + bonus) up
        # front; rollback returns whatever goes unused.
        for req in list(sched.running):
            if req in sched.running:
                try:
                    sched.grow(req, k + 1)
                except OutOfBlocks as e:
                    sched.fail_running(req, e)
        eng._sync_slots()
        active = [r for r in eng._slots if r is not None]
        if not active:
            return []
        R = eng.ecfg.max_active
        need_cols = max(self.cache.blocks_for(r.context_len + k + 1)
                        for r in active)
        n_cols = min(_bucket_pow2(need_cols), self.cache.num_blocks)
        tok = np.zeros((R,), np.int32)
        pos = np.zeros((R,), np.int32)
        act = np.zeros((R,), bool)
        ids = [-1] * R
        for i, r in enumerate(eng._slots):
            if r is None:
                continue
            tok[i] = r.generated[-1]
            pos[i] = r.context_len
            act[i] = True
            ids[i] = r.req_id
        tables = torch.from_numpy(eng.pager.table_matrix(ids, n_cols)).to(dev)
        tok_t = torch.from_numpy(tok).to(dev)
        pos_t = torch.from_numpy(pos).to(dev)

        # 1. draft k tokens sequentially with the small model, on the
        #    device.
        drafts = []
        cur = tok_t
        for j in range(k):
            cur = self._decode(cur, pos_t + j, tables)
            drafts.append(cur)
        # Write d_k's K/V too (output discarded): a fully-accepted round
        # keeps position C+k in context, and without this write that
        # position would stay a hole the draft attends over forever.
        self._decode(cur, pos_t + k, tables)
        drafts_t = torch.stack(drafts, dim=1).to(tok_t.dtype)    # [R, k]

        # 2. verify all k+1 positions in one target forward.
        vtok = torch.cat([tok_t[:, None], drafts_t], dim=1)
        vpos = pos_t[:, None] + torch.arange(
            k + 1, dtype=pos_t.dtype, device=dev)[None, :]
        valid = torch.from_numpy(act).to(dev)[:, None].expand(R, k + 1)
        g = eng._extend(vtok, vpos, valid, tables)             # [R, k+1]
        both = torch.cat([drafts_t.long(), g.long()], dim=1).cpu().numpy()
        drafts, g = both[:, :k], both[:, k:]

        # 3./4. accept the agreeing prefix + bonus token, roll back rest.
        _m_rounds.inc()
        self.rounds += 1
        emitted = []
        for i, r in enumerate(list(eng._slots)):
            if r is None:
                continue
            m = 0
            while m < k and int(drafts[i, m]) == int(g[i, m]):
                m += 1
            _m_drafted.inc(k)
            _m_accepted.inc(m)
            self._drafted_total += k
            self._accepted_total += m
            C = r.context_len
            for t in [int(drafts[i, j]) for j in range(m)] + [int(g[i, m])]:
                emitted.append((r, eng._emit(r, t)))
                if r.state is not RequestState.RUNNING:
                    break                  # eos/length: blocks released
            if r.state is RequestState.RUNNING:
                r.context_len = C + m + 1
                eng.pager.truncate(r.req_id, r.context_len)
        if self._drafted_total:
            _m_accept_rate.set(self._accepted_total / self._drafted_total)
        return emitted
