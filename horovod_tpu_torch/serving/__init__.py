"""Continuous-batching inference over a block-paged KV cache, in PyTorch.

The port of ``horovod_tpu/serving``'s single-replica path:

- :mod:`~horovod_tpu_torch.serving.kv_pager` — the block allocator with
  refcounted per-request tables, and :func:`gather_blocks`;
- :mod:`~horovod_tpu_torch.serving.scheduler` — FIFO admission under a
  prefill token budget, per-step join/evict, LIFO preemption;
- :mod:`~horovod_tpu_torch.serving.engine` — prefill and decode steps over
  the page pool, decode attention through the paged decode CUDA kernel;
- :mod:`~horovod_tpu_torch.serving.api` — ``serve()``: ``submit()``
  futures, streaming token callbacks, per-request TTFT / queue-wait /
  tok/s metrics.

The front door (router, prefix cache, speculative decoding) and
disaggregated prefill/decode wait for later slices of the port.
"""

from .api import RequestResult, ServingSession, serve  # noqa: F401
from .engine import EngineConfig, ServingEngine  # noqa: F401
from .kv_pager import KVPager, PagedKVCache, gather_blocks  # noqa: F401
from .scheduler import Request, Scheduler  # noqa: F401
