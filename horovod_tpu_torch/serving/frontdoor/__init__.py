"""The serving front door: multi-replica routing, radix prefix KV reuse,
speculative decoding.

Three cooperating pieces behind one :class:`Router` entry point:

- :mod:`.router` — admits requests and places them across serving
  replicas by the signals the obs plane already publishes to the job KV
  store (queue depth, TTFT p99, SLO burn rate, readiness), with
  prefix-affinity stickiness and health-aware failover;
- :mod:`.prefix_cache` — a radix-tree prefix cache over the
  :class:`~horovod_tpu_torch.serving.kv_pager.KVPager`, so shared prompt
  prefixes skip prefill (block-granular refcounted sharing);
- :mod:`.spec_decode` — draft-model speculative decoding as a scheduler
  mode: draft k tokens with a small model, verify in one target forward
  over the paged cache, accept the agreeing prefix, roll back the rest.

:mod:`.transport` carries requests between a router process and replica
processes over the job's existing authenticated KV store
(:class:`~.transport.ReplicaServer`, :class:`~.transport.KVReplicaClient`)
— the same "no new network surface" rule the obs plane follows;
:class:`LocalReplica` is its in-process twin.  The prefix cache and
speculation are turned on through ``serve(prefix_cache=True)`` and
``serve(spec_k=k, draft_params=..., draft_cfg=...)``.
"""

from .prefix_cache import PrefixCache
from .router import (LocalReplica, NoReplicaAvailable, Router,
                     RouterConfig)
from .spec_decode import SpecDecoder

__all__ = [
    "LocalReplica", "NoReplicaAvailable", "PrefixCache", "Router",
    "RouterConfig", "SpecDecoder",
]
