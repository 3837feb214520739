"""The serving front door's single-replica half: radix prefix KV reuse and
speculative decoding.

- :mod:`.prefix_cache` — a radix-tree prefix cache over the
  :class:`~horovod_tpu_torch.serving.kv_pager.KVPager`, so shared prompt
  prefixes skip prefill (block-granular refcounted sharing);
- :mod:`.spec_decode` — draft-model speculative decoding as a scheduler
  mode: draft k tokens with a small model, verify in one target forward
  over the paged cache, accept the agreeing prefix, roll back the rest.

Both are turned on through ``serve(prefix_cache=True)`` and
``serve(spec_k=k, draft_params=..., draft_cfg=...)``.  The JAX package's
router and request transport, which place requests across replicas, wait
for the parallel slice of the port.
"""

from .prefix_cache import PrefixCache
from .spec_decode import SpecDecoder

__all__ = ["PrefixCache", "SpecDecoder"]
