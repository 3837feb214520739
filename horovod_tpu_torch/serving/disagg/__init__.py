"""Disaggregated prefill/decode serving.

Prefill (compute-bound, bursty, TTFT-sensitive) and decode
(memory-bound, steady, ITL-sensitive) have opposite resource shapes;
sharing one replica queue lets a prefill burst stall every decode tick
behind it.  This package splits the replica fleet into two pools:

- a **prefill replica** admits a request, fills its pager blocks, emits
  the first token, then exports the blocks as a versioned manifest +
  chunked K/V payloads over the KV-store transport
  (:mod:`.transport`);
- a **decode replica** imports them through the same refcounted-block /
  longest-prefix machinery the radix prefix cache uses
  (:mod:`.migration` — zero re-prefill) and continues decoding
  token-identically (greedy decode is deterministic);
- the :class:`~.router.DisaggRouter` owns pool-aware placement (prefill
  pool scored on TTFT burn + queue depth, decode pool on ITL p99 +
  occupancy) and the migration handoff as first-class state:
  ``prefilling -> migrating -> decoding``, with failover at any stage
  replaying token-identically from the last durable point (the
  published manifest, or the original prompt when none exists yet).

Pool membership is a tag on the replica's published membership record
(``HVDTPU_SERVING_POOL`` = ``prefill`` | ``decode`` | ``mixed``), and
the autoscale controller scales the two pools independently
(pool-filtered ``signals_from_families`` +
``hvd_autoscale_target_np{pool=...}``).
"""

from .migration import MANIFEST_SCHEMA, export_request, import_request
from .router import DisaggRouter, DisaggRouterConfig, LocalDisaggReplica
from .transport import (DictKV, MigrationUnavailable, delete_migration,
                        fetch_migration, migration_published,
                        publish_migration)

__all__ = [
    "MANIFEST_SCHEMA", "export_request", "import_request",
    "DisaggRouter", "DisaggRouterConfig", "LocalDisaggReplica",
    "DictKV", "MigrationUnavailable",
    "publish_migration", "fetch_migration", "migration_published",
    "delete_migration",
]
