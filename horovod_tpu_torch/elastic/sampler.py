"""ElasticSampler: rank-sharded data order that survives membership changes.

A copy of ``horovod_tpu/elastic/sampler.py``.

† ``horovod/torch/elastic/sampler.py``: shards indices across ranks,
tracks processed indices, and on reset (new world size) re-shards only the
*remaining* indices so no sample is dropped or double-seen within an epoch.
Framework-agnostic here (yields integer indices; works for any data source).
"""

from __future__ import annotations

import random
from typing import Iterator, Optional


class ElasticSampler:
    def __init__(self, num_samples: int, *, shuffle: bool = True,
                 seed: int = 0) -> None:
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed: set[int] = set()
        self.rank = 0
        self.world_size = 1
        self._indices: list[int] = []
        self.reset()

    # -- membership ---------------------------------------------------------
    def set_rank_size(self, rank: int, world_size: int) -> None:
        self.rank = rank
        self.world_size = world_size
        self.reset()

    def reset(self) -> None:
        """Recompute this rank's shard over the remaining indices
        († ``ElasticSampler.reset``); called after re-rendezvous."""
        remaining = [i for i in range(self.num_samples)
                     if i not in self.processed]
        if self.shuffle:
            rng = random.Random(self.seed + self.epoch)
            rng.shuffle(remaining)
        self._indices = remaining[self.rank::self.world_size]

    def set_epoch(self, epoch: int) -> None:
        """New epoch: clear progress, reshuffle († ``set_epoch``)."""
        self.epoch = epoch
        self.processed.clear()
        self.reset()

    def record_batch(self, batch_indices) -> None:
        """Mark indices processed (call at commit points so restored state
        matches the committed position)."""
        self.processed.update(int(i) for i in batch_indices)
        self._indices = [i for i in self._indices
                         if i not in self.processed]

    # -- state for elastic State objects ------------------------------------
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "processed": sorted(self.processed)}

    def load_state_dict(self, sd: dict) -> None:
        self.epoch = sd["epoch"]
        self.processed = set(sd["processed"])
        self.reset()

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[int]:
        return iter(list(self._indices))

    def __len__(self) -> int:
        return len(self._indices)
