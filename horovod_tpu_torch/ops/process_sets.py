"""Process sets: collectives over subgroups of ranks.

The port of ``horovod_tpu/ops/process_sets.py`` († ``horovod/common/
process_set.cc``, v0.23): a ``ProcessSet`` is a subset of global ranks
usable as ``process_set=`` on every verb.  Each set owns a
``torch.distributed`` group (``dist.new_group``), whose communicator NCCL
or Gloo builds for the members.

``dist.new_group`` is collective over the whole job: every rank creates
every set, in the same order, members or not — the same contract as
upstream's ``hvd.add_process_set``.  A rank outside a set holds it with
no group and may not pass it to a verb.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence


class ProcessSet:
    """Subgroup of global ranks usable with every collective verb."""

    def __init__(self, set_id: int, ranks: Sequence[int], state) -> None:
        import torch.distributed as dist
        self.set_id = set_id
        self.ranks = tuple(sorted(ranks))
        if len(set(self.ranks)) != len(self.ranks):
            raise ValueError(f"duplicate ranks in process set: {ranks}")
        if not self.ranks:
            raise ValueError("a process set needs at least one rank")
        for r in self.ranks:
            if not 0 <= r < state.size:
                raise ValueError(f"rank {r} out of range [0,{state.size})")
        if set_id == 0:
            self.group = dist.group.WORLD
        else:
            group = dist.new_group(list(self.ranks))
            self.group = group if state.rank in self.ranks else None

    def size(self) -> int:
        return len(self.ranks)

    def rank_of(self, global_rank: int) -> int:
        """Position of a global rank inside this set (†``ProcessSet::rank``)."""
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            raise ValueError(
                f"global rank {global_rank} not in process set "
                f"{self.ranks}") from None

    def included(self, global_rank: int) -> bool:
        return global_rank in self.ranks

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.set_id}, ranks={self.ranks})"


class ProcessSetTable:
    """Registry of process sets († ``process_set.cc ProcessSetTable``).

    Set id 0 is the implicit global set containing every rank.
    """

    def __init__(self, state) -> None:
        self._state = state
        self._lock = threading.Lock()
        self._next_id = 1
        self.global_set = ProcessSet(0, range(state.size), state)
        self._table: Dict[int, ProcessSet] = {0: self.global_set}

    def add(self, ranks: Sequence[int]) -> ProcessSet:
        with self._lock:
            ps = ProcessSet(self._next_id, ranks, self._state)
            self._table[ps.set_id] = ps
            self._next_id += 1
            return ps

    def remove(self, ps: ProcessSet) -> None:
        if ps.set_id == 0:
            raise ValueError("cannot remove the global process set")
        with self._lock:
            self._table.pop(ps.set_id, None)

    def get(self, set_id: int) -> Optional[ProcessSet]:
        with self._lock:
            return self._table.get(set_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)
