"""GPU-cluster host discovery: the job's host list from the SLURM
allocation it runs in, instead of a hand-written ``-H`` spec.

The port's counterpart of the JAX package's ``runner/cloud.py``, which
reads a TPU-VM slice's workers from the GCE metadata server († the
``driver_service`` role of auto host inventory).  A GPU cluster's
inventory is its scheduler's: inside an allocation SLURM exports

- ``SLURM_JOB_NODELIST``, the nodes in SLURM's compressed syntax
  (``gpu[01-03,07],login1``: bracketed lists and ranges, zero padding
  kept, several bracket groups in one name expanding to their product);
- ``SLURM_TASKS_PER_NODE`` (``4(x2),2``: four tasks on each of the
  first two nodes, two on the third);
- ``SLURM_NODEID``, this node's index in the list.

A rank drives one card, and a GPU job asks SLURM for one task a card, so
a node's slots are its entry of ``SLURM_TASKS_PER_NODE`` (1 without
one); ``default_slots`` (the launcher's ``--slots``, as the JAX
package's ``--tpu-pod`` takes it) sets every node's count instead.
An MPI hostfile is not read: ``-H`` takes the same hosts.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

from .hosts import HostSlots


class SlurmUnavailable(RuntimeError):
    """Not inside a SLURM allocation (or its variables are malformed)."""


def _split_top(spec: str) -> List[str]:
    """``spec`` split at the commas outside brackets."""
    parts, depth, cur = [], 0, []
    for ch in spec:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
            if depth < 0:
                raise SlurmUnavailable(f"unbalanced ']' in {spec!r}")
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth:
        raise SlurmUnavailable(f"unbalanced '[' in {spec!r}")
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _expand_range(item: str, spec: str) -> List[str]:
    lo, sep, hi = item.partition("-")
    if not lo.isdigit() or (sep and not hi.isdigit()):
        raise SlurmUnavailable(f"bad range {item!r} in {spec!r}")
    if not sep:
        return [lo]
    if int(hi) < int(lo):
        raise SlurmUnavailable(f"descending range {item!r} in {spec!r}")
    width = len(lo)                     # "01-03": the padding of the low end
    return [str(i).zfill(width) for i in range(int(lo), int(hi) + 1)]


def expand_nodelist(spec: str) -> List[str]:
    """The host names of a SLURM node list, in its order."""
    hosts: List[str] = []
    for name in _split_top(spec):
        m = re.search(r"\[([^\[\]]*)\]", name)
        if m is None:
            hosts.append(name)
            continue
        head, tail = name[:m.start()], name[m.end():]
        for item in m.group(1).split(","):
            for value in _expand_range(item.strip(), spec):
                hosts.extend(expand_nodelist(head + value + tail))
    return hosts


def parse_tasks_per_node(spec: str) -> List[int]:
    """``SLURM_TASKS_PER_NODE`` as one count a node: ``4(x2),2`` is
    ``[4, 4, 2]``."""
    counts: List[int] = []
    for part in spec.split(","):
        m = re.fullmatch(r"\s*(\d+)(?:\(x(\d+)\))?\s*", part)
        if m is None:
            raise SlurmUnavailable(f"bad SLURM_TASKS_PER_NODE {spec!r}")
        counts.extend([int(m.group(1))] * int(m.group(2) or 1))
    return counts


def slurm_hosts(default_slots: Optional[int] = None) -> List[HostSlots]:
    """The hosts of the SLURM allocation this process runs in, with their
    slots (module docstring).  Raises :class:`SlurmUnavailable`, naming
    ``-H``, outside an allocation."""
    spec = os.environ.get("SLURM_JOB_NODELIST")
    if not spec:
        raise SlurmUnavailable(
            "SLURM_JOB_NODELIST is not set: not inside a SLURM allocation? "
            "Pass -H host:slots explicitly.")
    nodes = expand_nodelist(spec)
    if not nodes:
        raise SlurmUnavailable(f"SLURM_JOB_NODELIST {spec!r} names no host")
    if default_slots:
        slots = [default_slots] * len(nodes)
    elif os.environ.get("SLURM_TASKS_PER_NODE"):
        slots = parse_tasks_per_node(os.environ["SLURM_TASKS_PER_NODE"])
        if len(slots) != len(nodes):
            raise SlurmUnavailable(
                f"SLURM_TASKS_PER_NODE gives {len(slots)} counts for "
                f"{len(nodes)} nodes")
    else:
        slots = [1] * len(nodes)
    return [HostSlots(h, s) for h, s in zip(nodes, slots)]


def worker_number() -> Optional[int]:
    """This node's index in the allocation (``SLURM_NODEID``)."""
    try:
        return int(os.environ["SLURM_NODEID"])
    except (KeyError, ValueError):
        return None
