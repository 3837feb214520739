"""Host-spec parsing († ``runner/common/util/hosts.py`` +
``runner/launch.py`` host handling).

Spec grammar: ``host1:slots1,host2:slots2`` (slots default 1), e.g.
``localhost:4`` or ``gpu-node-0:8,gpu-node-1:8``.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class HostSlots:
    hostname: str
    slots: int


def parse_hosts(spec: str) -> List[HostSlots]:
    out: List[HostSlots] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, slots = part.partition(":")
        if not host:
            raise ValueError(f"bad host entry {part!r} in {spec!r}")
        if sep:
            try:
                n = int(slots)
            except ValueError:
                raise ValueError(
                    f"bad slot count {slots!r} for host {host!r}") from None
            if n < 1:
                raise ValueError(f"slot count must be >= 1 for {host!r}")
        else:
            n = 1
        out.append(HostSlots(host, n))
    if not out:
        raise ValueError(f"no hosts in spec {spec!r}")
    return out


def assign_ranks(hosts: List[HostSlots], np_total: int
                 ) -> List[tuple[int, str, int]]:
    """(global_rank, hostname, local_rank) for each process, filling hosts
    in order († ``ElasticDriver.HostAssignment`` ordering semantics)."""
    total_slots = sum(h.slots for h in hosts)
    if np_total > total_slots:
        raise ValueError(
            f"requested np={np_total} exceeds {total_slots} available slots")
    out = []
    rank = 0
    for h in hosts:
        for local in range(h.slots):
            if rank >= np_total:
                return out
            out.append((rank, h.hostname, local))
            rank += 1
    return out


def host_hash(salt: str = "") -> str:
    """Stable identifier for THIS machine, for grouping ranks that share a
    host († ``runner/common/util/host_hash.py``: upstream hashes the
    hostname so ranks on one box agree on local-rank grouping even when
    launched under different names).

    ``HOROVOD_HOSTNAME`` overrides the detected hostname — the upstream
    escape hatch for containers where every worker reports the same
    hostname (or conversely where one machine answers to many).  ``salt``
    perturbs the hash the way upstream's ``--mpi-args`` salt does, for
    deliberately splitting co-located workers into separate groups.
    """
    import hashlib
    import os
    import socket

    # Native prefix wins over the compat prefix, as everywhere in config.
    name = os.environ.get("HVDTPU_HOSTNAME") or os.environ.get(
        "HOROVOD_HOSTNAME") or socket.gethostname()
    return hashlib.md5(f"{name}-{salt}".encode()).hexdigest()
