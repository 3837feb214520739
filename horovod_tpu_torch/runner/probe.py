"""Host/NIC discovery + connectivity probe stage (the JAX package's
``runner/probe.py``, copied for the port).

† ``runner/driver/driver_service.py`` + ``runner/task_fn.py``: before
launching the real job on multiple hosts, the driver runs a probe task on
every host.  Each task

1. discovers its own IPv4 addresses (NIC inventory),
2. finds which of the driver's candidate addresses it can actually reach
   (interface selection — the launcher must not assume its default-route
   IP is routable from every host),
3. registers both in the rendezvous KV store, and
4. after all hosts registered, TCP-connects to every peer's probe
   listener (the reference's dummy connectivity check), reporting which
   peer address worked.

The driver aggregates: a driver address reachable from every host, each
host's usable address as seen by its peers (used for rank 0's
``torch.distributed`` store), and hard errors listing exactly which pairs
cannot talk.

The probe task runs as ``python -m horovod_tpu_torch.runner.probe <host_key>
<driver_addr1,addr2,...> <kv_port>`` over ssh with ``HVDTPU_SECRET`` in
the environment.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional


def local_addresses() -> List[str]:
    """This host's IPv4 addresses, most-routable first (NIC inventory).

    `ip -o -4 addr` when available (Linux), else hostname resolution (the
    reference's UDP connect towards an outside address is left out: a
    sealed machine must not see one).  Loopback is kept last so
    single-host dev jobs still match.
    """
    addrs: List[str] = []
    try:
        out = subprocess.run(["ip", "-o", "-4", "addr", "show"],
                             capture_output=True, text=True, timeout=5)
        for line in out.stdout.splitlines():
            parts = line.split()
            if "inet" in parts:
                a = parts[parts.index("inet") + 1].split("/")[0]
                addrs.append(a)
    except (OSError, subprocess.TimeoutExpired):
        pass
    if not addrs:
        try:
            for info in socket.getaddrinfo(socket.gethostname(), None,
                                           socket.AF_INET):
                addrs.append(info[4][0])
        except OSError:
            pass
    seen = set()
    ordered = []
    for a in addrs:
        if a not in seen:
            seen.add(a)
            ordered.append(a)
    # loopback last
    ordered.sort(key=lambda a: a.startswith("127."))
    return ordered or ["127.0.0.1"]


def _try_connect(addr: str, port: int, timeout: float = 3.0) -> bool:
    try:
        with socket.create_connection((addr, port), timeout=timeout):
            return True
    except OSError:
        return False


def probe_task(host_key: str, driver_candidates: List[str], kv_port: int,
               *, peer_timeout: float = 30.0) -> int:
    """The per-host probe body (runs over ssh on each job host)."""
    from .._native import KvClient

    # (2) interface selection: first driver candidate we can reach.
    driver_addr = next(
        (a for a in driver_candidates if _try_connect(a, kv_port)), None)
    if driver_addr is None:
        print(f"probe[{host_key}]: driver unreachable on any of "
              f"{driver_candidates} port {kv_port}", file=sys.stderr)
        return 3
    kv = KvClient(driver_addr, kv_port, timeout_ms=10000)

    # Probe listener other hosts connect to (the dummy data-plane check).
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("", 0))
    srv.listen(64)
    listen_port = srv.getsockname()[1]
    stop = threading.Event()

    def accept_loop() -> None:
        srv.settimeout(0.5)
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
                conn.close()
            except socket.timeout:
                continue
            except OSError:
                return

    t = threading.Thread(target=accept_loop, daemon=True)
    t.start()

    # (1)+(3) register NICs + chosen driver addr + listener port.
    kv.set(f"probe/{host_key}", json.dumps({
        "addrs": local_addresses(),
        "driver_addr": driver_addr,
        "listen_port": listen_port,
    }).encode())

    # (4) wait for the roster, then connect to every peer.  A driver-side
    # abort (another host failed) closes the KV server mid-wait; exit
    # with a clean one-line diagnosis, not a traceback — the driver
    # already printed which host actually broke.
    try:
        roster = json.loads(kv.wait("probe/all",
                                    timeout_ms=int(peer_timeout * 1000)))
        results: Dict[str, Optional[str]] = {}
        for peer in roster:
            if peer == host_key:
                continue
            info = json.loads(kv.wait(f"probe/{peer}", timeout_ms=10000))
            ok = next((a for a in info["addrs"]
                       if _try_connect(a, info["listen_port"])), None)
            results[peer] = ok
        kv.set(f"probe/{host_key}/connectivity",
               json.dumps(results).encode())
    except (TimeoutError, ConnectionError, OSError) as e:
        print(f"probe[{host_key}]: aborted — driver ended the probe round "
              f"({e.__class__.__name__}); see the launcher's diagnostics",
              file=sys.stderr)
        stop.set()
        srv.close()
        return 5
    # Hold the listener open until the driver announces completion, so
    # slower peers can still connect to us.
    try:
        kv.wait("probe/done", timeout_ms=int(peer_timeout * 1000))
    except TimeoutError:
        pass
    stop.set()
    srv.close()
    kv.close()
    return 0 if all(results.values()) or not results else 4


def run_probe_stage(host_keys: List[str], *, kv, launch_fn,
                    timeout: float = 60.0) -> dict:
    """Driver half: launch a probe on every host via ``launch_fn(host)
    -> Popen``, aggregate registrations, and return the routing
    decisions.

    Returns ``{"driver_addr": addr reachable from every host,
    "host_addrs": {host: addr its peers reached it on}}``.
    Raises RuntimeError naming the exact unreachable pairs.
    """
    procs = {h: launch_fn(h) for h in host_keys}
    deadline = time.monotonic() + timeout
    infos: Dict[str, dict] = {}
    for h in host_keys:
        remaining = max(1, int((deadline - time.monotonic()) * 1000))
        try:
            infos[h] = json.loads(kv.wait(f"probe/{h}",
                                          timeout_ms=remaining))
        except TimeoutError:
            rc = procs[h].poll()
            raise RuntimeError(
                f"host {h!r} never registered with the driver "
                f"(probe rc={rc}); it cannot reach the driver's KV "
                "service — check -H spec, ssh, and firewalls") from None
    kv.set("probe/all", json.dumps(host_keys).encode())

    conn: Dict[str, Dict[str, Optional[str]]] = {}
    for h in host_keys:
        remaining = max(1, int((deadline - time.monotonic()) * 1000))
        try:
            conn[h] = json.loads(kv.wait(f"probe/{h}/connectivity",
                                         timeout_ms=remaining))
        except (TimeoutError, ConnectionError) as e:
            raise RuntimeError(
                f"host {h!r} registered but never finished its peer "
                f"connectivity round ({e.__class__.__name__}); its probe "
                "task likely died mid-check — inspect ssh/network on that "
                "host") from None
    kv.set("probe/done", b"1")
    for p in procs.values():
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()

    bad = [(h, peer) for h, r in conn.items()
           for peer, ok in r.items() if not ok]
    if bad:
        raise RuntimeError(
            "connectivity check failed — unreachable host pairs: "
            + ", ".join(f"{a}->{b}" for a, b in bad))

    # Driver address every host agreed on (per-host choices must overlap).
    chosen = {infos[h]["driver_addr"] for h in host_keys}
    driver_addr = chosen.pop() if len(chosen) == 1 else None
    # Per-host address as actually reached by its peers (majority pick).
    host_addrs: Dict[str, str] = {}
    for h in host_keys:
        votes = [r[h] for r in conn.values() if r.get(h)]
        host_addrs[h] = (max(set(votes), key=votes.count) if votes
                         else infos[h]["addrs"][0])
    return {"driver_addr": driver_addr, "host_addrs": host_addrs,
            "nics": {h: infos[h]["addrs"] for h in host_keys}}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 3:
        print("usage: python -m horovod_tpu_torch.runner.probe "
              "<host_key> <driver_addr1,addr2,...> <kv_port>",
              file=sys.stderr)
        return 2
    host_key, cands, port = argv
    return probe_task(host_key, [a for a in cands.split(",") if a],
                      int(port))


if __name__ == "__main__":
    sys.exit(main())
