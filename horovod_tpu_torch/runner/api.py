"""Programmatic function launcher — † ``horovod.run`` (``horovod/runner/
__init__.py run``): call a Python function on ``np`` ranks and get the
per-rank return values back, without writing a script or touching the CLI.
A copy of the JAX package's ``runner/api.py`` for the port; the blob
format of :func:`kv_put_blob` is the reference's, byte for byte.

    import horovod_tpu_torch as hvd

    def train(lr):
        hvd.init()
        ...
        return final_loss

    losses = hvd.run_func(train, args=(0.01,), np=4)   # rank-ordered

Design (no shared filesystem assumed): the function, its
arguments, and every rank's return value travel over the job's
authenticated KV store — the same control-plane channel the rendezvous
uses — serialized with cloudpickle (so closures and notebook-defined
functions work, † cloudpickle payloads in ``runner/common/util/codec.py``).

  driver                                  worker (..._run_func_worker)
  ------                                  ------
  put payload blob in KV                  fetch payload blob
  launch workers (launch_workers)         result = func(*args, **kwargs)
  collector thread reads                  put result blob in KV
    runfunc/result/<rank> as each         wait for runfunc/ack/<rank> (so
    lands and sets runfunc/ack/<rank>       the driver's KV server outlives
    immediately                             the read), then exit
  join collector; unpickle; return

  Acks are PER RANK so a worker exits the moment its own result is read —
  a peer hanging in a collective must not hold an already-finished (or
  already-failed) worker for the full ack timeout.

Values larger than the control-plane frame limit are chunked
(:func:`kv_put_blob`).  A worker whose function raises reports the
traceback as its result and exits nonzero, so the launcher tears the job
down and :func:`run_func` raises with every collected failure.

cloudpickle is imported only inside :func:`run_func` and
:func:`worker_main`: the rest of the package (the launcher, the metrics
publisher's :func:`kv_put_blob`) runs where it is not installed.
"""

from __future__ import annotations

import dataclasses as _dc
import os
import threading
import time
from typing import Any, List, Optional, Sequence

from .. import chaos
from ..utils import retry as _retry

# Control-plane frames cap at 8 MiB (native/hvdtpu_core.cc recv guard);
# chunk well under it to leave room for HMAC/framing overhead.
_CHUNK = 4 << 20

_PAYLOAD_KEY = "runfunc/payload"
_RESULT_KEY = "runfunc/result/{rank}"
_ACK_KEY = "runfunc/ack/{rank}"


def kv_put_blob(kv, prefix: str, data: bytes, *,
                policy: _retry.RetryPolicy = _retry.KV_POLICY,
                deadline_s: Optional[float] = None) -> None:
    """Store ``data`` under ``prefix`` in ≤4 MiB chunks.

    The meta key goes LAST so a blocking reader that sees it can read
    every chunk without racing the writer; it carries the total length
    so a reader racing a REWRITE of the same prefix (the obs plane
    republishes ``obs/rank/<r>`` every interval; run_func keys are
    write-once and never hit this) detects the torn read instead of
    returning spliced bytes.

    Transient store errors retry under the shared backoff policy with
    ONE overall ``deadline_s`` across every chunk write.  The default
    budget scales with the blob (2s per 4 MiB chunk, 10s floor) so a
    large run_func result is never failed by a flat timeout a small
    blob sized; callers with a real cadence to protect (the obs
    publisher) pass a tight explicit deadline instead."""
    n = max(1, (len(data) + _CHUNK - 1) // _CHUNK)
    if deadline_s is None:
        deadline_s = max(10.0, 2.0 * n)
    policy = _dc.replace(policy, deadline_s=deadline_s)
    deadline = time.monotonic() + deadline_s

    def put(key: str, value: bytes) -> None:
        def attempt():
            chaos.fire("kv_put")
            if time.monotonic() > deadline:
                raise _Expired(
                    f"kv_put_blob({prefix!r}): {deadline_s}s overall "
                    "deadline exceeded")
            kv.set(key, value)
        _retry.retry_call(attempt, op="kv_put", policy=policy)

    for i in range(n):
        put(f"{prefix}/{i}", data[i * _CHUNK:(i + 1) * _CHUNK])
    put(f"{prefix}/meta", f"{n}:{len(data)}".encode())


def kv_get_blob(kv, prefix: str, timeout_ms: int = 10000) -> bytes:
    """Blocking fetch of a chunked blob stored by :func:`kv_put_blob`.

    ``timeout_ms`` is ONE overall deadline shared by the meta wait and
    every chunk wait — each wait gets only the remaining budget, so a
    flaky store can never stretch the call to ``chunks x timeout`` (the
    pre-retry-policy behavior restarted the full timeout per chunk).
    Transient errors inside the window retry on the shared backoff
    policy.

    Raises ``ValueError`` when the assembled length contradicts the
    meta record (concurrent rewrite of the prefix) — callers on
    rewritable keys retry or skip; write-once keys never see it."""
    deadline = time.monotonic() + timeout_ms / 1000.0

    def wait_key(key: str) -> bytes:
        def attempt():
            chaos.fire("kv_get")
            remaining_ms = int((deadline - time.monotonic()) * 1000)
            if remaining_ms <= 0:
                raise _Expired(
                    f"kv_get_blob({prefix!r}): {timeout_ms}ms overall "
                    f"deadline exceeded waiting for {key!r}")
            return kv.wait(key, timeout_ms=remaining_ms)
        policy = _dc.replace(
            _retry.KV_POLICY,
            deadline_s=max(0.0, deadline - time.monotonic()))
        return _retry.retry_call(attempt, op="kv_get", policy=policy)

    meta = wait_key(f"{prefix}/meta").decode()
    n_str, _, len_str = meta.partition(":")
    n = int(n_str)
    blob = b"".join(wait_key(f"{prefix}/{i}") for i in range(n))
    if len_str and len(blob) != int(len_str):
        raise ValueError(
            f"blob {prefix!r} torn mid-rewrite "
            f"(meta says {len_str} bytes, read {len(blob)})")
    return blob


class _Expired(_retry.Permanent, TimeoutError):
    """Deadline-expired marker: still a ``TimeoutError`` for callers'
    except clauses, but :class:`~horovod_tpu_torch.utils.retry.Permanent`
    vetoes retrying a budget that is already spent."""


def _collect(kv, np_total: int, results: dict, stop: threading.Event) -> None:
    """Driver-side collector: read every rank's result blob as it lands and
    immediately publish that rank's ack, releasing the worker to exit.

    Sweeps ALL outstanding ranks non-blockingly each pass — a rank that
    hangs (e.g. blocked in a collective on a crashed peer) must not hide
    a later rank's already-published failure traceback, nor delay another
    worker's exit."""
    outstanding = set(range(np_total))
    while outstanding and not stop.is_set():
        progressed = False
        for rank in sorted(outstanding):
            key = _RESULT_KEY.format(rank=rank)
            try:
                if kv.get(f"{key}/meta") is None:
                    continue
                results[rank] = kv_get_blob(kv, key, timeout_ms=1000)
                kv.set(_ACK_KEY.format(rank=rank), b"1")
            except TimeoutError:
                continue
            except (ConnectionError, OSError):
                return  # services gone — the job already tore down
            outstanding.discard(rank)
            progressed = True
        if outstanding and not progressed:
            stop.wait(0.05)


def _pickle_module_by_value(mod) -> bool:
    """Should ``mod``'s contents ship by value?  Installed (site-packages /
    stdlib) modules are importable on workers and stay by-reference;
    everything else with a real file (project code, pytest-loaded modules)
    ships by value.  ``__main__`` needs nothing: cloudpickle already
    by-values it."""
    import sysconfig

    if mod is None or mod.__name__ == "__main__":
        return False
    path = getattr(mod, "__file__", None)
    if path is None:  # builtin / C extension — by-reference only
        return False
    path = os.path.abspath(path)
    if "site-packages" in path or "dist-packages" in path:
        return False
    stdlib = os.path.abspath(sysconfig.get_paths()["stdlib"])
    return not path.startswith(stdlib + os.sep)


def run_func(func, args: Sequence[Any] = (), kwargs: Optional[dict] = None,
             np: int = 1, *, hosts: Optional[str] = None,
             extra_env: Optional[dict] = None, ssh_port: int = 22,
             verbose: bool = False) -> List[Any]:
    """Run ``func(*args, **kwargs)`` on ``np`` ranks; return the rank-ordered
    list of results († ``horovod.run`` signature: func/args/kwargs/np/hosts).

    ``func`` typically calls :func:`horovod_tpu_torch.init` itself,
    exactly like a script launched by ``hvdrun`` would.  Raises
    ``RuntimeError`` when any rank fails, with every collected worker
    traceback attached.
    """
    import cloudpickle
    import sys

    from .._native import KvClient
    from .launch import launch_workers

    # Ship the function BY VALUE when its module is plausibly not
    # importable on the workers (a notebook cell, a pytest-loaded test
    # module, a sweep script run from elsewhere) — cloudpickle only
    # by-values ``__main__`` automatically.  Installed libraries stay
    # by-reference: by-value would drag module globals (locks, handles)
    # into the payload for no benefit.  Registration is global
    # cloudpickle state — always undone.
    mod = sys.modules.get(getattr(func, "__module__", "") or "")
    register = _pickle_module_by_value(mod)
    if register:
        cloudpickle.register_pickle_by_value(mod)
    try:
        payload = cloudpickle.dumps(
            {"func": func, "args": tuple(args), "kwargs": dict(kwargs or {})})
    finally:
        if register:
            cloudpickle.unregister_pickle_by_value(mod)

    results: dict = {}
    stop = threading.Event()
    state: dict = {}

    def services_hook(services) -> None:
        kv = KvClient("127.0.0.1", services.kv.port, secret=services.secret)
        kv_put_blob(kv, _PAYLOAD_KEY, payload)
        t = threading.Thread(target=_collect, args=(kv, np, results, stop),
                             daemon=True)
        t.start()
        state["kv"], state["thread"] = kv, t

    command = [sys.executable, "-m",
               "horovod_tpu_torch.runner._run_func_worker"]
    try:
        code = launch_workers(command, np_total=np, hosts_spec=hosts,
                              extra_env=extra_env, ssh_port=ssh_port,
                              verbose=verbose, services_hook=services_hook)
    finally:
        stop.set()
        thread = state.get("thread")
        if thread is not None:
            thread.join(timeout=5)
        if "kv" in state and (thread is None or not thread.is_alive()):
            # Close only once the collector has provably exited: closing
            # under a live collector nulls the native handle mid-call.  A
            # still-alive daemon thread keeps (and leaks) the client; the
            # missing-results check below reports the incomplete snapshot.
            try:
                state["kv"].close()
            except OSError:
                pass

    decoded = {rank: cloudpickle.loads(blob)
               for rank, blob in results.items()}
    failures = {rank: r["error"] for rank, r in decoded.items()
                if not r["ok"]}
    if code != 0 or failures:
        detail = "".join(f"\n[rank {r}]\n{tb}" for r, tb in
                         sorted(failures.items()))
        raise RuntimeError(
            f"run_func job failed (exit code {code}, "
            f"{len(failures)} rank(s) raised){detail}")
    missing = [r for r in range(np) if r not in decoded]
    if missing:
        raise RuntimeError(
            f"run_func: workers exited 0 but results from ranks {missing} "
            "were never collected")
    return [decoded[r]["value"] for r in range(np)]


def worker_main() -> int:
    """Entry point of ``python -m
    horovod_tpu_torch.runner._run_func_worker``."""
    import traceback

    import cloudpickle

    from .._native import KvClient

    host, port = os.environ["HVDTPU_RENDEZVOUS_ADDR"].rsplit(":", 1)
    rank = int(os.environ.get("HVDTPU_CROSS_RANK", "0"))
    kv = KvClient(host, int(port), secret=os.environ.get("HVDTPU_SECRET"))
    start_timeout_ms = int(float(os.environ.get(
        "HVDTPU_START_TIMEOUT", "30")) * 1000)
    spec = cloudpickle.loads(
        kv_get_blob(kv, _PAYLOAD_KEY, timeout_ms=start_timeout_ms))

    code = 0
    try:
        value = spec["func"](*spec["args"], **spec["kwargs"])
        try:
            out = cloudpickle.dumps({"ok": True, "value": value})
        except Exception:
            raise RuntimeError(
                f"run_func: rank {rank}'s return value of type "
                f"{type(value).__name__} is not picklable")
    except BaseException:
        out = cloudpickle.dumps(
            {"ok": False, "error": traceback.format_exc()})
        code = 1
    kv_put_blob(kv, _RESULT_KEY.format(rank=rank), out)
    try:
        # Hold until the driver has read THIS rank's result (its KV server
        # dies with the job) — the driver acks per rank as soon as it
        # collects, so a hung peer never delays this worker's exit.  A
        # failed worker waits a shorter bound: its exit is what triggers
        # the launcher's teardown, so surfacing the error beats lingering.
        timeout_ms = 60000 if code == 0 else 10000
        kv.wait(_ACK_KEY.format(rank=rank), timeout_ms=timeout_ms)
    except (TimeoutError, ConnectionError, OSError):
        pass
    kv.close()
    return code
