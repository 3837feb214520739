"""ctypes bindings to the framework-free native core (``native/``).

A copy of ``horovod_tpu/_native/__init__.py`` for the port: the rendezvous
KV store and the rank-0 negotiation controller of
``native/hvdtpu_core.cc`` (``hvd_kv_*`` / ``hvd_ctrl_*``), bound with
ctypes († ``horovod/common/basics.py`` loads its extension the same way).

The port never writes into ``native/``: it loads the tracked
``native/libhvdtpu_core.so`` when that is not older than
``native/hvdtpu_core.cc`` (make's rule), and otherwise compiles the source
with the flags of ``native/Makefile`` into ``build/native/`` (git-ignored;
``$HOROVOD_TPU_TORCH_BUILD_DIR/native`` when that is set).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from types import MappingProxyType
from typing import Mapping, NamedTuple, Optional


class StallInfo(NamedTuple):
    """Attribution for one stalled tensor: the ranks that have NOT
    submitted it (the stragglers) and how long it has been waiting.
    The controller computes both from the readiness bitmap it already
    walks († stall_inspector.cc reported only the name)."""
    missing_ranks: tuple
    age_ms: int


class NegotiationResult(NamedTuple):
    """One negotiation round's outcome († ``Response`` list).

    ``ready``: globally-ready tensor names in the agreed fuse order.
    ``stalled``: names some ranks submitted but others haven't (stall warn).
    ``metas``: name → opaque descriptor for ready tensors (used by joined
    ranks to build zero-payload participation).
    ``join_covered``: names whose readiness depended on a joined rank's
    fabricated zero participation — only allreduce may dispatch for these
    († the reference errors non-allreduce ops while any rank is joined).
    ``all_joined`` / ``last_join_rank``: † ``hvd.join()`` completion signal.
    ``stall_info``: name → :class:`StallInfo` for every stalled tensor
    (straggler attribution: which ranks are withholding, for how long).
    """
    ready: list
    stalled: list
    metas: dict
    all_joined: bool
    last_join_rank: int
    join_covered: frozenset = frozenset()
    # Immutable default: a plain {} here would be one shared class-level
    # dict across every default-constructed result.
    stall_info: Mapping = MappingProxyType({})


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SRC = os.path.join(_NATIVE_DIR, "hvdtpu_core.cc")
_TRACKED_SO = os.path.join(_NATIVE_DIR, "libhvdtpu_core.so")
# native/Makefile's CXXFLAGS and link flag.
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _build_dir() -> str:
    root = os.environ.get("HOROVOD_TPU_TORCH_BUILD_DIR") or \
        os.path.join(_REPO_ROOT, "build")
    return os.path.join(root, "native")


def _newer_or_same(target: str, source: str) -> bool:
    return (os.path.exists(target)
            and os.stat(target).st_mtime_ns >= os.stat(source).st_mtime_ns)


def _so_path() -> str:
    """The core to load: the tracked build when it is current, else a
    build of the source under :func:`_build_dir`, compiled here when it
    is missing or older than the source.  Concurrent processes (the ranks
    of one job) serialize on a lock file and publish by rename, so none
    loads a half-written library."""
    if _newer_or_same(_TRACKED_SO, _SRC):
        return _TRACKED_SO
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libhvdtpu_core.so")
    with open(os.path.join(out_dir, "lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not _newer_or_same(so, _SRC):
            tmp = f"{so}.{os.getpid()}.tmp"
            cxx = os.environ.get("CXX", "g++")
            res = subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, _SRC],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise OSError(f"building the native core failed "
                              f"({cxx}):\n{res.stderr}")
            os.replace(tmp, so)
    return so


def job_secret(secret: Optional[str] = None) -> bytes:
    """Resolve the control-plane HMAC secret († secret.py shared job
    secret).  Explicit argument wins; otherwise ``HVDTPU_SECRET`` from the
    environment (injected by the launcher); empty = unauthenticated
    (single-user dev rigs)."""
    if secret is None:
        secret = os.environ.get("HVDTPU_SECRET", "")
    return secret.encode()


def load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_so_path())
        # KV store
        lib.hvd_kv_server_start.restype = ctypes.c_void_p
        lib.hvd_kv_server_start.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.hvd_kv_server_port.restype = ctypes.c_int
        lib.hvd_kv_server_port.argtypes = [ctypes.c_void_p]
        lib.hvd_kv_server_stop.argtypes = [ctypes.c_void_p]
        lib.hvd_kv_connect.restype = ctypes.c_void_p
        lib.hvd_kv_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_char_p]
        lib.hvd_kv_set.restype = ctypes.c_int
        lib.hvd_kv_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int]
        lib.hvd_kv_wait.restype = ctypes.c_int
        lib.hvd_kv_wait.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_int]
        lib.hvd_kv_del.restype = ctypes.c_int
        lib.hvd_kv_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hvd_kv_close.argtypes = [ctypes.c_void_p]
        # Controller
        lib.hvd_ctrl_server_start.restype = ctypes.c_void_p
        lib.hvd_ctrl_server_start.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_char_p,
                                              ctypes.c_int]
        lib.hvd_ctrl_server_port.restype = ctypes.c_int
        lib.hvd_ctrl_server_port.argtypes = [ctypes.c_void_p]
        lib.hvd_ctrl_server_stop.argtypes = [ctypes.c_void_p]
        lib.hvd_ctrl_connect.restype = ctypes.c_void_p
        lib.hvd_ctrl_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_char_p]
        lib.hvd_ctrl_negotiate.restype = ctypes.c_int
        lib.hvd_ctrl_negotiate.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.hvd_ctrl_cache_size.restype = ctypes.c_int
        lib.hvd_ctrl_cache_size.argtypes = [ctypes.c_void_p]
        lib.hvd_ctrl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class KvServer:
    """Rendezvous KV store server († Gloo ``RendezvousServer``)."""

    def __init__(self, port: int = 0,
                 secret: Optional[str] = None) -> None:
        self._lib = load()
        self._h = self._lib.hvd_kv_server_start(port, job_secret(secret))
        if not self._h:
            raise OSError(f"failed to start KV server on port {port}")

    @property
    def port(self) -> int:
        if not self._h:
            raise RuntimeError("KV server is stopped")
        return self._lib.hvd_kv_server_port(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.hvd_kv_server_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class KvClient:
    """† ``gloo/http_store.cc`` client role."""

    def __init__(self, host: str, port: int, timeout_ms: int = 10000,
                 secret: Optional[str] = None) -> None:
        self._lib = load()
        self._h = self._lib.hvd_kv_connect(host.encode(), port, timeout_ms,
                                           job_secret(secret))
        if not self._h:
            raise ConnectionError(f"cannot reach KV server {host}:{port}")

    def set(self, key: str, value: bytes) -> None:
        if self._lib.hvd_kv_set(self._h, key.encode(), value, len(value)) != 0:
            raise OSError(f"kv set failed for {key!r}")

    def wait(self, key: str, timeout_ms: int = 10000) -> bytes:
        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.hvd_kv_wait(self._h, key.encode(), timeout_ms, buf,
                                  len(buf))
        if n == -2:
            raise ConnectionError(
                "KV connection dropped — secret mismatch (HVDTPU_SECRET) "
                "or server gone")
        if n < 0:
            raise TimeoutError(f"key {key!r} not set within {timeout_ms}ms")
        if n > len(buf):
            buf = ctypes.create_string_buffer(n)
            n = self._lib.hvd_kv_wait(self._h, key.encode(), 0, buf, n)
            if n == -2:
                raise ConnectionError(
                    "KV connection dropped — secret mismatch "
                    "(HVDTPU_SECRET) or server gone")
            if n < 0:
                raise TimeoutError(f"key {key!r} disappeared")
        return buf.raw[:n]

    def get(self, key: str) -> Optional[bytes]:
        try:
            return self.wait(key, timeout_ms=0)
        except TimeoutError:
            return None

    def delete(self, key: str) -> None:
        self._lib.hvd_kv_del(self._h, key.encode())

    def close(self) -> None:
        if self._h:
            self._lib.hvd_kv_close(self._h)
            self._h = None


class ControllerServer:
    """Rank-0 coordinator service († ``controller.cc``).

    ``round_abort_ms`` > 0: a rank blocked in the per-round barrier that
    long gets an abort reply (its engine errors pending work) instead of
    waiting forever for a dead peer; 0 disables — long legitimate rounds
    (first XLA compile) must survive unless stall shutdown is opted into.
    """

    def __init__(self, size: int, port: int = 0,
                 stall_warn_ms: int = 60000,
                 secret: Optional[str] = None,
                 round_abort_ms: int = 0) -> None:
        self._lib = load()
        self._h = self._lib.hvd_ctrl_server_start(port, size, stall_warn_ms,
                                                  job_secret(secret),
                                                  round_abort_ms)
        if not self._h:
            raise OSError(f"failed to start controller on port {port}")

    @property
    def port(self) -> int:
        if not self._h:
            raise RuntimeError("controller server is stopped")
        return self._lib.hvd_ctrl_server_port(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.hvd_ctrl_server_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class ControllerClient:
    """Per-rank negotiation client with the name→id response cache."""

    def __init__(self, host: str, port: int, rank: int,
                 timeout_ms: int = 10000,
                 secret: Optional[str] = None) -> None:
        self._lib = load()
        self._h = self._lib.hvd_ctrl_connect(host.encode(), port, rank,
                                             timeout_ms, job_secret(secret))
        if not self._h:
            raise ConnectionError(
                f"cannot reach controller {host}:{port} (rank {rank})")

    def negotiate(self, names, joined: bool = False,
                  timeout_ms: int = 60000) -> "NegotiationResult":
        """Submit pending tensors; block until the round completes.

        ``names``: list of tensor names, (name, meta) pairs, or
        (name, meta, members) triples — ``meta`` is an opaque descriptor
        (travels once per tensor; the coordinator echoes it on ready
        tensors so joined ranks can build zero participation);
        ``members`` is a csv of the global ranks participating in the
        collective ('' = every rank — † process-set readiness counts
        member coverage only).
        ``joined``: this rank has no more inputs († RequestType::JOIN).
        """
        items = []
        for it in names:
            if isinstance(it, str):
                items.append(it)
                continue
            name, meta, members = (it if len(it) == 3 else (*it, ""))
            if members:
                items.append(f"{name}\x02{meta}\x02{members}")
            elif meta:
                items.append(f"{name}\x02{meta}")
            else:
                items.append(name)
        blob = "\n".join(items).encode()
        cap = 1 << 20  # 1 MB of tensor names per round is far beyond real use
        buf = ctypes.create_string_buffer(cap)
        all_joined = ctypes.c_int(0)
        last_rank = ctypes.c_int(0)
        n = self._lib.hvd_ctrl_negotiate(
            self._h, blob, 1 if joined else 0, buf, cap,
            ctypes.byref(all_joined), ctypes.byref(last_rank))
        if n == -3:
            raise ConnectionError(
                "negotiation round aborted by the controller: another "
                "rank stopped checking in (process died or engine "
                "stalled-out)")
        if n < 0:
            raise ConnectionError("negotiation failed (controller gone?)")
        if n > cap:
            # A re-negotiate would start a new round; this is a hard limit.
            raise RuntimeError(f"negotiation response {n} bytes exceeds cap")
        payload = buf.raw[:n].decode()
        ready_part, _, stalled_part = payload.partition("\x01")
        ready, metas, covered = [], {}, set()
        for item in ready_part.split("\n"):
            if not item:
                continue
            parts = item.split("\x02")
            name = parts[0]
            meta = parts[1] if len(parts) > 1 else ""
            ready.append(name)
            if meta:
                metas[name] = meta
            if len(parts) > 2 and parts[2] == "j":
                covered.add(name)
        stalled, stall_info = [], {}
        for item in stalled_part.split("\n"):
            if not item:
                continue
            parts = item.split("\x02")
            name = parts[0]
            stalled.append(name)
            missing: tuple = ()
            age_ms = 0
            if len(parts) > 1 and parts[1]:
                try:
                    missing = tuple(int(r) for r in parts[1].split(","))
                except ValueError:
                    missing = ()
            if len(parts) > 2:
                try:
                    age_ms = int(parts[2])
                except ValueError:
                    age_ms = 0
            stall_info[name] = StallInfo(missing, age_ms)
        return NegotiationResult(ready, stalled, metas,
                                 bool(all_joined.value), last_rank.value,
                                 frozenset(covered), stall_info)

    @property
    def cache_size(self) -> int:
        return self._lib.hvd_ctrl_cache_size(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.hvd_ctrl_close(self._h)
            self._h = None
