"""Runtime context of the port: rank bookkeeping, the device, health.

The subset of ``horovod_tpu/context.py`` the serving slice needs.  One
process drives one card, as in the reference († ``horovod_rank`` /
``horovod_size``): rank, size and local rank come from the env the
launcher injects (``HVDTPU_CROSS_RANK``, ``HVDTPU_CROSS_SIZE``,
``HVDTPU_LOCAL_RANK``), and a process started without a launcher is rank 0
of 1.  The process's device is ``cuda:<local_rank>``.

Also here: the component-health table that ``/healthz`` reads (a serving
session reports into it while it drains after an engine failure), and the
global timeline slot ``serve()`` borrows.  ``torch.distributed`` and the
collective engine wait for the collectives slice.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from .utils import logging as hvd_logging
from .utils.timeline import Timeline, rank_suffixed

log = hvd_logging.get_logger()

_PREFIXES = ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_")


def _env(suffix: str) -> Optional[str]:
    for prefix in _PREFIXES:
        v = os.environ.get(prefix + suffix)
        if v is not None:
            return v
    return None


def _env_int(suffix: str, default: int) -> int:
    raw = _env(suffix)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{suffix}={raw!r} is not an integer") from None


class HorovodInternalError(RuntimeError):
    """A collective failed; the job's world is suspect.  Raised by the
    collectives of a later slice; the serving session's rejoin branch
    keys on it."""


class _GlobalState:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.timeline: Optional[Timeline] = None


_state = _GlobalState()


def global_state() -> _GlobalState:
    return _state


def init(*, timeline: Optional[str] = None) -> None:
    """Read rank/size/local rank from the launcher's env and open the
    timeline named by ``timeline`` or ``HOROVOD_TIMELINE`` (suffixed per
    rank when the job has more than one process).  Idempotent."""
    with _state.lock:
        if _state.initialized:
            return
        rank = _env_int("CROSS_RANK", 0)
        size = _env_int("CROSS_SIZE", 1)
        local_rank = _env_int("LOCAL_RANK", 0)
        if size < 1 or not 0 <= rank < size or local_rank < 0:
            raise ValueError(
                f"bad launcher env: rank={rank} size={size} "
                f"local_rank={local_rank}")
        _state.rank, _state.size, _state.local_rank = rank, size, local_rank
        path = timeline or _env("TIMELINE")
        if path:
            path = rank_suffixed(path, rank, size)
        _state.timeline = Timeline(path or None, rank=rank)
        _state.initialized = True
        log.info("horovod_tpu_torch initialized: rank=%d size=%d "
                 "local_rank=%d", rank, size, local_rank)


def shutdown() -> None:
    with _state.lock:
        if not _state.initialized:
            return
        if _state.timeline is not None:
            _state.timeline.close()
            _state.timeline = None
        _state.initialized = False


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise RuntimeError(
            "horovod_tpu_torch has not been initialized; call "
            "horovod_tpu_torch.init() first")
    return _state


def rank() -> int:
    return _require_init().rank


def size() -> int:
    return _require_init().size


def local_rank() -> int:
    return _require_init().local_rank


def device(device=None) -> torch.device:
    """The device entry points run on: ``device`` when given (``"cpu"``
    is how tests ask for the CPU), else ``cuda:<local_rank>``.  Raises
    when CUDA is asked for and no card is visible — the port never
    carries on quietly on the CPU."""
    if device is not None:
        dev = torch.device(device)
    else:
        local = _state.local_rank if _state.initialized \
            else _env_int("LOCAL_RANK", 0)
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run on "
                "the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} requested but only {torch.cuda.device_count()} "
                f"CUDA device(s) are visible")
    return dev


_component_lock = threading.Lock()
_components: dict = {}


def set_component_health(name: str, ready, **info) -> None:
    """Subsystem readiness feeding ``/healthz``: any registered
    component reporting unready holds the whole probe at 503 (a serving
    session drains this way while it aborts after an engine failure).
    ``ready=None`` deregisters the component.  Components survive
    ``shutdown()``."""
    with _component_lock:
        if ready is None:
            _components.pop(name, None)
        else:
            _components[name] = {"ready": bool(ready), **info}


def component_health(name: str):
    """One component's readiness: True/False as last reported, None when
    the component never registered (or deregistered)."""
    with _component_lock:
        c = _components.get(name)
    return None if c is None else bool(c.get("ready"))
