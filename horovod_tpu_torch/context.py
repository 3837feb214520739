"""Runtime context of the port: ``init``, rank bookkeeping, the device.

The port of ``horovod_tpu/context.py``.  One process is one rank on one
card, as in upstream Horovod († ``horovod_rank`` / ``horovod_size``):
rank, size and local rank come from the env the launcher injects
(``HVDTPU_CROSS_RANK``, ``HVDTPU_CROSS_SIZE``, ``HVDTPU_LOCAL_RANK``; read
through :mod:`.config`), and a process started without a launcher is rank
0 of 1.

:func:`init` starts ``torch.distributed`` on the process's device:

- ``nccl`` on ``cuda:<local_rank>``, the default; a CUDA device without
  NCCL raises, it never falls back to Gloo;
- ``gloo`` on the CPU, only when the caller asks for it
  (``HVDTPU_PLATFORM=cpu`` or ``init(config=Config(platform="cpu"))``).

Rendezvous: with more than one rank, ``coordinator_addr``
(``HVDTPU_COORDINATOR_ADDR``, ``host:port``) names the TCP store rank 0
listens on, and ``controller_addr`` the native negotiation controller
the launcher started; one rank with no address uses an in-process store.
Then :func:`init` starts the collective engine (:mod:`.ops.engine`), the
process-set table and the observability plane: the HTTP endpoint when
``metrics_port`` is set (``HVDTPU_METRICS_PORT``), this rank's snapshot
publisher into the job's KV store (``HVDTPU_RENDEZVOUS_ADDR``, which the
launcher injects) with the cluster aggregator behind ``/cluster``, the
trace publisher and collector behind ``/tracez``, the sampling profiler
(``prof_hz``), the performance model's link (``perf_link_gbs``), the SLO
engine (``slo``), the time-series tier, the alert engine (``alerts``)
and the ``/healthz`` provider.  :func:`shutdown` stops all of it and
destroys the process group, and a later :func:`init` starts afresh.

Also here: the component-health table that ``/healthz`` reads (a serving
session reports into it while it drains after an engine failure), and the
global timeline slot the engine and ``serve()`` write into.
"""

from __future__ import annotations

import atexit
import os
import socket
import threading
import time
from datetime import timedelta
from typing import Optional

import torch

from . import config as config_mod
from .utils import logging as hvd_logging
from .utils.timeline import Timeline, rank_suffixed

log = hvd_logging.get_logger()

_PREFIXES = ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_")
# Rendezvous and first-collective timeout of the process group.
_PG_TIMEOUT = timedelta(minutes=10)


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


class NotInitializedError(RuntimeError):
    def __init__(self) -> None:
        super().__init__(
            "horovod_tpu_torch has not been initialized; call "
            "horovod_tpu_torch.init() first (reference parity: hvd.init())")


class HorovodInternalError(RuntimeError):
    """A collective failed after being accepted († ``common.h`` status →
    ``HorovodInternalError``); the job's world is suspect.  Every waiter
    on a failed collective raises it, and the serving session's rejoin
    branch keys on it."""


class _GlobalState:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.initialized = False
        self.config = config_mod.Config()
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self.device: Optional[torch.device] = None
        self.backend = ""
        self.timeline: Optional[Timeline] = None
        self.engine = None                  # ops.engine.CollectiveEngine
        self.process_set_table = None       # ops.process_sets table
        # (n_cross, n_local) -> this rank's tier groups
        # (ops.hierarchical.tier_groups), created at init or by the caller.
        self.tier_groups: dict = {}
        self.flat_mesh = None               # mesh(), made at its first call
        # Rendezvous stores, kept for the process's life (see
        # _start_process_group), and the count of inits that used them.
        self.stores: dict = {}
        self.generation = 0
        self.metrics_server = None          # obs.server, when init bound it


_state = _GlobalState()


def global_state() -> _GlobalState:
    return _state


def _first(*values, default: int) -> int:
    return next((v for v in values if v is not None), default)


def _start_process_group(cfg, backend: str, rank: int, size: int) -> None:
    """Start the default process group.  With an address, rank 0 serves a
    TCP store there that lives as long as the process: a shutdown and a
    second init rendezvous under a new key prefix of the same store, so
    a rank that re-inits early can never reach the store of the init
    before, which its peer may not have torn down yet."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is already initialized; horovod_tpu_torch."
            "init() starts the process group itself")
    addr = cfg.coordinator_addr
    if addr:
        host, _, port = addr.rpartition("://")[2].rpartition(":")
        key = (host, int(port), rank, size)
        base = _state.stores.get(key)
        if base is None:
            base = dist.TCPStore(host, int(port), size, rank == 0,
                                 timeout=_PG_TIMEOUT)
            _state.stores[key] = base
        _state.generation += 1
        store = dist.PrefixStore(f"hvd.init.{_state.generation}", base)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=size, timeout=_PG_TIMEOUT)
    elif size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=_PG_TIMEOUT)
    else:
        raise ValueError(
            f"{size} ranks need a rendezvous address: set "
            "HVDTPU_COORDINATOR_ADDR=host:port (rank 0 listens there)")


def _host_layout(rank: int, size: int) -> tuple[int, int, int]:
    """(local_size, cross_rank, cross_size) from every rank's host name
    († upstream's host-hash grouping): ranks sharing a host are local to
    each other, and a host's cross rank is its order of first appearance
    in rank order."""
    import torch.distributed as dist
    hosts: list = [None] * size
    dist.all_gather_object(hosts, socket.gethostname())
    order = list(dict.fromkeys(hosts))
    return hosts.count(hosts[rank]), order.index(hosts[rank]), len(order)


def init(*, config: Optional[config_mod.Config] = None,
         timeline: Optional[str] = None) -> None:
    """Initialize the runtime († ``hvd.init()``): read the launcher's env
    and the knobs (:func:`.config.from_env` over ``config``), pick the
    device, start the process group, the engine and the process-set
    table, and open the timeline named by ``timeline`` or
    ``HOROVOD_TIMELINE`` (suffixed per rank when the job has more than one
    rank).  A second call while initialized does nothing."""
    import torch.distributed as dist
    with _state.lock:
        if _state.initialized:
            log.debug("init() called twice; ignoring (reference parity)")
            return
        cfg = config_mod.from_env(config)
        rank = _first(cfg.cross_rank_env, cfg.rank_env, default=0)
        size = _first(cfg.cross_size_env, cfg.size_env, default=1)
        local_rank = _first(cfg.local_rank_env, default=0)
        if size < 1 or not 0 <= rank < size or local_rank < 0:
            raise ValueError(
                f"bad launcher env: rank={rank} size={size} "
                f"local_rank={local_rank}")
        config_mod.check_ported(cfg)
        if size > 1 and not cfg.controller_addr:
            raise ValueError(
                f"{size} ranks need the negotiation controller: set "
                "HVDTPU_CONTROLLER_ADDR=host:port (the launcher starts it)")
        hvd_logging.configure(cfg.log_level,
                              hide_timestamp=cfg.log_hide_timestamp)
        if cfg.faults:
            from . import chaos
            chaos.arm(cfg.faults, rank=rank)

        if cfg.platform == "cpu":
            dev, backend = torch.device("cpu"), "gloo"
        else:
            dev, backend = device(f"cuda:{local_rank}"), "nccl"
            if not dist.is_nccl_available():
                raise RuntimeError(
                    "this torch has no NCCL; the port does not run CUDA "
                    "collectives over anything else")
            torch.cuda.set_device(dev)
        _start_process_group(cfg, backend, rank, size)
        try:
            _start_runtime(cfg, rank, size, local_rank, dev, backend,
                           timeline)
        except BaseException:
            _stop_runtime()
            raise
        log.info("horovod_tpu_torch initialized: rank=%d size=%d "
                 "local_rank=%d device=%s backend=%s", rank, size,
                 local_rank, dev, backend)


def _start_runtime(cfg, rank: int, size: int, local_rank: int,
                   dev: torch.device, backend: str,
                   timeline: Optional[str]) -> None:
    """What :func:`init` starts once the process group is up (the lock
    held)."""
    local_size, cross_rank, cross_size = _host_layout(rank, size)
    _state.config = cfg
    _state.rank, _state.size, _state.local_rank = rank, size, local_rank
    _state.local_size = local_size
    _state.cross_rank, _state.cross_size = cross_rank, cross_size
    _state.device, _state.backend = dev, backend
    _state.tier_groups = {}
    from .ops import collectives
    split = collectives._hier_split(None)
    if split is not None:
        # Collective, so here on every rank: never lazily in the engine.
        from .ops import hierarchical
        hierarchical.tier_groups(*split)

    path = timeline or cfg.timeline
    if path:
        path = rank_suffixed(path, rank, size)
    _state.timeline = Timeline(path or None,
                               mark_cycles=cfg.timeline_mark_cycles,
                               rank=rank)
    from .obs import flightrec
    flightrec.RECORDER.set_identity(rank, size)
    flightrec.RECORDER.set_capacity(cfg.flight_recorder_size)
    if cfg.flight_recorder_dir:
        flightrec.RECORDER.arm(cfg.flight_recorder_dir)

    from .ops.engine import CollectiveEngine
    from .ops.process_sets import ProcessSetTable
    negotiator = None
    if size > 1:
        from .ops.negotiator import DistributedNegotiator
        host, _, port = cfg.controller_addr.rpartition(":")
        negotiator = DistributedNegotiator(host or "127.0.0.1",
                                           int(port), rank)
    _state.process_set_table = ProcessSetTable(_state)
    _state.engine = CollectiveEngine(_state, negotiator)
    _state.engine.start()
    _start_metrics_plane(cfg, rank, size, dev)
    # Whether this job quantizes its allreduces, as a gauge.
    from .ops import reduction
    reduction.publish_mode_gauge(cfg.wire_precision)
    _state.initialized = True


def _start_metrics_plane(cfg, rank: int, size: int,
                         dev: torch.device) -> None:
    """The endpoint (when ``metrics_port`` is set), the build-info gauge
    and what the reference's ``context._arm_obs_plane`` arms, in its
    order: this rank's snapshot publisher and the cluster aggregator, the
    tracer's sample rate, the fleet trace plane, the sampling profiler,
    the performance model's link, the SLO engine, the time-series tier,
    the alert engine and the ``/healthz`` provider.  Telemetry never
    fails ``init``: a port another process holds (every rank of a job on
    one host sees the same knob), a malformed SLO spec or alert rule is a
    warning."""
    from . import __version__
    from .obs import (REGISTRY, aggregate, alerts, perfmodel, prof, server,
                      slo, trace, tracemerge, tsdb)
    if cfg.metrics_port is not None:
        try:
            _state.metrics_server = server.start(cfg.metrics_port)
        except OSError as e:
            log.warning("metrics endpoint not started on port %d: %s",
                        cfg.metrics_port, e)
    g = REGISTRY.gauge(
        "horovod_tpu_build_info",
        "always 1; labels self-identify the scraped process "
        "(version/rank/world size/device kind)",
        ("version", "rank", "size", "device_kind"))
    g.zero_all()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    g.labels(version=__version__, rank=str(rank), size=str(size),
             device_kind=kind).set(1)
    aggregate.start_for_rank(rank, size)
    trace.TRACER.sample_rate = cfg.trace_sample
    tracemerge.start_for_rank(
        rank, size, pool=os.environ.get("HVDTPU_SERVING_POOL"),
        timeline_path=_state.timeline._path)
    prof.arm_from_config(cfg)
    perfmodel.MODEL.configure(link_gbs=cfg.perf_link_gbs,
                              link_latency_us=cfg.perf_link_latency_us)
    if cfg.slo:
        try:
            slo.arm(cfg.slo, tick_s=cfg.slo_tick_s)
        except ValueError as e:
            log.warning("SLO engine not armed (slo=%r): %s", cfg.slo, e)
    if cfg.tsdb_interval_s > 0:
        tsdb.arm(interval_s=cfg.tsdb_interval_s,
                 retention_s=cfg.tsdb_retention_s)
    else:
        tsdb.disarm()
    alerts.disarm()
    if cfg.alerts:
        try:
            alerts.arm(cfg.alerts)
        except ValueError as e:
            log.warning("alert engine not armed (alerts=%r): %s",
                        cfg.alerts, e)
    server.set_health_provider(_health_snapshot)


def _stop_metrics_plane() -> None:
    """Undo :func:`_start_metrics_plane` in the reference's order."""
    from .obs import aggregate, alerts, prof, server, slo, tracemerge, tsdb
    aggregate.stop()
    tracemerge.stop()
    slo.disarm()
    alerts.disarm()
    tsdb.disarm()
    prof.PROFILER.stop()
    server.set_health_provider(None)
    if _state.metrics_server is not None:
        server.stop()
        _state.metrics_server = None


def _health_snapshot() -> dict:
    """The ``/healthz`` payload: is this rank able to train or serve now,
    and how fresh is its view of the job († the reference's)."""
    eng = _state.engine
    alive = bool(eng is not None and eng.alive)
    ready = bool(_state.initialized and alive)
    status = "ok" if ready else "unready"
    d = {"rank": _state.rank, "size": _state.size, "engine_alive": alive,
         "uptime_s": round(time.monotonic() - _START_MONO, 3)}
    if eng is not None:
        age = eng.last_negotiation_age_s
        d["last_negotiation_age_s"] = round(age, 3)
        limit = _state.config.health_max_negotiation_age_s
        if ready and limit > 0 and age > limit:
            # A wedged negotiation means this rank cannot make progress.
            ready, status = False, "stalled"
    with _component_lock:
        comps = {k: dict(v) for k, v in _components.items()}
    if comps:
        d["components"] = comps
        down = sorted(k for k, v in comps.items() if not v.get("ready"))
        if ready and down:
            ready, status = False, "degraded:" + ",".join(down)
    d["ready"], d["status"] = ready, status
    return d


_START_MONO = time.monotonic()


def _stop_runtime() -> None:
    """Undo :func:`_start_runtime` and the process group (the lock held)."""
    import torch.distributed as dist
    _state.initialized = False
    _stop_metrics_plane()
    if _state.engine is not None:
        _state.engine.stop()
        _state.engine = None
    _state.process_set_table = None
    _state.tier_groups = {}
    _state.flat_mesh = None
    # Captured schedules call into the process group destroyed below.
    from .ops.sched import compiled
    compiled.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    if _state.timeline is not None:
        _state.timeline.close()
        _state.timeline = None
    _state.device = None


def shutdown() -> None:
    """Stop the engine, destroy the process group and close the timeline
    († ``horovod_shutdown``); a later :func:`init` starts afresh."""
    with _state.lock:
        if _state.initialized:
            _stop_runtime()


atexit.register(shutdown)


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def rank() -> int:
    """This process's rank († ``horovod_rank``)."""
    return _require_init().rank


def size() -> int:
    """Number of ranks, one a process († ``horovod_size``)."""
    return _require_init().size


def local_rank() -> int:
    """Rank among the processes of this host; picks the card
    († ``horovod_local_rank``)."""
    return _require_init().local_rank


def local_size() -> int:
    """Number of ranks on this host († ``horovod_local_size``)."""
    return _require_init().local_size


def cross_rank() -> int:
    """Index of this host among the job's hosts († ``horovod_cross_rank``)."""
    return _require_init().cross_rank


def cross_size() -> int:
    """Number of hosts in the job († ``horovod_cross_size``)."""
    return _require_init().cross_size


def mesh():
    """The runtime's flat mesh: a one-axis ``DeviceMesh`` over every rank
    of the job on the runtime's device type, its axis named by the
    config's ``dp_axis_name`` (``"hvd"``), the reference's persistent
    data-parallel mesh.  It rides the default process group: no group is
    made, so a rank may call it alone."""
    state = _require_init()
    if state.flat_mesh is None:
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        state.flat_mesh = DeviceMesh.from_group(
            dist.group.WORLD, state.device.type,
            mesh_dim_names=(state.config.dp_axis_name,))
    return state.flat_mesh


def device(device=None) -> torch.device:
    """The device entry points run on: ``device`` when given (``"cpu"``
    is how tests ask for the CPU), else the runtime's device once
    :func:`init` ran, else ``cuda:<local_rank>``.  Raises when CUDA is
    asked for and no card is visible — the port never carries on quietly
    on the CPU."""
    if device is not None:
        dev = torch.device(device)
    elif _state.initialized:
        dev = _state.device
    else:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0))
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
