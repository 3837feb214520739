"""Configuration knob registry of the port (a copy of ``horovod_tpu/config.py``).

The reference funnels ~40 ``HOROVOD_*`` environment variables through
``horovod/common/utils/env_parser.cc`` (†) and mirrors each one as a
``horovodrun`` CLI flag and a ``--config-file`` YAML key (†
``horovod/runner/common/util/config_parser.py``).  We keep that three-surface
model but with a single dataclass as the source of truth: every knob is
declared once here, and the env parser, CLI flags (``horovod_tpu/runner``)
and YAML loader are generated from this table.

Env vars are read with the ``HVDTPU_`` prefix (native), the ``HOROVOD_TPU_``
prefix (long-form native) and the ``HOROVOD_`` prefix (compatibility with
reference deployments); the first prefix in that order wins when several
are set.

The port keeps every field, env name, precedence rule and parser of the
JAX package's registry, so one environment configures both the same way;
the tests hold the two field by field.  What differs: ``platform`` takes
``"cpu"`` or ``"gpu"`` (the CUDA card), and :func:`check_ported` refuses,
at ``init``, a knob set away from its default whose feature the port does
not have yet, naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


def _parse_platform(v: str) -> str:
    # Validate here so a typo fails at the knob, not at device selection.
    lv = v.strip().lower()
    if lv not in ("gpu", "cpu"):
        raise ValueError(f"platform must be 'gpu' or 'cpu', got {v!r}")
    return lv


def _parse_wire_precision(v: str) -> str:
    lv = v.strip().lower()
    if lv not in ("fp32", "bf16", "fp16", "int8", "fp8"):
        raise ValueError(
            "wire precision must be one of fp32/bf16/fp16/int8/fp8, "
            f"got {v!r}")
    return lv


def _parse_cross_precision(v: str) -> str:
    # Distinct wire mode for the hierarchical cross-tier (DCN) hop.
    # Only the block-scaled quant modes make sense there: the cast modes
    # (bf16/fp16) are whole-collective single-psum shapes that cannot be
    # spliced into one hop of a tiered pipeline.
    lv = v.strip().lower()
    if lv in ("", "fp32"):
        return "" if lv == "" else "fp32"
    if lv in ("int8", "fp8"):
        return lv
    raise ValueError(
        "hierarchical cross precision must be one of ''/fp32/int8/fp8 "
        f"(cast modes cannot ride a single tier), got {v!r}")


# The JAX package's ops/sched/lower.py vocabulary, copied: the knob
# parses the same values in both packages.
SCHED_MODES = ("monolithic", "decomposed", "compiled")


def _parse_sched_mode(v: str) -> str:
    lv = v.strip().lower()
    if lv not in SCHED_MODES:
        raise ValueError(
            f"sched mode must be one of {'/'.join(SCHED_MODES)}, got {v!r}")
    return lv


def _parse_int(v: str) -> int:
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{v!r} is not an integer") from None


def _parse_bool(v: str) -> bool:
    lv = v.strip().lower()
    if lv in _TRUE:
        return True
    if lv in _FALSE:
        return False
    raise ValueError(f"cannot parse boolean from {v!r}")


@dataclasses.dataclass
class Config:
    """All tunables, with reference-equivalent env names noted.

    Fields tagged ``env=`` are settable via ``HVDTPU_<ENV>`` /
    ``HOROVOD_<ENV>``.
    """

    # --- fusion / cycle († fusion_buffer_manager.cc, operations.cc) ---
    # Tensors enqueued within one cycle are fused into a single compiled
    # collective dispatch as long as their total payload stays under this
    # threshold (bytes).  Reference default: 64 MB (HOROVOD_FUSION_THRESHOLD).
    fusion_threshold: int = 64 * 1024 * 1024
    # Background cycle period in milliseconds (HOROVOD_CYCLE_TIME).
    # Reference default 5 ms.
    cycle_time_ms: float = 5.0

    # --- wire precision (ops/reduction.py; EQuARX arXiv:2506.17615) ---
    # Default wire mode for engine allreduces: fp32 (off), bf16/fp16
    # (cast wire), int8/fp8 (block-scaled quantized).  Per-call override:
    # ``hvd.allreduce(t, compression=...)``.  Non-float payloads,
    # non-sum reductions and sub-floor tensors always fall back to fp32.
    wire_precision: str = "fp32"
    # Block size for the per-block absmax scales of int8/fp8 modes.
    quant_block_size: int = 512
    # Payloads below this many bytes (per rank) never quantize — the
    # scale traffic and encode pass outweigh the wire saving.
    quant_min_bytes: int = 65536

    # --- collective schedule (ops/sched; GC3-style decomposition) ---
    # Engine allreduce schedule: "monolithic" (one psum, the default),
    # "decomposed" (chunked reduce-scatter -> allgather, later chunks'
    # communication overlapped with earlier chunks' compute, dispatched
    # unit by unit by the executor) or "compiled" (the SAME chunked
    # schedule lowered into one jitted NamedSharding program so XLA
    # places/fuses/overlaps the collectives in-compiler).  Composes with
    # wire_precision; results are bit-exact across all three.
    sched_mode: str = "monolithic"
    # Chunk count for the decomposed schedule (payloads too small to cut
    # into >= 2 chunks fall back to monolithic per resolve_schedule).
    sched_chunks: int = 4

    # --- ZeRO-1 sharded optimizer + bucket overlap (optim/zero.py,
    # ops/sched/buckets.py) ---
    # When set, optim.zero.from_config wraps the inner optax
    # transformation as the ZeRO-1 sharded optimizer (optimizer state
    # 1/n per rank, one parameter allgather per step) instead of the
    # dense DistributedOptimizer.  The wrapper itself is always
    # available regardless of this knob.
    zero: bool = False
    # Size target in bytes for gradient fusion buckets (the Horovod
    # fusion-buffer analogue): caps the per-bucket payload of the
    # bucketed eager path and the in-jit bucket boundaries, and caps the
    # engine's fusion groups below fusion_threshold.  <= 0 means
    # unbounded buckets (one per dtype/wire-mode group) and leaves the
    # engine's fusion_threshold as the only cap.
    bucket_bytes: int = 0

    # --- response/dispatch cache († response_cache.cc) ---
    # Capacity of the compiled-collective dispatch cache (signature -> jitted
    # program).  The XLA-compile cache plays the role of the reference's
    # negotiated-Response cache; this caps our own signature table.
    cache_capacity: int = 1024

    # --- autotune († parameter_manager.cc) ---
    autotune: bool = False
    autotune_log: Optional[str] = None
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10

    # --- timeline († timeline.cc) ---
    timeline: Optional[str] = None  # path for Chrome-trace JSON
    timeline_mark_cycles: bool = False

    # --- metrics exposition (horovod_tpu.obs; beyond the reference) ---
    # TCP port for the Prometheus/JSON pull endpoint; None = no server.
    metrics_port: Optional[int] = None

    # --- request tracing (obs/trace.py) ---
    # Per-trace sampling probability in [0, 1]; 1.0 traces every serving
    # request (the bench holds traced-on overhead under the 2% budget),
    # 0 disables tracing entirely.
    trace_sample: float = 1.0

    # --- SLO engine (obs/slo.py) ---
    # Semicolon-separated objective specs, e.g.
    # "ttft=p99(ttft) < 250ms over 5m; p95(itl) < 50ms".  None = no SLO
    # engine; armed at init(), gauges ride /metrics and /cluster.
    slo: Optional[str] = None
    # Seconds between SLO histogram snapshots / evaluations.
    slo_tick_s: float = 10.0

    # --- time-series tier (obs/tsdb.py) ---
    # Seconds between registry samples into the in-memory history rings
    # (raw ring at this cadence, 60s-downsampled ring behind it);
    # <= 0 disables the tier (and /query answers 503-equivalent errors).
    tsdb_interval_s: float = 5.0
    # Raw-ring retention in seconds; the downsampled ring keeps a fixed
    # ~2h at 60s resolution regardless.
    tsdb_retention_s: float = 600.0

    # --- declarative alerting (obs/alerts.py) ---
    # Semicolon-separated alert rules over the time-series tier, e.g.
    # "queue: avg_over_time(hvd_serving_queue_depth[1m]) > 8 for 30s : warn".
    # None = no alert engine; armed at init(), firing gauges ride
    # /metrics and /cluster, state at /alertz.
    alerts: Optional[str] = None

    # --- sampling profiler (obs/prof.py) ---
    # Stack-sampling rate in Hz for the always-on profiler; 0 disables.
    # 10 Hz costs ~100 us/tick for a dozen threads — well inside the <2%
    # overhead budget the serving benchmark asserts.
    prof_hz: float = 10.0
    # Bound on distinct (thread, stack) rows in the hot-stack table;
    # further new stacks are counted as evicted, existing rows still
    # accumulate.
    prof_max_stacks: int = 512
    # Ticks kept in the recent-sample ring (the per-thread "where is
    # everyone right now" view that flight-recorder bundles embed).
    prof_ring: int = 64

    # --- performance model (obs/perfmodel.py) ---
    # Per-device interconnect bandwidth in GB/s for the expected-cost
    # link model; 0 = self-calibrate against the rolling observed peak
    # per (verb, tier) — the right default on the CPU bench rig, where
    # nominal link GB/s is meaningless.
    perf_link_gbs: float = 0.0
    # Per-hop latency in microseconds for the link model's step term.
    perf_link_latency_us: float = 1.0

    # --- flight recorder (obs/flightrec.py) ---
    # Directory for auto-dumped postmortem bundles (stall shutdown,
    # round abort, elastic failure, crash).  None = manual
    # hvd.flight_record() only; the ring still records either way.
    flight_recorder_dir: Optional[str] = None
    # Ring capacity in events (0 disables recording).
    flight_recorder_size: int = 2048

    # --- stall inspector († stall_inspector.cc) ---
    stall_check: bool = True
    stall_warning_time_s: float = 60.0
    stall_shutdown_time_s: float = 0.0  # 0 = never abort

    # --- fault injection (horovod_tpu.chaos) ---
    # Deterministic fault spec, e.g.
    # "kv_get:err:p=0.02:seed=7; rank=1:die:after=50; negotiate:delay=300ms:p=0.05".
    # None = disarmed.  Parsed strictly at init() (a chaos plan that
    # cannot be honored must fail loudly, not run a healthy job).
    faults: Optional[str] = None

    # --- /healthz readiness (obs/server.py + context) ---
    # Answer 503 when the engine's last completed negotiation is older
    # than this many seconds (a wedged peer / dead controller leaves
    # this rank unable to progress).  0 disables the age check.
    health_max_negotiation_age_s: float = 0.0

    # --- elastic blacklist decay (runner/elastic.py) ---
    # First-failure cooldown before a blacklisted host is re-admitted on
    # probation; each further failure doubles it (capped below).  <= 0
    # restores the permanent blacklist.
    blacklist_cooldown_s: float = 60.0
    blacklist_max_cooldown_s: float = 600.0

    # --- logging († logging.cc) ---
    log_level: str = "warning"  # trace|debug|info|warning|error|fatal
    log_hide_timestamp: bool = False

    # --- hierarchical collectives († nccl_operations.cc hierarchical mode) ---
    # On TPU: two-level = ICI within a slice + DCN across slices.
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # ICI-group size for the two-level split (ranks per slice).  None =
    # detect from topology: multislice slice boundaries first, else the
    # runner's per-host rank layout (HVDTPU_LOCAL_SIZE), else this
    # process's device count — the analogue of the reference's "local
    # ranks per node".  Setting it is the explicit override.
    hierarchical_local_size: Optional[int] = None
    # Wire mode for the cross-tier (DCN) hop only: ""/fp32 = same as the
    # collective's resolved mode; int8/fp8 = block-scaled quantization on
    # the bandwidth-starved slow tier while the fast tier stays at the
    # base mode (EQuARX's placement).  Cast modes are rejected.
    hierarchical_cross_precision: str = ""

    # --- elastic († runner/elastic) ---
    elastic: bool = False

    # --- autoscaling (autoscale/, elastic mode only) ---
    # Closed-loop controller on the elastic driver: polls /cluster
    # signals (engine queue depth, straggler gauges, SLO burn rates) and
    # grows/shrinks the job through elastic rendezvous.
    autoscale: bool = False
    autoscale_interval_s: float = 2.0
    # Hysteresis band on the max per-rank engine queue depth: >= high
    # is scale-up pressure, <= low is idle, between them nothing moves.
    autoscale_queue_high: float = 8.0
    autoscale_queue_low: float = 1.0
    # SLO burn-rate gate: grow only when burn > threshold on BOTH the
    # fast (5m) and slow (1h) windows (multi-window SRE alerting).
    autoscale_burn_threshold: float = 1.0
    autoscale_up_cooldown_s: float = 30.0
    autoscale_down_cooldown_s: float = 120.0
    # Freshest rank snapshot older than this => signals frozen, hold.
    autoscale_stale_s: float = 10.0
    # Predictive scaling: grow when the robust linear-trend forecast of
    # queue depth this many seconds ahead crosses queue_high, even
    # before the instantaneous threshold trips.  0 disables (reactive
    # only); cooldowns and hysteresis apply unchanged.
    autoscale_forecast_horizon_s: float = 0.0

    # --- coordination / rendezvous († gloo_context.cc reads of env) ---
    # host:port of the torch.distributed TCP store (rank 0 listens there)
    coordinator_addr: Optional[str] = None
    controller_addr: Optional[str] = None   # host:port of native coordinator
    rendezvous_addr: Optional[str] = None   # host:port of KV store
    rank_env: Optional[int] = None
    size_env: Optional[int] = None
    local_rank_env: Optional[int] = None
    local_size_env: Optional[int] = None
    cross_rank_env: Optional[int] = None
    cross_size_env: Optional[int] = None

    # --- device selection ---
    # Mesh axis name of the JAX package's flat data-parallel axis (kept so
    # the two registries hold the same fields; the port has no mesh).
    dp_axis_name: str = "hvd"
    cpu_operations: bool = False
    # "cpu" runs the port on the CPU over Gloo (the tests); None or "gpu"
    # runs it on cuda:<local_rank> over NCCL.
    platform: Optional[str] = None


# (field name, env suffix, parser) — the env surface, mirroring the
# reference's env_parser.cc table.
_ENV_TABLE = [
    ("fusion_threshold", "FUSION_THRESHOLD", _parse_int),
    ("cycle_time_ms", "CYCLE_TIME", float),
    ("wire_precision", "WIRE_PRECISION", _parse_wire_precision),
    ("quant_block_size", "QUANT_BLOCK_SIZE", _parse_int),
    ("quant_min_bytes", "QUANT_MIN_BYTES", _parse_int),
    ("sched_mode", "SCHED_MODE", _parse_sched_mode),
    ("sched_chunks", "SCHED_CHUNKS", _parse_int),
    ("zero", "ZERO", _parse_bool),
    ("bucket_bytes", "BUCKET_BYTES", _parse_int),
    ("cache_capacity", "CACHE_CAPACITY", _parse_int),
    ("autotune", "AUTOTUNE", _parse_bool),
    ("autotune_log", "AUTOTUNE_LOG", str),
    ("autotune_warmup_samples", "AUTOTUNE_WARMUP_SAMPLES", _parse_int),
    ("autotune_steps_per_sample", "AUTOTUNE_STEPS_PER_SAMPLE", _parse_int),
    ("timeline", "TIMELINE", str),
    ("timeline_mark_cycles", "TIMELINE_MARK_CYCLES", _parse_bool),
    ("metrics_port", "METRICS_PORT", _parse_int),
    ("trace_sample", "TRACE_SAMPLE", float),
    ("slo", "SLO", str),
    ("slo_tick_s", "SLO_TICK_SECONDS", float),
    ("tsdb_interval_s", "TSDB_INTERVAL", float),
    ("tsdb_retention_s", "TSDB_RETENTION", float),
    ("alerts", "ALERTS", str),
    ("prof_hz", "PROF_HZ", float),
    ("prof_max_stacks", "PROF_MAX_STACKS", _parse_int),
    ("prof_ring", "PROF_RING", _parse_int),
    ("perf_link_gbs", "PERF_LINK_GBS", float),
    ("perf_link_latency_us", "PERF_LINK_LATENCY_US", float),
    ("flight_recorder_dir", "FLIGHT_RECORDER_DIR", str),
    ("flight_recorder_size", "FLIGHT_RECORDER_SIZE", _parse_int),
    ("stall_check", "STALL_CHECK_DISABLE", lambda v: not _parse_bool(v)),
    ("stall_warning_time_s", "STALL_CHECK_TIME_SECONDS", float),
    ("stall_shutdown_time_s", "STALL_SHUTDOWN_TIME_SECONDS", float),
    ("faults", "FAULTS", str),
    ("health_max_negotiation_age_s", "HEALTH_MAX_NEGOTIATION_AGE", float),
    ("blacklist_cooldown_s", "BLACKLIST_COOLDOWN_SECONDS", float),
    ("blacklist_max_cooldown_s", "BLACKLIST_MAX_COOLDOWN_SECONDS", float),
    ("log_level", "LOG_LEVEL", str),
    ("log_hide_timestamp", "LOG_HIDE_TIME", _parse_bool),
    ("hierarchical_allreduce", "HIERARCHICAL_ALLREDUCE", _parse_bool),
    ("hierarchical_allgather", "HIERARCHICAL_ALLGATHER", _parse_bool),
    ("hierarchical_local_size", "HIERARCHICAL_LOCAL_SIZE", _parse_int),
    ("hierarchical_cross_precision", "HIERARCHICAL_CROSS_PRECISION",
     _parse_cross_precision),
    ("elastic", "ELASTIC", _parse_bool),
    ("autoscale", "AUTOSCALE", _parse_bool),
    ("autoscale_interval_s", "AUTOSCALE_INTERVAL_SECONDS", float),
    ("autoscale_queue_high", "AUTOSCALE_QUEUE_HIGH", float),
    ("autoscale_queue_low", "AUTOSCALE_QUEUE_LOW", float),
    ("autoscale_burn_threshold", "AUTOSCALE_BURN_THRESHOLD", float),
    ("autoscale_up_cooldown_s", "AUTOSCALE_UP_COOLDOWN_SECONDS", float),
    ("autoscale_down_cooldown_s", "AUTOSCALE_DOWN_COOLDOWN_SECONDS", float),
    ("autoscale_stale_s", "AUTOSCALE_STALE_SECONDS", float),
    ("autoscale_forecast_horizon_s", "AUTOSCALE_FORECAST_HORIZON", float),
    ("platform", "PLATFORM", _parse_platform),
    ("coordinator_addr", "COORDINATOR_ADDR", str),
    ("controller_addr", "CONTROLLER_ADDR", str),
    ("rendezvous_addr", "RENDEZVOUS_ADDR", str),
    ("rank_env", "RANK", _parse_int),
    ("size_env", "SIZE", _parse_int),
    ("local_rank_env", "LOCAL_RANK", _parse_int),
    ("local_size_env", "LOCAL_SIZE", _parse_int),
    ("cross_rank_env", "CROSS_RANK", _parse_int),
    ("cross_size_env", "CROSS_SIZE", _parse_int),
    ("cpu_operations", "CPU_OPERATIONS", _parse_bool),
]

_FIELD_PARSERS = {field: parser for field, _, parser in _ENV_TABLE}

_PREFIXES = ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_")


def _env_lookup(suffix: str) -> Optional[str]:
    for prefix in _PREFIXES:
        v = os.environ.get(prefix + suffix)
        if v is not None:
            return v
    return None


def from_env(base: Optional[Config] = None) -> Config:
    """Build a Config from the environment, starting from ``base`` defaults."""
    cfg = dataclasses.replace(base) if base is not None else Config()
    for field, suffix, parser in _ENV_TABLE:
        raw = _env_lookup(suffix)
        if raw is None:
            continue
        try:
            setattr(cfg, field, parser(raw))
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad value {raw!r} for env knob {suffix}: {e}") from None
    return cfg


def from_yaml(path: str, base: Optional[Config] = None) -> Config:
    """Load knobs from a YAML/flat ``key: value`` config file.

    Mirrors the reference's ``--config-file`` surface (†
    ``runner/common/util/config_parser.py``).  We parse a flat ``key: value``
    subset without requiring PyYAML (not a guaranteed dependency).
    """
    cfg = dataclasses.replace(base) if base is not None else Config()
    valid = {f.name: f for f in dataclasses.fields(Config)}
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if ":" not in line:
                raise ValueError(f"{path}:{lineno}: expected 'key: value'")
            key, _, val = line.partition(":")
            key = key.strip().replace("-", "_")
            val = val.strip()
            if key not in valid:
                raise ValueError(f"{path}:{lineno}: unknown knob {key!r}")
            current = getattr(cfg, key)
            table_parser = _FIELD_PARSERS.get(key)
            # The isinstance chain must stay ahead of the table parsers:
            # table parsers decode the *env-var* representation, which can
            # differ in meaning from the YAML field (e.g. stall_check's env
            # form is STALL_CHECK_DISABLE, inverted).  YAML keys are field
            # names, so typed fields parse by field type.
            if isinstance(current, bool):
                parsed: Any = _parse_bool(val)
            elif isinstance(current, int):
                parsed = int(val)
            elif isinstance(current, float):
                parsed = float(val)
            elif table_parser is not None:
                # same validation as the env surface (e.g. platform)
                parsed = table_parser(val)
            else:
                parsed = val
            setattr(cfg, key, parsed)
    return cfg


# Knobs whose feature the port does not have yet: field -> the ROADMAP.md
# section A item that ports it, named by its title (titles outlive the
# items' numbers).  Set away from its default (and from the values of
# :data:`_PORTED_VALUES`), each one raises at ``init`` rather than being
# quietly ignored.
_HIER = "'Hierarchy'"
_NOT_PORTED = {
    "hierarchical_allreduce": _HIER,
    "hierarchical_allgather": _HIER,
    "hierarchical_local_size": _HIER,
    "hierarchical_cross_precision": _HIER,
}
# Values of a knob of _NOT_PORTED that the port does run.
_PORTED_VALUES: dict = {}


def check_ported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for the first knob of
    :data:`_NOT_PORTED` that ``cfg`` sets away from its default to a
    value the port does not run."""
    defaults = Config()
    for field, item in _NOT_PORTED.items():
        value = getattr(cfg, field)
        if value != getattr(defaults, field) and \
                value not in _PORTED_VALUES.get(field, ()):
            raise NotImplementedError(
                f"{field}={value!r} is not ported to horovod_tpu_torch yet "
                f"(ROADMAP section A {item}); leave it at its default "
                f"{getattr(defaults, field)!r}")
