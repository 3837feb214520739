"""Online autotuning of fusion threshold, cycle time and bucket cap.

The port of ``horovod_tpu/utils/autotune.py``.  † ``horovod/common/
parameter_manager.cc`` + ``optim/bayesian_optimization.cc``: the
reference tunes (fusion threshold, cycle time) online with Bayesian
optimization (Gaussian process + expected improvement) against observed
throughput, after a warmup, writing decisions to ``HOROVOD_AUTOTUNE_LOG``.

This keeps the JAX package's control loop (warmup → propose → score →
commit best), its candidate grid, its numpy GP (RBF kernel at a fixed
length scale), its expected-improvement rule, its settle cycles after a
commit, its log lines and its ``hvd_autotune_*`` metrics.  It searches
what the JAX package searches in a **multi-process** job:

- the fusion threshold (1 MB .. 128 MB);
- the engine's cycle time (0.5 .. 20 ms);
- the bucket cap (``config.bucket_bytes``): 0 (the threshold alone
  groups) or a cap the engine's fusion grouping honours.

Wire precision, schedule and hierarchy stay pinned at ``fp32``,
``monolithic`` and ``flat``, the values the JAX package pins them to
when each rank tunes from its own scores: a per-rank commit of any of
them would resolve one tensor differently on different ranks.  Every
job of the port is one process a rank, so there is no single-controller
branch; the threshold, cycle time and cap only pace and group the local
engine thread, and group composition still agrees through negotiation
order.

The score is the logical payload bytes of a busy cycle over its host
wall time, as in the JAX package.  On the card that window holds the
negotiation and the launch of the engine stream's work, not the NCCL
transfer itself.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from ..obs import REGISTRY as _obs

# Candidate grid (log2 bytes for threshold, ms for cycle time), spanning the
# same range the reference explores.
_THRESHOLDS = [1 << p for p in range(20, 28)]         # 1 MB .. 128 MB
_CYCLE_TIMES = [0.5, 1.0, 2.5, 5.0, 10.0, 20.0]        # ms
# Bucket-cap dimension (config.bucket_bytes): 0 means uncapped — the
# fusion threshold alone governs grouping — plus the caps worth
# searching (a small cap dispatches the first backward buckets sooner;
# a large one amortizes per-collective overhead).
_BUCKET_BYTES = [0, 4 << 20, 32 << 20]
# The pinned dimensions (module docstring), at the configured defaults.
_WIRE, _SCHED, _HIER = "fp32", "monolithic", "flat"
# GP-space spacing between adjacent categorical values; comparable to one
# grid step in the log2-threshold dimension so no dimension dominates the
# RBF distance.
_MODE_SCALE = 2.0
# Cycles discarded right after a knob commit before scoring resumes: the
# first cycles under a new config are not yet representative of it.
_SETTLE_CYCLES = 2

_m_trials = _obs.counter(
    "hvd_autotune_trials_total", "knob configurations scored by the tuner")
_m_score = _obs.gauge(
    "hvd_autotune_score_bytes_per_s",
    "latest trial's effective (logical bytes) throughput score")
_m_threshold = _obs.gauge(
    "hvd_autotune_fusion_threshold_bytes", "fusion threshold in effect")
_m_cycle_ms = _obs.gauge(
    "hvd_autotune_cycle_time_ms", "engine cycle time in effect")


class _GP:
    """Minimal RBF-kernel GP regressor over the knob space."""

    def __init__(self, length_scale: float = 1.0, noise: float = 1e-3) -> None:
        self.ls = length_scale
        self.noise = noise
        self.X: Optional[np.ndarray] = None
        self.y: Optional[np.ndarray] = None
        self._K_inv: Optional[np.ndarray] = None

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d / self.ls ** 2)

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        self.X, self.y = X, y
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self._K_inv = np.linalg.inv(K)

    def predict(self, Xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        assert self.X is not None and self._K_inv is not None
        Ks = self._k(Xs, self.X)
        mu = Ks @ self._K_inv @ self.y
        var = 1.0 - np.einsum("ij,jk,ik->i", Ks, self._K_inv, Ks)
        return mu, np.maximum(var, 1e-12)


def _expected_improvement(mu: np.ndarray, var: np.ndarray, best: float
                          ) -> np.ndarray:
    sigma = np.sqrt(var)
    z = (mu - best) / sigma
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
    pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2.0 * math.pi)
    return (mu - best) * cdf + sigma * pdf


class Autotuner:
    """Propose/score loop attached to the engine's cycle callback.

    Knobs are kept as the JAX package's six-tuples ``(threshold,
    cycle_ms, wire, sched, hier, bucket)`` with the middle three pinned,
    so the samples, the GP coordinates and the log lines are the JAX
    package's multi-process ones."""

    def _norm_point(self, threshold: int, cycle_ms: float, mode: str,
                    sched: str, hier: str, bucket: int
                    ) -> tuple[float, float, float, float, float, float]:
        """Raw knobs -> GP coordinates (the pinned dimensions sit at 0)."""
        return (math.log2(threshold), math.log2(cycle_ms), 0.0, 0.0, 0.0,
                self._buckets.index(bucket) * _MODE_SCALE)

    def __init__(self, state) -> None:
        self._state = state
        cfg = state.config
        self._warmup_left = cfg.autotune_warmup_samples
        self._steps_per_sample = cfg.autotune_steps_per_sample
        self._log_path = cfg.autotune_log
        # An off-grid configured cap joins the candidates instead of being
        # reverted.
        bucket_default = int(cfg.bucket_bytes or 0)
        self._buckets = list(_BUCKET_BYTES) + (
            [bucket_default] if bucket_default not in _BUCKET_BYTES else [])
        self._grid_raw = [(t, c, _WIRE, _SCHED, _HIER, b)
                          for t in _THRESHOLDS for c in _CYCLE_TIMES
                          for b in self._buckets]
        self._grid = np.array([self._norm_point(*p) for p in self._grid_raw])
        # Normalized GP inputs AND the exact raw grid knobs of each
        # sample: committing from the raw record keeps the committed
        # cycle time exactly on the candidate grid (a ``2 ** log2``
        # round-trip drifts, e.g. 2.5 ms -> 2.4999999999999996).
        self._samples_X: list[
            tuple[float, float, float, float, float, float]] = []
        self._samples_raw: list[tuple[int, float, str, str, str, int]] = []
        self._samples_y: list[float] = []
        self._current = (cfg.fusion_threshold, cfg.cycle_time_ms, _WIRE,
                         _SCHED, _HIER, bucket_default)
        self._acc_bytes = 0
        self._acc_time = 0.0
        self._acc_cycles = 0
        self._settle_left = 0
        self._done = False

    def record_cycle(self, payload_bytes: int, cycle_seconds: float) -> None:
        """Score one engine cycle.  ``payload_bytes`` is the LOGICAL
        payload (entry bytes) of the cycle's ready entries."""
        if self._done or payload_bytes == 0:
            return
        if self._settle_left > 0:
            self._settle_left -= 1
            return
        self._acc_bytes += payload_bytes
        self._acc_time += cycle_seconds
        self._acc_cycles += 1
        if self._acc_cycles < self._steps_per_sample:
            return
        score = self._acc_bytes / max(self._acc_time, 1e-9)  # bytes/s
        self._acc_bytes, self._acc_time, self._acc_cycles = 0, 0.0, 0
        if self._warmup_left > 0:
            self._warmup_left -= 1
            self._log(f"warmup score={score:.3e}")
            return
        self._samples_X.append(self._norm_point(*self._current))
        self._samples_raw.append(self._current)
        self._samples_y.append(score)
        _m_trials.inc()
        _m_score.set(score)
        self._propose_next()

    def _propose_next(self) -> None:
        X = np.asarray(self._samples_X)
        y = np.asarray(self._samples_y)
        y_norm = (y - y.mean()) / (y.std() + 1e-9)
        gp = _GP(length_scale=2.0)
        gp.fit(X, y_norm)
        mu, var = gp.predict(self._grid)
        ei = _expected_improvement(mu, var, y_norm.max())
        idx = int(np.argmax(ei))
        threshold, cycle, mode, sched, hier, bucket = self._grid_raw[idx]
        self._apply(threshold, cycle, bucket)
        best = int(np.argmax(y))
        self._log(
            f"sample #{len(y)} score={y[-1]:.3e} -> next "
            f"threshold={threshold} cycle_ms={cycle} wire={mode} "
            f"sched={sched} hier={hier} bucket={bucket} "
            f"(best so far {self._samples_raw[best]} @ {y[best]:.3e})")
        # Convergence: stop after exploring enough with no improvement,
        # committing the best-seen knobs († ParameterManager stops tuning).
        if len(y) >= 12 and best < len(y) - 6:
            bt, bc, bm, bs, bh, bb = self._samples_raw[best]
            self._apply(bt, bc, bb)
            self._done = True
            self._log(f"converged: threshold={bt} cycle_ms={bc} "
                      f"wire={bm} sched={bs} hier={bh} bucket={bb}")

    def _apply(self, threshold: int, cycle_ms: float, bucket: int) -> None:
        """Commit knobs to the live config the engine reads every cycle."""
        self._current = (threshold, cycle_ms, _WIRE, _SCHED, _HIER, bucket)
        self._settle_left = _SETTLE_CYCLES
        cfg = self._state.config
        cfg.fusion_threshold = threshold
        cfg.cycle_time_ms = cycle_ms
        cfg.bucket_bytes = bucket
        _m_threshold.set(threshold)
        _m_cycle_ms.set(cycle_ms)

    def _log(self, msg: str) -> None:
        if not self._log_path:
            return
        with open(self._log_path, "a") as fh:
            fh.write(f"{time.time():.3f} {msg}\n")
