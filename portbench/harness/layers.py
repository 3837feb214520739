"""What the per-layer readers share: the runtime's device work told from
the step's compute on the device timeline, a kernel's roofline share, and
the whole step's share of the card's peak.

The runtime (``optim/distributed.py``, ``ops/engine.py``,
``ops/collectives.py``) launches NCCL's kernels and, on the engine's own
stream, the packing and unpacking copies of fused buffers.  So its work
is every device operation off the stream that carries the step's compute
(the busiest stream outside NCCL), and every NCCL kernel."""

from __future__ import annotations

from typing import Optional

from . import trace, yardstick


def _is_runtime(d, compute: Optional[int]) -> bool:
    return "nccl" in d.name.lower() or d.stream != compute


def runtime_ms(p: trace.Profile) -> float:
    """Device ms a step in which the runtime's work runs."""
    compute = trace.compute_stream(p)
    pairs = trace.union((d.start, d.end) for d in p.device
                        if _is_runtime(d, compute))
    return trace.measure(trace.clip(pairs, *p.region)) / p.steps * 1e3


def exposed_ms(p: trace.Profile) -> float:
    """Ms a step in which runtime work runs and no compute work does."""
    compute = trace.compute_stream(p)
    rt = trace.union((d.start, d.end) for d in p.device
                     if _is_runtime(d, compute))
    comp = trace.union((d.start, d.end) for d in p.device
                       if not _is_runtime(d, compute))
    return trace.measure(trace.clip(trace.subtract(rt, comp), *p.region)) \
        / p.steps * 1e3


def mean_over_ranks(ctx, fn) -> Optional[float]:
    vals = [fn(p) for p in ctx.profiles if p.device]
    return sum(vals) / len(vals) if vals else None


def idle_share_pct(ctx) -> Optional[float]:
    """100 x (1 - busy / window) of the fullest rank (the most busy)."""
    profs = [p for p in ctx.profiles if p.device]
    if not profs:
        return None
    p = max(profs, key=trace.busy_s)
    return 100.0 * (1.0 - trace.busy_s(p) / p.window_s)


def roofline_pct(ctx, kernels: dict) -> Optional[float]:
    """100 x (least time the launches could take) / (their device time),
    over every rank's profiled steps.  ``kernels`` maps a name fragment
    to the least seconds of one launch; None where none launched."""
    bound = spent = 0.0
    for p in ctx.profiles:
        for d in p.device:
            for frag, least in kernels.items():
                if frag in d.name:
                    bound += least
                    spent += d.end - d.start
                    break
    return 100.0 * bound / spent if spent > 0 else None


def flash_bound_s(ctx, kind: str) -> float:
    """The least time of one causal flash launch (``fwd``, ``dq`` or
    ``dkv``) at the attention shape of one rank's step."""
    c, tr = ctx.cell.config, ctx.cell.traffic
    B, S = tr["batch"], tr["seq"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    D = c.get("head_dim") or c["hidden_size"] // H
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    return yardstick.bound_s(yardstick.flash_bytes(B, S, H, KV, D, kind),
                             yardstick.flash_flops(B, S, H, D, True,
                                                   products))


def mfu_pct(ctx, flops_per_unit: float) -> Optional[float]:
    """The whole step's share of the card's bf16 peak: units a second
    over all ranks x operations a unit, over the peak of every card.
    None where the trace saw no device (a run off the card)."""
    if not any(p.device for p in ctx.profiles):
        return None
    return 100.0 * ctx.rate * flops_per_unit / (yardstick.BF16_FLOPS
                                                * ctx.ranks)
