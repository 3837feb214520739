#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, ``horovod_tpu_torch``.

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It drives the port's main path on the card and checks it, phase by phase,
printing one JSON line per phase:

1. ``device``  the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. ``build``   the CUDA kernel of the path, built from ``csrc/`` and
   loaded, with the seconds it took;
3. ``kernel``  the kernel against its plain PyTorch version on the card,
   in bf16 at the shapes the main path gives it and in fp32 at the tiny
   model's shape: each output row (one request, one head) within a
   tolerance scaled to that row's largest value, and the kernel's, the
   plain version's and one library call's time (CUDA events, L2 flushed
   before every launch) beside the bound the card's memory rate sets;
4. ``serve``   Llama-2-7B at full width (random weights from a seeded
   ``torch.Generator``) served through ``serve()``: 8 requests of 64-512
   prompt tokens and 32 new tokens each.  Every kernel launch counter is
   zeroed just before the run and read just after; each kernel must have
   launched, ``paged_decode`` exactly once per layer per decode tick.  One
   decode tick's logits through the kernel must match the gather path's.

Then a ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before the last line; without a CUDA device the script exits 2.
``--phases`` runs a subset (``device,build,kernel,serve``).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

# Published H100 SXM rates (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
PHASES = ("device", "build", "kernel", "serve")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_cold(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card, with the 50 MB L2
    overwritten before each launch so every call finds it cold."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# paged_decode against its plain version
# ---------------------------------------------------------------------------

def paged_case(torch, gen, *, B, H, KV, Dh, BS, lengths, n_cols, dtype):
    """Inputs of one paged-decode call: each row's pages drawn without
    replacement from the pool (block 0 is scratch), padded columns at
    block 0, pool and q random in ``dtype``."""
    pages = [-(-n // BS) for n in lengths]
    NB = sum(pages) + 1
    dev = "cuda"
    q = torch.randn(B, H, Dh, generator=gen, device=dev).to(dtype)
    kp = torch.randn(NB, BS, KV, Dh, generator=gen, device=dev).to(dtype)
    vp = torch.randn(NB, BS, KV, Dh, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
    tables = torch.zeros(B, n_cols, dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


# Per-row tolerance of the kernel against its plain version, as a share of
# the largest |value| of the row (one request, one head).  bf16: 2^-5, 4 to
# 8 bf16 ulps of that value.  The kernel rounds p to bf16 before the P.V
# product, as the TPU kernel does, and both round the output to bf16,
# which together stay within about 2 ulps.  A page dropped or misrouted in
# any request of the 7B shape moves one of its rows by several times the
# limit.  fp32: 2^-14, fp32 sums in another order.
ROW_REL_TOL = {"bfloat16": 2.0 ** -5, "float32": 2.0 ** -14}


def check_paged_decode(torch, gen, *, label, B, H, KV, Dh, BS, lengths,
                       n_cols, dtype=None, timed=True):
    """Kernel vs plain version at one shape: every output row within
    ``ROW_REL_TOL`` of its own largest value; then, if ``timed``, the
    kernel, the plain version and the library yardstick timed."""
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as FA

    dtype = dtype or torch.bfloat16
    dname = str(dtype).split(".")[-1]
    q, kp, vp, tables, lens = paged_case(
        torch, gen, B=B, H=H, KV=KV, Dh=Dh, BS=BS, lengths=lengths,
        n_cols=n_cols, dtype=dtype)
    out = FA.paged_attention(q, kp, vp, tables, lens)
    ref = FA.paged_attention_reference(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    row_err = diff.amax(dim=-1)                                  # [B, H]
    row_mag = ref.float().abs().amax(dim=-1)
    ratio = (row_err / row_mag.clamp_min(1e-30)).max().item()
    rel_tol = ROW_REL_TOL[dname]
    if not (math.isfinite(err) and ratio <= rel_tol):
        raise AssertionError(
            f"paged_decode {label}: worst row |kernel - plain| is {ratio} "
            f"of the row's largest value (limit {rel_tol}); max abs {err}")
    res = {
        "phase": "kernel", "name": "paged_decode", "shape": label,
        "B": B, "H": H, "KV": KV, "Dh": Dh, "BS": BS, "n_cols": n_cols,
        "lengths": list(lengths), "dtype": dname, "max_abs_err": err,
        "worst_row_rel_err": ratio, "row_rel_tol": rel_tol,
    }
    if not timed:
        emit(res)
        return res

    # The library yardstick: SDPA on already-gathered, masked K/V (the
    # gather is outside the timed call).  The port never calls it.
    T = n_cols * BS
    kg = kp[tables.long()].reshape(B, T, KV, Dh).transpose(1, 2).contiguous()
    vg = vp[tables.long()].reshape(B, T, KV, Dh).transpose(1, 2).contiguous()
    if KV != H:
        kg = kg.repeat_interleave(H // KV, dim=1)
        vg = vg.repeat_interleave(H // KV, dim=1)
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_out = F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)
    res["library_max_abs_err"] = (
        lib_out[:, :, 0].float() - ref.float()).abs().max().item()

    ms = time_cold(torch, lambda: FA.paged_attention(q, kp, vp, tables, lens))
    plain_ms = time_cold(torch, lambda: FA.paged_attention_reference(
        q, kp, vp, tables, lens))
    library_ms = time_cold(torch, lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask))

    # Least time for the same work: each input read once (q, the live
    # K/V pages, tables, lengths), the output written once; operations
    # are QK and PV, 2 flops a multiply-add, for the live positions.
    nbytes = (FA.paged_bytes(kp, lengths, n_cols)
              + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + lens.numel() * 4)
    flops = 4 * H * Dh * sum(min(n, T) for n in lengths)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    res.update({
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    })
    emit(res)
    return res


def phase_kernel(torch) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    # Ragged lengths 1..2048, partial last pages, rows padded to 128
    # columns at block 0.
    ragged = [1, 17, 300, 777, 1024, 1500, 2000, 2048]
    res7b = check_paged_decode(torch, gen, label="llama2_7b_decode", B=8,
                               H=32, KV=32, Dh=128, BS=16, lengths=ragged,
                               n_cols=128)
    check_paged_decode(torch, gen, label="gqa_rep4", B=8, H=32, KV=8,
                       Dh=128, BS=16, lengths=ragged, n_cols=128)
    # The serve phase's own decode shape: contexts 64..544 in a 64-column
    # (power-of-two bucketed) table.
    check_paged_decode(torch, gen, label="serve_decode", B=8, H=32, KV=32,
                       Dh=128, BS=16,
                       lengths=[65, 129, 193, 257, 321, 385, 449, 513],
                       n_cols=64)
    # fp32 at LlamaConfig.tiny()'s shape (H4 KV2 Dh16, 8-token pages), as
    # the CPU parity tests serve it.
    check_paged_decode(torch, gen, label="tiny_fp32", B=3, H=4, KV=2,
                       Dh=16, BS=8, lengths=[5, 17, 30], n_cols=6,
                       dtype=torch.float32, timed=False)
    return res7b


# ---------------------------------------------------------------------------
# serve() on full-width Llama-2-7B
# ---------------------------------------------------------------------------

def phase_serve(torch, smi: str) -> dict:
    import numpy as np

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as FA

    cfg = llama.LlamaConfig.llama2_7b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    sess = serving.serve(params, cfg, num_blocks=512, max_active=8,
                         block_size=16)
    eng = sess.engine
    rng = np.random.RandomState(0)
    # Warm-up request: first-call library set-up stays out of the timings.
    warm = sess.submit(rng.randint(0, cfg.vocab_size, size=(16,)), 2)
    sess.drain()
    assert len(warm.result().tokens) == 2

    lens = [64, 128, 192, 256, 320, 384, 448, 512]
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in lens]
    emit_t: dict[int, list[float]] = {}

    def on_token(req_id, tok):
        emit_t.setdefault(req_id, []).append(time.perf_counter())

    FA.paged_attention.launches = 0            # every counter of the path
    ticks0 = eng.decode_ticks
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    futs = [sess.submit(p, 32, stream_cb=on_token) for p in prompts]
    sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = FA.paged_attention.launches
    ticks = eng.decode_ticks - ticks0

    results = [f.result() for f in futs]
    for r in results:
        if len(r.tokens) != 32 or not all(0 <= t < cfg.vocab_size
                                          for t in r.tokens):
            raise AssertionError(f"request {r.req_id}: bad tokens {r.tokens}")
    if launches == 0 or launches != ticks * cfg.n_layers:
        raise AssertionError(
            f"paged_decode launched {launches} times over {ticks} decode "
            f"ticks; want {cfg.n_layers} per tick")

    ttft = sorted(r.metrics["ttft_s"] for r in results)
    itl = sorted(b - a for ts in emit_t.values()
                 for a, b in zip(ts, ts[1:]))
    decode_tokens = sum(len(r.tokens) - 1 for r in results)
    first = min(min(ts) for ts in emit_t.values())
    last = max(max(ts) for ts in emit_t.values())
    res = {
        "phase": "serve", "model": "llama2_7b", "dtype": "bfloat16",
        "requests": len(results), "prompt_lens": lens, "max_tokens": 32,
        "decode_ticks": ticks, "paged_decode_launches": launches,
        "init_s": init_s, "wall_s": wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "itl_p50_s": itl[len(itl) // 2],
        "itl_p99_s": itl[min(len(itl) - 1, int(0.99 * len(itl)))],
        "decode_tokens_per_s": decode_tokens / (last - first),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": smi,
    }
    emit(res)
    logits_parity(torch, params, cfg, eng)
    decode_breakdown(torch, eng, smi)
    sess.close()
    return {"launches": launches}


def decode_breakdown(torch, eng, smi: str, ticks: int = 5) -> None:
    """Where one decode tick's time goes: the host clock per tick (work
    ending in a synchronise), the device time the profiler attributes to
    kernels per tick, the idle share between them, and the kernels that
    take the most device time.  8 slots at contexts 64-512 over blocks
    the served run wrote; the pool is written in place, as serving does."""
    from torch.profiler import ProfilerActivity, profile

    R = eng.ecfg.max_active
    pos = torch.arange(R, dtype=torch.int32, device="cuda") * 64 + 64
    tables = (torch.arange(R * 64, dtype=torch.int32, device="cuda")
              .reshape(R, 64) % (eng.ecfg.num_blocks - 1) + 1)
    tok = torch.zeros(R, dtype=torch.int32, device="cuda")
    eng._decode(tok, pos, tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng._decode(tok, pos, tables)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng._decode(tok, pos, tables)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "decode_breakdown", "slots": R, "n_cols": 64,
          "contexts": pos.tolist(), "wall_ms_per_tick": wall_ms,
          "device_ms_per_tick": device_ms if kernels else "not measured",
          "device_idle_share": (1 - device_ms / wall_ms) if kernels
          else "not measured",
          "top_kernels_ms_per_tick": {
              e.key[:80]: e.self_device_time_total / 1e3 / ticks
              for e in top},
          "card": smi})


def logits_parity(torch, params, cfg, eng) -> None:
    """One decode tick's logits through the kernel against the gather
    path (``use_flash=False``) on clones of the served pool: 8 slots at
    ragged contexts over blocks the run wrote, first through one layer,
    then through all 32.

    Tolerance, bf16 model: the gather path rounds attention scores to
    bf16 and the kernel keeps them in fp32, and with random weights the
    difference grows with depth.  One layer: max |diff| within 3% of the
    largest logit.  32 layers: within 10%, and at least 7 of 8 greedy
    tokens agree.  A wrong page, offset or length would move the logits
    by their own size and the greedy tokens at random."""
    import dataclasses

    from horovod_tpu_torch.models import llama

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    BS = eng.ecfg.block_size
    pos = torch.tensor([63, 127, 200, 255, 300, 383, 420, 511],
                       dtype=torch.int32, device="cuda")
    n_cols = 32
    blocks = torch.randperm(eng.ecfg.num_blocks - 1, generator=gen,
                            device="cuda")[:8 * n_cols] + 1
    tables = blocks.reshape(8, n_cols).to(torch.int32).contiguous()
    tok = torch.randint(0, cfg.vocab_size, (8,), generator=gen,
                        device="cuda", dtype=torch.int32)
    for depth, rel, min_agree in ((1, 0.03, 0), (cfg.n_layers, 0.10, 7)):
        cfg_d = dataclasses.replace(cfg, n_layers=depth)
        outs = []
        for flash in (True, False):
            kp, vp = eng.k_pool.clone(), eng.v_pool.clone()
            logits, _, _ = llama.decode_step_paged(
                params, tok, pos, kp, vp, tables, cfg_d, use_flash=flash)
            outs.append(logits)
            del kp, vp
        a, b = outs
        diff = (a - b).abs().max().item()
        scale = b.abs().max().item()
        agree = int((a.argmax(-1) == b.argmax(-1)).sum().item())
        emit({"phase": "logits_parity", "layers": depth,
              "max_abs_diff": diff, "max_abs_logit": scale,
              "rel_tol": rel, "argmax_agree": agree})
        if not (math.isfinite(diff) and diff <= rel * scale
                and agree >= min_agree):
            raise AssertionError(
                f"decode logits kernel vs gather over {depth} layer(s): "
                f"max diff {diff} (largest logit {scale}), argmax agree "
                f"{agree}/8")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as FA

    smi = nvidia_smi_line()
    if "device" in phases:
        emit({"phase": "device", "nvidia_smi": smi,
              "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
    if "build" in phases:
        t0 = time.perf_counter()
        _build.load("paged_decode", FA._SIGNATURES)
        emit({"phase": "build", "kernel": "paged_decode",
              "seconds": time.perf_counter() - t0,
              "library": str(_build._target("paged_decode")[1])})
    res = phase_kernel(torch) if "kernel" in phases else None
    served = phase_serve(torch, smi) if "serve" in phases else None
    if res is not None and served is not None:
        emit({"kernels": [{
            "name": "paged_decode", "route": "cuda",
            "source": "horovod_tpu_torch/csrc/paged_decode.cu",
            "replaces": "horovod_tpu/ops/flash_attention.py:367",
            "launches": served["launches"],
            "max_abs_err": res["max_abs_err"],
            "worst_row_rel_err": res["worst_row_rel_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
        }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
