#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, ``horovod_tpu_torch``.

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It drives the port's main paths on the card, serving (with the front
door's prefix cache and speculative decoding, and batch ``generate``),
multi-replica serving (the router, disaggregated prefill/decode),
training (with its recompute and loss variants, as a Switch-MoE, on a
mesh, as two pipeline stages), sharded serving at one rank and
data-parallel training through Horovod's runtime, the model zoo
(ResNet-50, BERT-Large, DLRM) trained through it, and the estimator's
fit of the MNIST ConvNet, and checks them, phase
by phase, printing one JSON line per phase:

1. ``device``  the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. ``build``   the CUDA kernels, ``paged_decode``, ``flash_fwd`` and
   ``flash_bwd``, built from ``csrc/`` (one ``nvcc`` each, all at once)
   and loaded, with the seconds each took;
3. ``kernel``  each kernel against its plain PyTorch version on the card
   (fp32, TF32 off), in bf16 at the shapes the main paths give it, plus
   two flash shapes whose S is a multiple of 64 but not of 128 (causal
   GQA, and full GQA at head dim 64) and one long paged-decode request,
   where the split over table columns matters most, and one split of more
   than 4096 columns, whose table stays in device memory (and
   ``paged_decode`` also in fp32 at the tiny model's shape); at every
   flash shape two launches of each backward kernel must give bitwise
   equal dq, dk and dv (no atomics, a fixed order of sums):
   each output row (one position or request, one head) within a tolerance
   scaled to that row's largest value, and the kernel's, the plain
   version's and one library call's time (CUDA events around the device's
   own work, L2 flushed before every launch) beside the bound the card's
   memory or tensor-core rate sets; at the serve shape also the host time
   of one ``paged_attention`` call;
4. ``serve``   Llama-2-7B at full width (random weights from a seeded
   ``torch.Generator``) served through ``serve()``: 8 requests of 64-512
   prompt tokens and 32 new tokens each.  Every kernel launch counter is
   zeroed just before the run and read just after; ``paged_decode`` must
   launch exactly once per layer per decode tick, the flash kernels never.
   One decode tick's logits through the kernel must match the gather
   path's;
5. ``frontdoor``  the same model (serve's seed) through the front door's
   paths, a pool of 512 blocks of 16, 8 slots, 32 new tokens a request,
   every launch counter zeroed before each part and read after it:
   ``generate`` on 4 prompts of 128 tokens (no kernel launched; its tokens
   counted against ``serve()``'s); the prefix cache, a cold 512-token head
   then 7 requests of head + 16..112 tokens (each hit 512 cached tokens;
   7 hits, 7 x 32 shared blocks, 7 x 512 skipped tokens; ``paged_decode``
   32 times a decode tick, the flash kernels never; the TTFT of the hits
   beside the cold one's); speculative decoding at k = 4 on serve's 8
   prompts with the target as its own draft and with a weak draft (4
   layers, d_model 1024; every round emits 1..k+1 tokens a request,
   ``paged_decode`` never, the acceptance rate); then every token those
   parts emitted teacher-forced through one ``forward`` (the flash
   kernels): the argmax at its position or within ``FD_DELTA_REL`` of the
   row's largest logit below the top, the share of exact argmaxes beside
   that of plain ``serve()`` on the same prompts; last, 2 layers at full
   width in fp32 with TF32 off: ``generate``, ``serve()`` through the
   paged kernel, a prefix-hit ``serve()`` and ``serve(spec_k=2)`` with
   the target as its draft emit the same tokens, acceptance 1.0;
6. ``replicas``  multi-replica serving on the same model (serve's seed,
   one set of weights for every session), pools of 512 blocks of 16, 8
   slots and the prefix cache each, serve's 8 prompts, 32 new tokens a
   request, every launch counter zeroed before each part and read after
   it: the front door's ``Router`` (default config) over two
   ``LocalReplica`` sessions, the one holding the most flights killed once
   every request streamed a token (both replicas placed on first, every
   request complete, failovers at least the flights it held); then the
   ``DisaggRouter`` over one prefill and two decode
   ``LocalDisaggReplica`` sessions, every migration through the port's
   native ``KvServer``/``KvClient`` on 127.0.0.1, the decode replica
   holding the most flights killed after the first decode tokens (every
   request migrated and complete, its flights re-imported on the other,
   the imported pages bitwise equal to the payload's blocks not attached
   from the prefix cache, the prefill engine without a decode tick).  In
   both ``paged_decode`` launches 32 times a decode tick of each engine,
   the flash kernels never; the emitted tokens teacher-forced as in
   ``frontdoor``; TTFT and ITL as the client sees them beside serve's, the
   router's host ms a pump, migration bytes, each leg's ms and GB/s
   (gather and D2H, ``tobytes``, publish, fetch, H2D and scatter; each
   closed by a synchronise) and ``hvd_disagg_handoff_seconds``.  Last, 2
   layers at full width in fp32 with TF32 off: a router run and a
   disaggregated run, each with a replica killed, emit plain
   ``serve()``'s tokens exactly;
7. ``train``   Llama-2-7B at full width and depth, bf16, per-layer
   recompute, one sequence of 4096 tokens a step, Adam (lr 1e-3, fused):
   one warm-up step and three timed steps on one batch.  Every counter is
   zeroed just before and read just after: per step ``flash_fwd`` must
   launch 2 x 32 times (forward and recompute), ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` 32 times each, ``paged_decode`` never; the losses
   must be finite, start near ln(32000) and fall.  Then a profile of one
   step: device time, idle share, top kernels;
8. ``train_variants``  train's model, seed and batch, fresh weights for
   each, one warm-up and three timed steps: ``remat="dots"`` (the weight
   products kept, the rest recomputed; first loss bitwise equal to
   train's) and ``blockwise_ce=True`` (first loss within
   ``BLOCKWISE_FIRST_REL``); later losses within ``DP_LOSS_REL``, train's
   flash launches a step, step time and peak memory beside train's;
9. ``train_dp``  the same model, weights and batch through the runtime at
   one rank: ``hvd.init()`` (NCCL on cuda:0), ``broadcast_parameters``,
   ``DistributedOptimizer`` over the same fused Adam, one warm-up and
   three timed steps.  Per step exactly one allreduce entry per
   trainable leaf (291), covering every gradient byte, with at least one
   fused dispatch and NCCL dispatches; every gradient and NCCL buffer on
   cuda:0; the flash launches of ``train``; the first loss bitwise equal
   to ``train``'s, the others within ``DP_LOSS_REL``.  Then a profile of
   one step (the engine stream's and NCCL's device time, the engine's
   cycles) and every verb at world size 1 on CUDA tensors, with a 16 MB
   allreduce timed, and the engine's CUDA-event timing of a group for
   the performance model (which times nothing at one rank, so the rank
   poses as two for one call);
10. ``train_zero``  under ``Config(wire_precision="int8",
   sched_mode="decomposed")`` at one rank: train_dp's step again, whose
   losses must be bitwise equal to train_dp's with no schedule walked and
   no wire byte saved (the knobs are inert at one rank, as in the JAX
   package); then train's model, weights and batch through
   ``ZeroDistributedOptimizer`` around fused Adam, one warm-up and three
   timed steps: train's flash launches a step, the first loss bitwise
   equal to train's and the later ones within ``DP_LOSS_REL``, every
   gradient a view into a flat bucket, ``hvd_zero_state_bytes`` equal to
   Adam's moments over the shard (padding included) and a step counter
   a piece; step time and peak memory beside train_dp's;
11. ``dataplane``  the engine's allreduce at one rank over NCCL, on its
   stream, with each entry's wire mode and schedule set past the one-rank
   gate: a gradient set of the 7B DP step's shape (291 bf16 tensors,
   13,477,363,712 bytes) fused as the engine fuses it, through the plain
   path, the bf16 cast, int8, fp8, int8 ``rs_ag:4`` and fp32 and int8
   ``compiled:rs_ag:4`` (one CUDA graph a schedule signature, captured
   during the checks, only replayed in the timed pass): device ms of the
   whole set in each mode (CUDA events), the host ms of issuing it, peak
   memory allocated and reserved, the graphs captured, their capture
   seconds, replays and the bytes of their shared pool.  Every group's
   result within its round-trip bound of the input, int8 ``rs_ag:4``
   bitwise equal to int8 monolithic, int8 ``compiled:rs_ag:4`` to both,
   fp32 ``compiled:rs_ag:4`` to the plain path; three groups bitwise equal
   to the same functions on the CPU over a Gloo group of one; the
   reduce-scatters in the chosen container (fp16), a MAX all_reduce of
   the raw absmax, 1-byte and fp32 gathers;
12. ``hvdrun``  the same data-parallel step as a job of the port's launcher,
   ``python -m horovod_tpu_torch.runner -np 1 -- python chip_smoke.py
   --hvdrun-worker OUT``, with ``HVDTPU_METRICS_PORT`` set, once this
   process has released the card.  The worker checks the launcher's env
   (the job's secret, the controller's and the KV store's addresses),
   loads the kernels this process built (no rebuild), runs ``hvd.init()``
   (NCCL on cuda:0), and holds everything ``train_dp`` holds; then the
   metrics plane: ``/metrics`` byte-identical to ``hvd.metrics
   ("prometheus")``, ``cluster_metrics()``'s ``rank="0"`` series of
   ``hvd_collectives_total`` equal to the registry's, a flight-recorder
   bundle naming rank 0 of 1 (the sampling profiler, which counts its
   ticks into the registry, pauses around the byte comparison).  This
   process requires the launcher's exit
   code 0, the first loss bitwise equal to ``train``'s and the later ones
   within ``DP_LOSS_REL``, and prints the step median beside
   ``train_dp``'s and the launcher's wall seconds;
13. ``hvdrun_obs``  the same job with the rest of the observability plane
   armed: ``python -m horovod_tpu_torch.runner -np 1 --autotune
   --autotune-log D/autotune.log -- python chip_smoke.py --hvdrun-worker
   OUT --obs``, with an SLO on the engine's cycle time, an alert rule that
   fires while collectives run (no hold), a 0.5 s time-series interval and
   a tuner that scores every two busy cycles.  The worker takes train's
   four steps, each inside one span of the port's tracer, and holds every
   ``train_dp`` check; then the plane: tuner trials and every committed
   knob on the tuner's grid; ``hvd_slo_attainment{slo="cycle"}`` equal to
   the good fraction this script computes from the registry's cycle
   histogram; the rule firing on ``/alertz.json`` and its transition in
   the flight bundle; profiler samples and engine phases on ``/profz.json``,
   its peak device memory within 1% of ``torch.cuda.max_memory_allocated``
   and its ring in the bundle; no performance-model observation at one
   rank; the step spans on ``/tracez``'s rank-0 lane.  This process
   requires every loss bitwise equal to ``train``'s and prints the step
   median beside ``train_dp``'s and ``hvdrun``'s;
14. ``elastic``  Llama-2-7B at full width, depth cut to 4 layers (train's
   seed, batch and fused Adam through ``DistributedOptimizer``), as an
   elastic job: ``python -m horovod_tpu_torch.runner -np 1 --min-np 1
   --max-np 1 --host-discovery-script D -- python chip_smoke.py
   --elastic-worker W``, D printing ``localhost:1`` and ``127.0.0.1:1``
   (both run here, on the one card), with ``HVDTPU_FAULTS`` killing the
   worker mid-step 4 and a ``FileBackedState`` committed each step and a
   ``Checkpointer`` of the parameters and Adam's state every second step.
   The job must exit 0 after exactly one relaunch, on 127.0.0.1, with
   localhost blacklisted, resuming at a step > 0, its flight bundle naming
   the injected death, and every loss bitwise equal to an uninterrupted
   run of the same steps in this process.  Then the in-process path: a
   ``dispatch:err`` in step 2 and another in step 3 under
   ``hvd.elastic.run`` (no ``HVDTPU_ELASTIC``): NCCL re-initialized in
   this process each time, ``TorchState`` restored, every loss bitwise
   equal again, the flash launches of every forward and backward run,
   device memory after each reinit within ``ELASTIC_MEM_REL`` of before.  Time to recover, the
   checkpoint's save and restore GB/s, reinit seconds, step ms before and
   after;
15. ``train_parity``  two layers at full width, S=4096: loss and every
   gradient through the kernels against the same call through their plain
   versions (``llama._FORCE_ATTENTION_REFERENCE``);
16. ``train_moe``  Llama-2-7B at full width as a Switch-MoE of 8 SwiGLU
   experts a layer (capacity factor 1.25, top-1), depth cut to 4 layers
   (4,859,269,120 parameters), bf16, per-layer recompute, one sequence
   of 4096 tokens a step, fused Adam at ``MOE_LR``: one warm-up and
   three timed steps.  Every counter zeroed just before and read just
   after: per step
   ``flash_fwd`` 8 times, ``flash_bwd_dq`` and ``flash_bwd_dkv`` 4 times
   each, ``paged_decode`` never; ``hvd_moe_dropped_tokens_total``
   untouched (the model path counts no drops, as in the JAX package);
   the losses finite, the first within 2 of ln V, then below it.  Step
   ms, tokens/s, the model's TFLOP a step by product and the MFU, peak
   memory, each layer's drops and the aux at the first and the last
   weights; a profile
   of one step by product (flash, expert products, dispatch and combine,
   router, projections and lm_head, Adam, the elementwise rest); last,
   layer 0's MoE MLP in fp32 on 4096 tokens on the card (TF32 off)
   against the CPU: every token to the same expert, the same drops,
   outputs within ``MOE_OUT_REL`` of the largest (a token routed
   differently would print its top-2 logit gap);
17. ``hier``  the hierarchy's one-rank gate over NCCL: ``init`` accepts
   ``hierarchical_allreduce``, ``hierarchical_local_size=2`` and an int8
   cross hop; at one rank no split is valid, so no tier group is made, a
   16 MB allreduce and the 7B gradient set (291 tensors, fused as the DP
   step fuses them) come back bitwise whole and no tiered dispatch or
   two-tier route runs; ``build_mesh`` gives a ``DeviceMesh`` on the card
   with every axis of size 1;
18. ``train_mesh``  train's model, seed and batch through the mesh path
   at one rank: ``hvd.init()`` (NCCL on cuda:0), ``build_mesh(MeshConfig())``
   (every axis of size 1, on ``cuda``), ``init_params(..., mesh=)``
   (bitwise equal to the unsharded ``init_params`` at train's seed, leaf
   by leaf), fused Adam at train's lr and ``make_train_step(mesh=)``: one
   warm-up and three timed steps with every ``torch.distributed``
   collective and point-to-point call wrapped and counted (none may run),
   every kernel counter zeroed just before and read just after (train's
   64/32/32 flash launches a step, ``paged_decode`` never), the first
   loss bitwise equal to train's and the later ones within
   ``DP_LOSS_REL`` (whether they are bitwise too is printed); step ms,
   tokens/s, MFU and peak memory beside train's;
19. ``train_pp``  Llama-2-7B at full width as two pipeline stages (layers
   0-15 and 16-31, every other axis 1) trained by the one-process 1F1B
   driver (``llama.make_pipeline_step_local``: every stage in this
   process, the handoffs in memory) over 4 microbatches of one row of
   4096, beside the pp=1 mesh step on the same 4 rows, each from train's
   draw: one warm-up and three timed steps, then a profiled one each
   (``train_breakdown``); every ``torch.distributed`` call wrapped and
   counted (none may run); the launches a step as ``pp_launches``
   reckons them (and 64/32/32 at pp=1); the first loss within
   ``DP_LOSS_REL`` of pp=1's, the later ones too; the first gradients
   within ``PARITY_GRAD_REL_L2`` (relative L2, leaf by leaf); the peak
   under ``TRAIN_PP_PEAK_GB``; step ms, tokens/s, MFU and peak beside
   pp=1's (one card runs the stages in turn: the schedule's work, not a
   pipelining speed-up);
20. ``serve_mesh``  ``serve(mesh=)`` on a one-rank mesh with serve's
   weights, pool and 8 requests (tokens bitwise serve's, ``paged_decode``
   32 times a decode tick, the flash kernels never, TTFT, ITL and
   tokens/s beside serve's and beside the plain ``serve()`` session's
   under the same ``hvd.init()``, timed in turn: plain, mesh, mesh,
   plain) and ``generate(mesh=)`` on 2 prompts of 128 tokens, 16 new
   (bitwise the plain ``generate``'s); every ``torch.distributed`` call
   wrapped and counted (none may run);
21. ``train_resnet``  ResNet-50 (``models/resnet.py``: bf16 convolutions
   in ``channels_last``, flax's fp32 batch norm, fp32 head) on a fixed
   synthetic batch of 128 images of 224x224x3, 1000 classes, under
   ``hvd.init()`` at one rank (NCCL) with ``DistributedOptimizer`` over
   SGD with momentum 0.9: one warm-up and three timed steps, every
   kernel counter zeroed just before and read just after (none of the
   four may launch: the JAX package computes the model outside any
   Pallas kernel); the losses finite and below the first; step ms,
   images/s, MFU (3 x the forward's MACs x 2 a step), peak memory; and
   the logits of 4 images on the card (weights just drawn, every
   block's last norm at scale 0.2 instead of 0 so that every
   convolution counts) within ``RESNET["check_tol"]`` (max abs error
   over the CPU's largest) of the fp32 model's on the CPU with the same
   weights;
22. ``train_bert``  BERT-Large (``models/bert.py``, ``bert_large()``:
   bf16 compute, fp32 parameters, dense attention in plain PyTorch) on a
   fixed MLM batch of 16 x 512 (15% masked), fused Adam through
   ``DistributedOptimizer``, as ``train_resnet``: tokens/s and MFU
   (6 N + 12 L d S flops a token), the logits of 2 sequences of 128
   against the CPU's fp32;
23. ``train_dlrm``  DLRM (``models/dlrm.py``) at the JAX package's
   ``DlrmConfig()``, then at MLPerf's widths (13 dense features, 26
   tables of 500,000 x 128 fp32, 6.66 GB; bottom MLP 512-256-128, top
   1024-1024-512-256-1), batch 32,768: the dense half through
   ``DistributedOptimizer`` over fused Adam, the tables under their own
   fused Adam (a dense gradient: every row updated), the lookup's two
   ``all_to_all_single`` exchanges over a group of their own and counted
   (3 a step, the embeddings' backward the third), as ``train_resnet``:
   samples/s, MFU against the fp32 rate, the tables' Adam ms (CUDA
   events) beside the bound of their traffic, and the logits of 256
   samples against the CPU's with the rows they read (fp32 both);
24. ``train_estimator``  the estimator (``horovod_tpu_torch.estimator``):
   ``TorchEstimator`` fits the MNIST ConvNet at its published widths
   (behind ``nn.Unflatten``, which reads the ``[B, 784]`` feature column
   as NHWC) on 60,000 rows made from ``--seed`` with numpy (labels from
   a seeded linear teacher), global batch 128, Adam 1e-3 through
   ``DistributedOptimizer`` under ``hvd.init()`` at one rank (NCCL), 3
   epochs, a checkpoint an epoch into a ``LocalStore`` in a temporary
   directory; every kernel counter zeroed just before the fit and read
   just after (none may launch); the epoch loss falling, one checkpoint
   an epoch and the last restoring the fitted parameters, 8 allreduce
   entries a step, ``TorchModel.predict`` on 1,024 rows on the card
   within ``ESTIMATOR``'s tolerance of a CPU fp32 copy (saying whether
   cuDNN's TF32 convolutions were on); samples/s and ms an epoch, the
   checkpoint's bytes and save ms, peak memory, and one more short epoch
   under the profiler (device ms a step, idle share).

Then a ``total`` line (the script's wall seconds), a ``kernels`` line
(the kernel phase's numbers, null where it did not run, and each path's
launches),
the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero before the last line; without a
CUDA device, or without the port's package beside the script, it exits
2.  ``--phases`` runs a subset
(``device,build,kernel,serve,frontdoor,replicas,train,train_variants,
train_dp,train_zero,dataplane,hvdrun,hvdrun_obs,elastic,train_parity,
train_moe,hier,train_mesh,train_pp,serve_mesh,train_resnet,train_bert,
train_dlrm,train_estimator``; ``frontdoor``,
``replicas``, ``elastic`` and ``train_moe`` need ``build``;
``train_variants``, ``train_dp``, ``hvdrun_obs`` and ``train_mesh`` need
``train``, ``hvdrun`` and ``train_zero`` need ``train`` and
``train_dp``, ``serve_mesh`` needs ``serve``); ``--root DIR`` drives
the package of another checkout (an unpacked parent commit, say) with
this script's shapes, checks and timers.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM rates (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
PHASES = ("device", "build", "kernel", "serve", "frontdoor", "replicas",
          "train", "train_variants", "train_dp", "train_zero", "dataplane",
          "hvdrun", "hvdrun_obs", "elastic", "train_parity", "train_moe",
          "hier", "train_mesh", "train_pp", "serve_mesh", "train_resnet",
          "train_bert", "train_dlrm", "train_estimator")
KERNEL_LIBS = ("paged_decode", "flash_fwd", "flash_bwd")
SRC = "horovod_tpu_torch/csrc/"
TPU_SRC = "horovod_tpu/ops/flash_attention.py"
# name -> (library, the Pallas kernel it replaces, file:line of its def)
KERNELS = {
    "paged_decode": ("paged_decode", TPU_SRC + ":367"),
    "flash_fwd": ("flash_fwd", TPU_SRC + ":85"),
    "flash_bwd_dq": ("flash_bwd", TPU_SRC + ":185"),
    "flash_bwd_dkv": ("flash_bwd", TPU_SRC + ":224"),
}


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
    overwritten before each launch so every call finds it cold.  A spin of
    the device (``torch.cuda._sleep``, about 0.25 ms) precedes the start
    event, so the host's work to launch ``fn`` overlaps it and the events
    time the device's work alone, not a gap waiting for the launch; the
    host's share is :func:`host_us`."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(500_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds of one ``fn()``, the best of five runs of
    ``calls``, with the device kept busy so that launches only enqueue."""
    best = math.inf
    for _ in range(5):
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def _counters():
    from horovod_tpu_torch.ops import flash_attention as FA
    return {"paged_decode": FA.paged_attention,
            "flash_fwd": FA.flash_forward,
            "flash_bwd_dq": FA.flash_backward_dq,
            "flash_bwd_dkv": FA.flash_backward_dkv}


def zero_launches() -> None:
    """Set every kernel's launch counter to 0."""
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


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
                       n_cols, dtype=None, timed=True, host=False):
    """Kernel vs plain version at one shape: every output row within
    ``ROW_REL_TOL`` of its own largest value; then, if ``timed``, the
    kernel, the plain version and the library yardstick timed, and if
    ``host``, the host time of one wrapper call."""
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
        "lengths": list(lengths), "dtype": dname,
        # (a tree from before the split over table columns has none)
        "n_splits": FA.paged_splits(
            B, KV, n_cols, torch.cuda.get_device_properties(0)
            .multi_processor_count) if hasattr(FA, "paged_splits") else 1,
        "max_abs_err": err,
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
    if host:
        res["host_us_per_call"] = host_us(
            torch, lambda: FA.paged_attention(q, kp, vp, tables, lens))

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


# ---------------------------------------------------------------------------
# flash_fwd, flash_bwd_dq and flash_bwd_dkv against their plain versions
# ---------------------------------------------------------------------------

# Per-row tolerance of a flash kernel against its plain version (fp32,
# TF32 off), as a share of the row's largest |value| (one position, one
# head), 2^-5 in bf16 as for paged_decode: the kernels round p (and ds) to
# bf16 before each product, as the Pallas kernels do, the plain versions
# keep fp32, and both round the output to bf16; together a few ulps
# (2^-8 each) of the row's largest value.  A K/V block skipped, misrouted
# or masked wrongly moves some row by order its own size.  The share is
# taken of max(row's largest value, FLOOR_SHARE x the median row's): in the
# first causal rows dq nearly cancels (p = 1 on one key, so dO.V^T ~
# delta), the plain version's dq there is ~0 and any rounding is "large"
# against it, while it is ~1e-7 of a typical row.
FLASH_ROW_TOL = 2.0 ** -5
FLOOR_SHARE = 2.0 ** -3
# LSE, absolute: both sum fp32 exponentials of the same fp32-accumulated
# scores in another order (and exp2 against exp): ~1e-6 at values near
# log(S) ~ 8.  A 64-key block dropped from a 4096-key row moves it by
# about log(1 - 64/4096) = -0.016.
LSE_ABS_TOL = 1e-3


def _row_check(torch, name, label, got, ref) -> dict:
    diff = (got.float() - ref.float()).abs()
    row_err = diff.amax(dim=-1)
    row_mag = ref.float().abs().amax(dim=-1)
    floor = FLOOR_SHARE * row_mag.median()
    ratio = (row_err / torch.maximum(row_mag, floor).clamp_min(1e-30)
             ).max().item()
    err = diff.max().item()
    if not (math.isfinite(err) and ratio <= FLASH_ROW_TOL):
        raise AssertionError(
            f"{name} {label}: worst row |kernel - plain| is {ratio} of the "
            f"row's scale (limit {FLASH_ROW_TOL}); max abs {err}")
    return {"max_abs_err": err, "worst_row_rel_err": ratio}


def flash_case(torch, gen, B, S, H, KV, D):
    def rnd(heads):
        return torch.randn(B, S, heads, D, generator=gen,
                           device="cuda").to(torch.bfloat16)
    return rnd(H), rnd(KV), rnd(KV), rnd(H)


def flash_bytes(q, k, outs, extra_f32=0) -> int:
    """Each input read once and each output written once."""
    return sum(t.numel() * t.element_size() for t in (q, k, k) + outs) \
        + extra_f32 * 4


def bound(nbytes: int, flops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def check_flash(torch, gen, *, label, B, S, H, KV, D, causal) -> dict:
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv against their plain
    versions at one shape (the backward on the kernel forward's o and lse),
    then each timed beside its bound and the library yardstick: SDPA for
    the forward, one autograd.grad through SDPA's output (dq, dk and dv
    together) for the backward pair.  The port never calls SDPA.  A second
    launch of each backward kernel must give bitwise the same dq, dk and
    dv."""
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as FA

    q, k, v, do = flash_case(torch, gen, B, S, H, KV, D)
    sc = 1.0 / math.sqrt(D)
    shape = {"shape": label, "B": B, "S": S, "H": H, "KV": KV, "D": D,
             "causal": causal, "dtype": "bfloat16"}
    o, lse = FA.flash_forward(q, k, v, sc, causal)
    ro, rlse = FA.flash_forward_reference(q, k, v, sc, causal)
    delta = FA.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, sc, causal)
    dq = FA.flash_backward_dq(*args)
    dk, dv = FA.flash_backward_dkv(*args)
    rdq = FA.flash_backward_dq_reference(*args)
    rdk, rdv = FA.flash_backward_dkv_reference(*args)
    torch.cuda.synchronize()
    res = {"flash_fwd": _row_check(torch, "flash_fwd", label, o, ro),
           "flash_bwd_dq": _row_check(torch, "flash_bwd_dq", label, dq, rdq)}
    dk_c = _row_check(torch, "flash_bwd_dkv", label, dk, rdk)
    dv_c = _row_check(torch, "flash_bwd_dkv", label, dv, rdv)
    res["flash_bwd_dkv"] = {
        "max_abs_err": max(dk_c["max_abs_err"], dv_c["max_abs_err"]),
        "worst_row_rel_err": max(dk_c["worst_row_rel_err"],
                                 dv_c["worst_row_rel_err"])}
    lse_err = (lse - rlse).abs().max().item()
    if not (math.isfinite(lse_err) and lse_err <= LSE_ABS_TOL):
        raise AssertionError(f"flash_fwd {label}: lse off by {lse_err} "
                             f"(limit {LSE_ABS_TOL})")
    res["flash_fwd"]["lse_max_abs_err"] = lse_err
    del ro, rlse, rdq, rdk, rdv
    dq2 = FA.flash_backward_dq(*args)
    dk2, dv2 = FA.flash_backward_dkv(*args)
    torch.cuda.synchronize()
    for name, a, b in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            raise AssertionError(f"{label}: two launches gave different "
                                 f"{name} bits")
    res["flash_bwd_dq"]["bitwise_repeatable"] = True
    res["flash_bwd_dkv"]["bitwise_repeatable"] = True
    del dq2, dk2, dv2

    # Library yardsticks on [B, H, S, D] copies made outside the timed
    # calls (K/V repeated to H heads for GQA).
    qt, dot = (t.transpose(1, 2).contiguous() for t in (q, do))
    kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
              .contiguous() for t in (k, v))
    qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    lib_fwd = time_cold(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    lib_bwd = time_cold(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    del lib_out, qt, kt, vt, dot

    flops = {n: FA.flash_flops((B, S, H, D), causal, p)
             for n, p in (("flash_fwd", 2), ("flash_bwd_dq", 3),
                          ("flash_bwd_dkv", 4))}
    rows = B * H * S
    nbytes = {"flash_fwd": flash_bytes(q, k, (o,), rows),
              "flash_bwd_dq": flash_bytes(q, k, (do, dq), 2 * rows),
              "flash_bwd_dkv": flash_bytes(q, k, (do, dk, dv), 2 * rows)}
    timed = {
        "flash_fwd": (lambda: FA.flash_forward(q, k, v, sc, causal),
                      lambda: FA.flash_forward_reference(q, k, v, sc,
                                                         causal), lib_fwd),
        "flash_bwd_dq": (lambda: FA.flash_backward_dq(*args),
                         lambda: FA.flash_backward_dq_reference(*args),
                         lib_bwd),
        "flash_bwd_dkv": (lambda: FA.flash_backward_dkv(*args),
                          lambda: FA.flash_backward_dkv_reference(*args),
                          lib_bwd),
    }
    for name, (fn, plain, lib_ms) in timed.items():
        r = res[name]
        r.update(shape)
        r.update({"ms": time_cold(torch, fn),
                  "plain_ms": time_cold(torch, plain, iters=10),
                  "library_ms": lib_ms,
                  "library": "SDPA forward" if name == "flash_fwd" else
                  "SDPA backward (dq, dk, dv in one autograd.grad)"})
        r.update(bound(nbytes[name], flops[name]))
        r["row_rel_tol"] = FLASH_ROW_TOL
        emit({"phase": "kernel", "name": name, **r})
    return res


def phase_kernel(torch) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    flash7b = check_flash(torch, gen, label="llama2_7b_train", B=1, S=4096,
                          H=32, KV=32, D=128, causal=True)
    check_flash(torch, gen, label="gqa_rep4", B=2, S=2048, H=32, KV=8,
                D=128, causal=True)
    check_flash(torch, gen, label="full_d64", B=2, S=1024, H=16, KV=16,
                D=64, causal=False)
    # S a multiple of 64 but not of 128: a half-full last query and key
    # tile, and GQA's kv heads as a coordinate of the tensor maps.
    check_flash(torch, gen, label="ragged_gqa", B=1, S=4160, H=32, KV=8,
                D=128, causal=True)
    # The same without the causal mask: nothing but S masks the half-full
    # last 128-key CTA of flash_bwd_dkv and 128-row CTA of flash_bwd_dq.
    check_flash(torch, gen, label="ragged_full", B=1, S=1088, H=16, KV=4,
                D=64, causal=False)
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
                       n_cols=64, host=True)
    # One long request, where the split over table columns matters most.
    check_paged_decode(torch, gen, label="long_gqa", B=1, H=32, KV=8,
                       Dh=128, BS=16, lengths=[4096], n_cols=256)
    # A batch whose B * KV already fills the card: one split, the output
    # written by the main kernel itself, no merge.
    check_paged_decode(torch, gen, label="wide_batch", B=20, H=32, KV=32,
                       Dh=128, BS=16, lengths=[1, 16, 17, 64, 100, 200, 255,
                                               256, 300, 400, 480, 512] + [
                                                   33 * i + 1 for i in range(8)],
                       n_cols=32, timed=False)
    # One split of more than 4096 table columns: too many to keep in
    # shared memory, so every row reads its table from device memory, the
    # short rows as well as the one past 4096 live columns.
    check_paged_decode(torch, gen, label="long_table", B=17, H=32, KV=32,
                       Dh=64, BS=8, lengths=[1, 9, 200, 777, 2048, 4096,
                                             32800] + [100 * i + 3
                                                       for i in range(10)],
                       n_cols=4104, timed=False)
    # fp32 at LlamaConfig.tiny()'s shape (H4 KV2 Dh16, 8-token pages), as
    # the CPU parity tests serve it.
    check_paged_decode(torch, gen, label="tiny_fp32", B=3, H=4, KV=2,
                       Dh=16, BS=8, lengths=[5, 17, 30], n_cols=6,
                       dtype=torch.float32, timed=False)
    return {"paged_decode": res7b, **flash7b}


# ---------------------------------------------------------------------------
# serve() on full-width Llama-2-7B
# ---------------------------------------------------------------------------

def phase_serve(torch, smi: str) -> dict:
    import numpy as np

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import llama

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
    results, counts, ticks, timing = _serve_timed(torch, sess, prompts, 32)
    launches = counts["paged_decode"]
    for r in results:
        if len(r.tokens) != 32 or not all(0 <= t < cfg.vocab_size
                                          for t in r.tokens):
            raise AssertionError(f"request {r.req_id}: bad tokens {r.tokens}")
    if launches == 0 or launches != ticks * cfg.n_layers:
        raise AssertionError(
            f"paged_decode launched {launches} times over {ticks} decode "
            f"ticks; want {cfg.n_layers} per tick")
    if any(counts[n] for n in counts if n != "paged_decode"):
        raise AssertionError(f"serving launched a training kernel: {counts}")
    res = {
        "phase": "serve", "model": "llama2_7b", "dtype": "bfloat16",
        "requests": len(results), "prompt_lens": lens, "max_tokens": 32,
        "decode_ticks": ticks, "paged_decode_launches": launches,
        "init_s": init_s, **timing,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": smi,
    }
    emit(res)
    logits_parity(torch, params, cfg, eng)
    decode_breakdown(torch, eng, smi)
    sess.close()
    return {"counts": counts, "metrics": res, "prompts": prompts,
            "tokens": [list(r.tokens) for r in results]}


def _serve_timed(torch, sess, prompts, max_tokens: int) -> tuple:
    """Submit ``prompts`` to ``sess`` and drain it, every launch counter
    zeroed just before and read just after: (results, launch counts,
    decode ticks, wall and latency numbers)."""
    eng = sess.engine
    emit_t: dict[int, list[float]] = {}

    def on_token(req_id, tok):
        emit_t.setdefault(req_id, []).append(time.perf_counter())

    zero_launches()                            # every counter of the path
    ticks0 = eng.decode_ticks
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    futs = [sess.submit(p, max_tokens, stream_cb=on_token) for p in prompts]
    sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = read_launches()
    ticks = eng.decode_ticks - ticks0
    results = [f.result() for f in futs]
    ttft = sorted(r.metrics["ttft_s"] for r in results)
    itl = sorted(b - a for ts in emit_t.values()
                 for a, b in zip(ts, ts[1:]))
    decode_tokens = sum(len(r.tokens) - 1 for r in results)
    first = min(min(ts) for ts in emit_t.values())
    last = max(max(ts) for ts in emit_t.values())
    return results, counts, ticks, {
        "wall_s": wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "itl_p50_s": itl[len(itl) // 2],
        "itl_p99_s": itl[min(len(itl) - 1, int(0.99 * len(itl)))],
        "decode_tokens_per_s": decode_tokens / (last - first)}


def device_kernels(prof) -> list:
    """The profiler's device-side kernel entries, without the device spans
    of user annotations (``Optimizer.step#Adam.step``), which cover kernels
    already counted: such a span carries the name of a CPU-side op, a
    kernel never does."""
    events = prof.key_averages()
    cpu_ops = {e.key for e in events if e.device_type.name == "CPU"}
    return [e for e in events
            if e.device_type.name == "CUDA" and e.self_device_time_total
            and e.key not in cpu_ops]


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
    kernels = device_kernels(prof)
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
# the front door on full-width Llama-2-7B: generate, the prefix cache,
# speculative decoding, each emitted token teacher-forced, fp32 exactness
# ---------------------------------------------------------------------------

FD_NEW = 32                 # new tokens a request in every part
FD_HEAD = 512               # the prefix-cache part's shared head
FD_TAILS = [16, 32, 48, 64, 80, 96, 112]
FD_SPEC_K = 4
# The teacher-forced check's δ, as a share of the largest |logit| of the
# row: logits_parity's 32-layer bound between two attention paths of this
# bf16 model (kernel vs gather).  An emitted token that is not the argmax
# of the full forward must lie within δ of the top logit; a stale K/V
# entry or a wrong rollback puts it at random, far below the top.
FD_DELTA_REL = 0.10
# The weak draft: Llama-shaped, vocab 32000, weights from seed 1.
FD_WEAK = dict(vocab_size=32000, d_model=1024, n_layers=4, n_heads=16,
               n_kv_heads=16, d_ff=2816)


def _serve_prompts(cfg):
    """The serve phase's 8 prompts (its warm-up draws first)."""
    import numpy as np
    rng = np.random.RandomState(0)
    rng.randint(0, cfg.vocab_size, size=(16,))
    return [rng.randint(0, cfg.vocab_size, size=(n,))
            for n in (64, 128, 192, 256, 320, 384, 448, 512)]


def _check_launches(part: str, counts: dict, want: dict) -> None:
    if counts != want:
        raise AssertionError(f"frontdoor {part}: launches {counts}, want "
                             f"{want}")


def _run_requests(sess, prompts, max_tokens=FD_NEW, wave=False):
    """Submit ``prompts`` (the first alone first when ``wave``), drain,
    return the results; host seconds of the run."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [sess.submit(prompts[0], max_tokens)]
    if wave:
        sess.drain()
    futs += [sess.submit(p, max_tokens) for p in prompts[1:]]
    sess.drain()
    torch.cuda.synchronize()
    return [f.result() for f in futs], time.perf_counter() - t0


def _counter_deltas(before: dict) -> dict:
    from horovod_tpu_torch.obs import REGISTRY
    return {n: REGISTRY.get(n).total() - v for n, v in before.items()}


def _counters_now(names) -> dict:
    from horovod_tpu_torch.obs import REGISTRY
    return {n: REGISTRY.get(n).total() for n in names}


def teacher_forced(torch, params, cfg, seqs: list) -> dict:
    """One ``forward`` over each prompt + emitted tokens (the flash kernels;
    each sequence right-padded with token 0 to a multiple of 64, which
    causality leaves inert): for every emitted token, whether it is the
    argmax at its position and its gap below the top logit against
    δ = ``FD_DELTA_REL`` x the row's largest |logit|."""
    import dataclasses

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as FA

    cfg_f = dataclasses.replace(cfg, remat=False)
    S = max(len(p) + len(t) for p, t in seqs)
    S = -(-S // FA.FLASH_BLOCK) * FA.FLASH_BLOCK
    tokens = torch.zeros(len(seqs), S, dtype=torch.int64, device="cuda")
    for b, (p, t) in enumerate(seqs):
        full = list(p) + list(t)
        tokens[b, :len(full)] = torch.tensor(full)
    zero_launches()
    with torch.no_grad():
        logits, _ = llama.forward(params, tokens, cfg_f)
    counts = read_launches()
    _check_launches("teacher-forced forward", counts, {
        "paged_decode": 0, "flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0})
    n = exact = 0
    worst = 0.0
    for b, (p, t) in enumerate(seqs):
        rows = logits[b, len(p) - 1:len(p) - 1 + len(t)]
        want = torch.tensor(list(t), device="cuda")
        top = rows.max(dim=-1).values
        got = rows.gather(1, want[:, None])[:, 0]
        delta = FD_DELTA_REL * rows.abs().max(dim=-1).values
        gap = top - got
        n += len(t)
        exact += int((rows.argmax(-1) == want).sum().item())
        if bool((gap > delta).any()):
            i = int((gap > delta).nonzero()[0, 0])
            raise AssertionError(
                f"sequence {b}: emitted token {i} ({t[i]}) lies "
                f"{gap[i].item()} below the top logit, beyond δ "
                f"{delta[i].item()}")
        worst = max(worst, (gap / delta).max().item())
    return {"tokens": n, "exact_argmax_share": exact / n,
            "worst_gap_over_delta": worst}


def phase_frontdoor(torch, smi: str) -> None:
    import dataclasses

    import numpy as np

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import llama

    _free_cuda(torch)
    cfg = llama.LlamaConfig.llama2_7b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)                          # the serve phase's weights
    params = llama.init_params(cfg, gen, "cuda")
    knobs = dict(num_blocks=512, block_size=16, max_active=8)
    L = cfg.n_layers

    # Plain sessions of every part's prompts: the tokens generate is held
    # against and the teacher-forced share beside each part's.
    rng = np.random.RandomState(1)
    gen_prompts = [rng.randint(0, cfg.vocab_size, size=(128,))
                   for _ in range(4)]
    head = rng.randint(0, cfg.vocab_size, size=(FD_HEAD,))
    fd_prompts = [head] + [np.concatenate(
        [head, rng.randint(0, cfg.vocab_size, size=(n,))])
        for n in FD_TAILS]
    spec_prompts = _serve_prompts(cfg)
    plain = serving.serve(params, cfg, **knobs)
    _run_requests(plain, [rng.randint(0, cfg.vocab_size, size=(16,))], 2)
    ticks0 = plain.engine.decode_ticks
    zero_launches()
    plain_res = {}
    for part, prompts in (("generate", gen_prompts),
                          ("prefix_cache", fd_prompts),
                          ("spec", spec_prompts)):
        plain_res[part], _ = _run_requests(plain, prompts)
    _check_launches("plain sessions", read_launches(), {
        "paged_decode": L * (plain.engine.decode_ticks - ticks0),
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    plain.close()
    del plain
    seqs = {}                 # part -> [(prompt, emitted tokens)]

    # 1. generate: B=4 prompts of 128 tokens, 32 new tokens, greedy.
    prompt = torch.tensor(np.stack(gen_prompts), device="cuda")
    llama.generate(params, prompt[:, :16], cfg, max_new_tokens=2)  # warm
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = llama.generate(params, prompt, cfg, max_new_tokens=FD_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_launches("generate", read_launches(), {
        "paged_decode": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0})
    new = out[:, 128:].cpu().numpy()
    if out.shape != (4, 128 + FD_NEW) or not (
            (new >= 0) & (new < cfg.vocab_size)).all():
        raise AssertionError(f"generate returned {tuple(out.shape)}")
    seqs["generate"] = [(p, [int(x) for x in row])
                        for p, row in zip(gen_prompts, new)]
    same = sum(int(a == b) for (_, t), r in zip(seqs["generate"],
                                                plain_res["generate"])
               for a, b in zip(t, r.tokens))
    emit({"phase": "frontdoor", "part": "generate", "batch": 4,
          "prompt_len": 128, "new_tokens": FD_NEW, "wall_s": wall,
          "tokens_per_s": 4 * FD_NEW / wall,
          "tokens_equal_to_serve": same, "tokens": 4 * FD_NEW,
          "launches": read_launches(), "card": smi})

    # 2. the prefix cache: a cold 512-token head, then 7 head + tail.
    names = ("hvd_prefix_cache_hits_total",
             "hvd_prefix_cache_blocks_shared_total",
             "hvd_serving_prefill_skipped_tokens_total",
             "hvd_serving_prefill_tokens_total")
    sess = serving.serve(params, cfg, prefix_cache=True, **knobs)
    _run_requests(sess, [rng.randint(0, cfg.vocab_size, size=(16,))], 2)
    eng = sess.engine
    before = _counters_now(names)
    ticks0 = eng.decode_ticks
    zero_launches()
    res, wall = _run_requests(sess, fd_prompts, wave=True)
    counts = read_launches()
    ticks = eng.decode_ticks - ticks0
    moved = _counter_deltas(before)
    _check_launches("prefix cache", counts, {
        "paged_decode": L * ticks, "flash_fwd": 0, "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0})
    cached = [r.metrics["cached_tokens"] for r in res]
    n_hits = len(FD_TAILS)
    want = {"hvd_prefix_cache_hits_total": n_hits,
            "hvd_prefix_cache_blocks_shared_total": n_hits * FD_HEAD // 16,
            "hvd_serving_prefill_skipped_tokens_total": n_hits * FD_HEAD,
            "hvd_serving_prefill_tokens_total": FD_HEAD + sum(FD_TAILS)}
    if cached != [0] + [FD_HEAD] * n_hits or moved != want:
        raise AssertionError(f"prefix cache: cached_tokens {cached}, "
                             f"counters {moved}, want {want}")
    eng.pager.check_invariants()
    seqs["prefix_cache"] = [(p, r.tokens) for p, r in zip(fd_prompts, res)]
    ttft = [r.metrics["ttft_s"] for r in res]
    # TTFT alone, with every shape already met: the head with new tails
    # of the same lengths (hits on the head only), one at a time, and a
    # new prompt of 512 + 64 tokens (a miss), each to its first token.
    alone = [_run_requests(sess, [p], 1)[0][0].metrics for p in [
        np.concatenate([head, rng.randint(0, cfg.vocab_size, size=(n,))])
        for n in FD_TAILS] + [rng.randint(0, cfg.vocab_size, size=(576,))]]
    if [m["cached_tokens"] for m in alone] != [FD_HEAD] * n_hits + [0]:
        raise AssertionError(f"prefix cache, requests alone: "
                             f"{[m['cached_tokens'] for m in alone]}")
    eng.pager.check_invariants()
    emit({"phase": "frontdoor", "part": "prefix_cache", "head": FD_HEAD,
          "tails": FD_TAILS, "cached_tokens": cached, "counters": moved,
          "decode_ticks": ticks, "launches": counts, "wall_s": wall,
          "ttft_cold_s": ttft[0], "ttft_hits_s": ttft[1:],
          "ttft_hits_median_s": sorted(ttft[1:])[n_hits // 2],
          "alone_ttft_hits_s": [m["ttft_s"] for m in alone[:-1]],
          "alone_ttft_cold_576_s": alone[-1]["ttft_s"],
          "card": smi})
    sess.close()
    del sess, eng

    # 3. speculative decoding, k = 4, the target as its own draft and a
    #    weak draft.
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(1)
    weak_cfg = llama.LlamaConfig(**FD_WEAK)
    weak = llama.init_params(weak_cfg, gen_w, "cuda")
    for part, draft, dcfg in (("spec_self", params, cfg),
                              ("spec_weak", weak, weak_cfg)):
        sess = serving.serve(params, cfg, spec_k=FD_SPEC_K,
                             draft_params=draft, draft_cfg=dcfg, **knobs)
        _run_requests(sess, [rng.randint(0, cfg.vocab_size, size=(16,))], 2)
        eng, spec = sess.engine, sess.engine.spec
        per_round = []
        tick = spec.tick

        def counted_tick(tick=tick, eng=eng, per_round=per_round):
            active = {r.req_id for r in eng._slots if r is not None}
            out = tick()
            n = {}
            for r, _ in out:
                n[r.req_id] = n.get(r.req_id, 0) + 1
            per_round.append((active, n))
            return out

        spec.tick = counted_tick
        d0, a0, r0 = spec._drafted_total, spec._accepted_total, spec.rounds
        zero_launches()
        res, wall = _run_requests(sess, spec_prompts)
        counts = read_launches()
        _check_launches(part, counts, {
            "paged_decode": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0})
        for active, n in per_round:
            if set(n) != active or not all(
                    1 <= c <= FD_SPEC_K + 1 for c in n.values()):
                raise AssertionError(f"{part}: a round emitted {n} for the "
                                     f"active requests {sorted(active)}")
        if any(len(r.tokens) != FD_NEW for r in res):
            raise AssertionError(f"{part}: token counts "
                                 f"{[len(r.tokens) for r in res]}")
        eng.pager.check_invariants()
        drafted = spec._drafted_total - d0
        accepted = spec._accepted_total - a0
        seqs[part] = [(p, r.tokens) for p, r in zip(spec_prompts, res)]
        emit({"phase": "frontdoor", "part": part, "k": FD_SPEC_K,
              "draft": ("target" if draft is params else FD_WEAK),
              "rounds": spec.rounds - r0, "drafted": drafted,
              "accepted": accepted, "acceptance_rate": accepted / drafted,
              "wall_s": wall,
              "tokens_per_s": sum(len(r.tokens) for r in res) / wall,
              "launches": counts, "card": smi})
        sess.close()
        del sess, eng, spec
    del weak

    # 4. every emitted token teacher-forced through one forward.
    shares = {}
    for part, base in (("generate", "generate"),
                       ("prefix_cache", "prefix_cache"),
                       ("spec_self", "spec"), ("spec_weak", "spec")):
        got = teacher_forced(torch, params, cfg, seqs[part])
        ref = teacher_forced(torch, params, cfg, [
            (p, r.tokens) for (p, _), r in zip(seqs[part],
                                               plain_res[base])])
        shares[part] = {"exact_argmax_share": got["exact_argmax_share"],
                        "plain_serve_exact_argmax_share":
                            ref["exact_argmax_share"],
                        "worst_gap_over_delta": got["worst_gap_over_delta"],
                        "tokens": got["tokens"]}
    emit({"phase": "frontdoor", "part": "teacher_forced",
          "delta_rel": FD_DELTA_REL, "parts": shares, "card": smi})
    del params
    _free_cuda(torch)

    # 5. exactness in fp32, TF32 off, 2 layers at full width.
    frontdoor_fp32(torch, smi)


def _first_divergence(torch, params, cfg, prompt, a, b) -> dict:
    """The first position where two token lists part, and the top-2 gap
    of the logits there (a plain prefill over prompt + the common part)."""
    from horovod_tpu_torch.models import llama
    i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
    seq = torch.tensor([list(prompt) + list(a[:i])], device="cuda")
    logits, _, _ = llama.prefill_step(params, seq, cfg)
    top2 = logits[0].topk(2).values
    return {"position": i, "tokens": [a[i], b[i]],
            "top2_gap": (top2[0] - top2[1]).item()}


def frontdoor_fp32(torch, smi: str) -> None:
    """generate, serve() through the paged kernel, a prefix-hit serve()
    and serve(spec_k=2) with the target as its own draft, all in fp32 with
    TF32 off: the same tokens, token for token, and acceptance 1.0 (the
    reference's contract of tests/test_frontdoor.py:198-252)."""
    import dataclasses

    import numpy as np

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import llama

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(),
                                  n_layers=2, dtype=torch.float32)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        params = llama.init_params(cfg, gen, "cuda")
        rng = np.random.RandomState(2)
        head = rng.randint(0, cfg.vocab_size, size=(256,))
        prompts = [head] + [np.concatenate(
            [head, rng.randint(0, cfg.vocab_size, size=(n,))])
            for n in (5, 40, 77)]
        new = 16
        want = [llama.generate(params, torch.tensor(p[None], device="cuda"),
                               cfg, max_new_tokens=new)[0, len(p):].tolist()
                for p in prompts]
        knobs = dict(num_blocks=128, block_size=16, max_active=4)
        runs = {}
        for name, kw in (("serve_kernel", dict(use_flash="auto")),
                         ("serve_prefix_hit", dict(prefix_cache=True)),
                         ("serve_spec_k2", dict(spec_k=2,
                                                draft_params=params,
                                                draft_cfg=cfg))):
            sess = serving.serve(params, cfg, **knobs, **kw)
            zero_launches()
            ticks0 = sess.engine.decode_ticks
            res, _ = _run_requests(sess, prompts, new, wave=True)
            counts = read_launches()
            _check_launches(f"fp32 {name}", counts, {
                "paged_decode": cfg.n_layers * (sess.engine.decode_ticks
                                                - ticks0),
                "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
            spec = sess.engine.spec
            runs[name] = {
                "tokens_equal": [r.tokens == w for r, w in zip(res, want)],
                "cached_tokens": [r.metrics["cached_tokens"] for r in res],
                "paged_decode_launches": counts["paged_decode"]}
            if spec is not None:
                runs[name]["acceptance"] = (spec._accepted_total
                                            / spec._drafted_total)
            sess.engine.pager.check_invariants()
            sess.close()
            for p, r, w in zip(prompts, res, want):
                if r.tokens != w:
                    emit({"phase": "frontdoor", "part": "fp32_exactness",
                          "failed": name, "divergence": _first_divergence(
                              torch, params, cfg, p, r.tokens, w)})
                    raise AssertionError(f"fp32 {name}: tokens differ from "
                                         f"generate's")
        if runs["serve_spec_k2"]["acceptance"] != 1.0 or runs[
                "serve_prefix_hit"]["cached_tokens"] != [0, 256, 256, 256]:
            raise AssertionError(f"fp32 runs: {runs}")
        emit({"phase": "frontdoor", "part": "fp32_exactness", "layers": 2,
              "d_model": cfg.d_model, "vocab": cfg.vocab_size,
              "dtype": "float32", "tf32": False, "new_tokens": new,
              "prompt_lens": [len(p) for p in prompts], "runs": runs,
              "card": smi})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    del params
    _free_cuda(torch)


# ---------------------------------------------------------------------------
# multi-replica serving on full-width Llama-2-7B: the router with a replica
# killed, disaggregated prefill/decode over the native KV store with a
# decode replica killed, fp32 exactness of both
# ---------------------------------------------------------------------------

RP_KNOBS = dict(num_blocks=512, block_size=16, max_active=8,
                prefix_cache=True)
RP_FP32_NEW = 16            # new tokens a request in the fp32 part


def _quantiles(xs: list) -> dict:
    xs = sorted(xs)
    if not xs:
        return {"p50": None, "p99": None}
    return {"p50": xs[len(xs) // 2],
            "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))]}


class _ClientClock:
    """What a client of a router sees: each flight's submit time and the
    time of every token streamed to it (the tokens a failed-over flight
    replays included, as the router relays them)."""

    def __init__(self):
        self.t_submit: dict = {}
        self.t_emit: dict = {}

    def submit(self, router, prompt, max_tokens):
        t = time.perf_counter()
        fut = router.submit(prompt, max_tokens, stream_cb=self.on_token)
        self.t_submit[len(self.t_submit)] = t
        return fut

    def on_token(self, fid, tok):
        self.t_emit.setdefault(fid, []).append(time.perf_counter())

    def latency(self, moved=()) -> dict:
        """TTFT and ITL quantiles over every flight, and ITL over the
        flights that never failed over (``moved`` are the others)."""
        ttft = [ts[0] - self.t_submit[f] for f, ts in self.t_emit.items()]
        gaps = {f: [b - a for a, b in zip(ts, ts[1:])]
                for f, ts in self.t_emit.items()}
        return {"ttft_s": _quantiles(ttft),
                "itl_s": _quantiles([g for gs in gaps.values()
                                     for g in gs]),
                "itl_s_not_failed_over": _quantiles(
                    [g for f, gs in gaps.items() if f not in moved
                     for g in gs])}


def _count_decode_launches(eng, per_engine: dict, name: str) -> None:
    """Attribute ``paged_decode`` launches to the engine whose decode tick
    made them."""
    from horovod_tpu_torch.ops import flash_attention as FA
    real = eng._decode
    per_engine[name] = {"launches": 0, "ticks": 0}

    def counted(tok, pos, tables):
        n0 = FA.paged_attention.launches
        out = real(tok, pos, tables)
        per_engine[name]["launches"] += FA.paged_attention.launches - n0
        per_engine[name]["ticks"] += 1
        return out

    eng._decode = counted


def _pump_until(router, cond, what: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"replicas: {what} never happened")
        router.pump()


def _kill_busiest(router, replicas) -> tuple:
    """Kill the replica holding the most of the router's flights."""
    held: dict = {}
    for fl in router._flights.values():
        rid = fl.replica.replica_id
        held[rid] = held.get(rid, 0) + 1
    victim = max(held, key=lambda r: (held[r], r))
    next(r for r in replicas if r.replica_id == victim).kill()
    return victim, held


def _serve_latency(served) -> dict:
    if served is None:
        return None
    m = served["metrics"]
    return {k: m[k] for k in ("ttft_p50_s", "ttft_max_s", "itl_p50_s",
                              "itl_p99_s")}


def _router_run(torch, router, replicas, prompts, max_tokens):
    """Submit ``prompts``, kill the busiest replica once every request has
    streamed a token, drain; (results, victim, flights held, client
    clock, wall seconds)."""
    clock = _ClientClock()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [clock.submit(router, p, max_tokens) for p in prompts]
    _pump_until(router, lambda: len(clock.t_emit) == len(prompts),
                "a first token of every request")
    victim, held = _kill_busiest(router, replicas)
    router.drain(timeout_s=300)
    torch.cuda.synchronize()
    return ([f.result() for f in futs], victim, held, clock,
            time.perf_counter() - t0)


def replicas_router(torch, smi, params, cfg, prompts, served) -> list:
    """Two replicas behind the router with its default config; the one
    holding the most flights is killed once every request streamed a
    token."""
    import numpy as np

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.serving.frontdoor import LocalReplica, Router

    sessions = [serving.serve(params, cfg, **RP_KNOBS) for _ in range(2)]
    warm = np.random.RandomState(3).randint(0, cfg.vocab_size, size=(16,))
    for s in sessions:
        _run_requests(s, [warm], 2)
    reps = [LocalReplica(str(i), s) for i, s in enumerate(sessions)]
    per_engine: dict = {}
    drive_s = [0.0]
    for rep in reps:
        _count_decode_launches(rep.session.engine, per_engine,
                               rep.replica_id)

        def drive(real=rep.drive):
            t = time.perf_counter()
            real()
            drive_s[0] += time.perf_counter() - t

        rep.drive = drive
    router = Router(reps)
    pumps: list = []               # (host s of the pump, of its steps)

    def pump(real=router.pump):
        d0, t = drive_s[0], time.perf_counter()
        real()
        pumps.append((time.perf_counter() - t, drive_s[0] - d0))

    router.pump = pump
    placed = []
    real_place = router._place

    def place(fl, sigs):
        real_place(fl, sigs)
        placed.append(fl.replica.replica_id)

    router._place = place
    before = _counters_now(("hvd_router_failovers_total",))
    zero_launches()
    results, victim, held, clock, wall = _router_run(
        torch, router, reps, prompts, FD_NEW)
    counts = read_launches()
    failovers = _counter_deltas(before)["hvd_router_failovers_total"]
    if set(placed[:len(prompts)]) != {"0", "1"}:
        raise AssertionError(f"router: first placements {placed}")
    if failovers < held[victim]:
        raise AssertionError(f"router: {failovers} failovers, the killed "
                             f"replica held {held[victim]} flights")
    if any(len(r.tokens) != FD_NEW or r.metrics["finish_reason"] != "length"
           for r in results):
        raise AssertionError(f"router: a request did not complete: "
                             f"{[r.metrics for r in results]}")
    ticks = sum(e["ticks"] for e in per_engine.values())
    _check_launches("replicas router", counts, {
        "paged_decode": cfg.n_layers * ticks, "flash_fwd": 0,
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    for name, e in per_engine.items():
        if e["launches"] != cfg.n_layers * e["ticks"]:
            raise AssertionError(f"router: replica {name}: {e}")
    emit({"phase": "replicas", "part": "router", "replicas": 2,
          "requests": len(prompts), "new_tokens": FD_NEW,
          "placements": placed, "killed": victim,
          "flights_held_at_kill": held, "failovers": failovers,
          "attempts": [r.metrics["router_attempts"] for r in results],
          "finished_on": [r.metrics["replica"] for r in results],
          "per_engine": per_engine, "launches": counts, "wall_s": wall,
          **clock.latency({i for i, r in enumerate(results)
                           if r.metrics["router_attempts"] > 1}),
          "serve": _serve_latency(served), "pumps": len(pumps),
          "router_host_ms_per_pump": _quantiles(
              [(p - d) * 1e3 for p, d in pumps]),
          "pump_host_ms_with_steps": _quantiles(
              [p * 1e3 for p, _ in pumps]),
          "card": smi})
    for s in sessions:
        s.close()
    return [(p, r.tokens) for p, r in zip(prompts, results)]


class _Legs:
    """Host-clock spans of the migration's legs, each closed by a
    synchronise (the library has none), with the bytes each moved."""

    def __init__(self, torch):
        self.torch = torch
        self.ms: dict = {}
        self.bytes: dict = {}
        self.restore: list = []

    def wrap(self, owner, name: str, leg: str, nbytes) -> None:
        real = getattr(owner, name)
        torch = self.torch

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.ms.setdefault(leg, []).append(
                (time.perf_counter() - t) * 1e3)
            self.bytes.setdefault(leg, []).append(nbytes(a, out))
            return out

        setattr(owner, name, timed)
        self.restore.append((owner, name, real))

    def unwrap(self) -> None:
        for owner, name, real in reversed(self.restore):
            setattr(owner, name, real)
        self.restore.clear()

    def report(self) -> dict:
        out = {}
        for leg, ms in self.ms.items():
            b = self.bytes[leg]
            out[leg] = {"calls": len(ms),
                        "ms_median": sorted(ms)[len(ms) // 2],
                        "ms_max": max(ms), "ms_total": sum(ms),
                        "bytes": sum(b),
                        "gb_per_s": sum(b) / (sum(ms) / 1e3) / 1e9}
        return out


def _disagg_fleet(params, cfg, kv, knobs):
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.serving.disagg import LocalDisaggReplica
    return [LocalDisaggReplica(f"{pool[0]}{i}",
                               serving.serve(params, cfg, **knobs), kv,
                               pool=pool)
            for i, pool in enumerate(("prefill", "decode", "decode"))]


def _disagg_run(torch, router, replicas, prompts, max_tokens, on_kill=None):
    """Submit ``prompts``; once every flight decodes on a decode replica
    and has its first decode token, kill the decode replica holding the
    most flights; drain.  (results, victim, flights held, client clock,
    wall seconds)."""
    clock = _ClientClock()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [clock.submit(router, p, max_tokens) for p in prompts]
    _pump_until(router, lambda: bool(router._flights) and all(
        fl.state == "decoding" and fl.delivered >= 2
        for fl in router._flights.values()),
        "a decode token on every flight")
    if on_kill is not None:
        on_kill()
    victim, held = _kill_busiest(router, replicas)
    router.drain(timeout_s=300)
    torch.cuda.synchronize()
    return ([f.result() for f in futs], victim, held, clock,
            time.perf_counter() - t0)


def _hist_totals(name: str) -> tuple:
    from horovod_tpu_torch.obs import REGISTRY
    fam = next(f for f in REGISTRY.snapshot() if f["name"] == name)
    return (sum(s["count"] for s in fam["samples"]),
            sum(s["sum"] for s in fam["samples"]))


def replicas_disagg(torch, smi, params, cfg, prompts, served) -> list:
    """One prefill and two decode replicas behind the DisaggRouter, every
    migration through the native KV store on 127.0.0.1; the decode
    replica holding the most flights is killed after the first decode
    tokens, and its requests re-import on the other."""
    import numpy as np

    from horovod_tpu_torch._native import KvClient, KvServer
    from horovod_tpu_torch.serving.disagg import DisaggRouter, migration
    from horovod_tpu_torch.serving.disagg import transport as mig_t

    kv_srv = KvServer(secret="")
    kv = KvClient("127.0.0.1", kv_srv.port, timeout_ms=30000, secret="")
    legs = _Legs(torch)
    try:
        reps = _disagg_fleet(params, cfg, kv, RP_KNOBS)
        warm = np.random.RandomState(4).randint(0, cfg.vocab_size,
                                                size=(16,))
        per_engine: dict = {}
        for rep in reps:
            _run_requests(rep.session, [warm], 2)
            _count_decode_launches(rep.session.engine, per_engine,
                                   rep.replica_id)
        prefill_ticks0 = reps[0].session.engine.decode_ticks
        # Every import: the request's pages kept on the device right
        # after it, compared with the payload once the run is over.
        imports = []
        for rep in reps[1:]:
            eng = rep.session.engine

            def checked(manifest, k_bytes, v_bytes, *, stream_cb=None,
                        eng=eng, real=eng.import_migrated,
                        rid=rep.replica_id):
                req = real(manifest, k_bytes, v_bytes, stream_cb=stream_cb)
                idx = torch.as_tensor(
                    eng.pager.table(req.req_id)[:manifest["n_blocks"]],
                    device=eng.device)
                imports.append({
                    "replica": rid, "manifest": manifest,
                    "payload": (k_bytes, v_bytes),
                    "ncb": req.cached_tokens // eng.cache.block_size,
                    "pages": tuple(p.index_select(1, idx)
                                   for p in (eng.k_pool, eng.v_pool))})
                return req

            eng.import_migrated = checked
            legs.wrap(eng, "import_migrated", "import_h2d_scatter",
                      lambda a, out: len(a[1]) + len(a[2]))
        legs.wrap(migration, "gather_pages", "export_gather_d2h",
                  lambda a, out: sum(t.numel() * t.element_size()
                                     for t in out))
        legs.wrap(migration, "payload_bytes", "export_tobytes",
                  lambda a, out: len(out))
        legs.wrap(mig_t, "publish_migration", "publish",
                  lambda a, out: len(a[3]) + len(a[4]))
        legs.wrap(mig_t, "fetch_migration", "fetch",
                  lambda a, out: len(out[1]) + len(out[2]))

        router = DisaggRouter(reps, kv)
        names = ("hvd_disagg_kv_bytes_total", "hvd_disagg_exports_total",
                 "hvd_disagg_imports_total",
                 "hvd_disagg_blocks_attached_total",
                 "hvd_disagg_failovers_total")
        before = _counters_now(names)
        h0 = _hist_totals("hvd_disagg_handoff_seconds")
        at_kill = []
        zero_launches()
        results, victim, held, clock, wall = _disagg_run(
            torch, router, reps, prompts, FD_NEW,
            on_kill=lambda: at_kill.append(len(imports)))
        counts = read_launches()
        legs.unwrap()
        moved = _counter_deltas(before)
        h1 = _hist_totals("hvd_disagg_handoff_seconds")
        if not all(r.metrics["migrated"] for r in results):
            raise AssertionError(f"disagg: a request did not migrate: "
                                 f"{[r.metrics for r in results]}")
        if any(len(r.tokens) != FD_NEW or r.metrics["finish_reason"]
               != "length" for r in results):
            raise AssertionError(f"disagg: a request did not complete: "
                                 f"{[r.metrics for r in results]}")
        ticks = sum(e["ticks"] for e in per_engine.values())
        _check_launches("replicas disagg", counts, {
            "paged_decode": cfg.n_layers * ticks, "flash_fwd": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
        pre = per_engine[reps[0].replica_id]
        if pre["ticks"] or pre["launches"] or \
                reps[0].session.engine.decode_ticks != prefill_ticks0:
            raise AssertionError(f"disagg: the prefill engine decoded: "
                                 f"{pre}")
        for name, e in per_engine.items():
            if e["launches"] != cfg.n_layers * e["ticks"]:
                raise AssertionError(f"disagg: replica {name}: {e}")
        reimports = [im for im in imports[at_kill[0]:]
                     if im["replica"] != victim]
        if len(reimports) < held[victim]:
            raise AssertionError(
                f"disagg: {len(reimports)} imports after the kill for the "
                f"{held[victim]} flights of {victim}")
        # The imported pages, bitwise, against the payload's blocks that
        # were not attached from the prefix cache.
        compared = 0
        for im in imports:
            for page, raw in zip(im["pages"], im["payload"]):
                want = migration.payload_tensor(
                    raw, im["manifest"]["dtype"], tuple(page.shape),
                    "cpu")[:, im["ncb"]:]
                got = page[:, im["ncb"]:].cpu()
                if not torch.equal(got.view(torch.int16),
                                   want.view(torch.int16)):
                    raise AssertionError(
                        f"disagg: the pages of {im['manifest']['version']} "
                        f"on {im['replica']} differ from its payload")
                compared += got.numel() * got.element_size()
        per_request = {im["manifest"]["version"]:
                       im["manifest"]["k_len"] + im["manifest"]["v_len"]
                       for im in imports}
        emit({"phase": "replicas", "part": "disagg",
              "replicas": {"prefill": 1, "decode": 2},
              "kv": "native KvServer/KvClient on 127.0.0.1",
              "requests": len(prompts), "new_tokens": FD_NEW,
              "killed": victim, "flights_held_at_kill": held,
              "imports": len(imports), "reimports": len(reimports),
              "per_engine": per_engine, "launches": counts,
              "counters": moved,
              "migration_bytes_total": moved["hvd_disagg_kv_bytes_total"],
              "migration_bytes_per_request": sorted(per_request.values()),
              "pages_compared_bytes": compared, "pages_bitwise": True,
              "legs": legs.report(),
              "handoff_s": {"count": h1[0] - h0[0],
                            "mean": (h1[1] - h0[1]) / max(1, h1[0] - h0[0])},
              "wall_s": wall,
              **clock.latency({i for i, r in enumerate(results)
                               if r.metrics["disagg_attempts"] > 2}),
              "serve": _serve_latency(served), "card": smi})
        imports.clear()
        for rep in reps:
            rep.session.close()
        return [(p, r.tokens) for p, r in zip(prompts, results)]
    finally:
        legs.unwrap()
        kv.close()
        kv_srv.stop()


def replicas_fp32(torch, smi) -> None:
    """Two layers at full width in fp32, TF32 off: a disaggregated run and
    a router run with a replica killed emit plain ``serve()``'s tokens."""
    import dataclasses

    import numpy as np

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.serving.disagg import DictKV, DisaggRouter
    from horovod_tpu_torch.serving.frontdoor import LocalReplica, Router

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(),
                                  n_layers=2, dtype=torch.float32)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        params = llama.init_params(cfg, gen, "cuda")
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, cfg.vocab_size, size=(n,))
                   for n in (48, 96, 160, 256)]
        knobs = dict(num_blocks=128, block_size=16, max_active=4,
                     prefix_cache=True)
        plain = serving.serve(params, cfg, **knobs)
        want = [r.tokens for r in
                _run_requests(plain, prompts, RP_FP32_NEW)[0]]
        plain.close()
        runs = {}
        zero_launches()
        reps = [LocalReplica(str(i), serving.serve(params, cfg, **knobs))
                for i in range(2)]
        res, victim, held, _, _ = _router_run(torch, Router(reps), reps,
                                              prompts, RP_FP32_NEW)
        runs["router_killed"] = {
            "tokens_equal": [r.tokens == w for r, w in zip(res, want)],
            "killed": victim, "flights_held_at_kill": held,
            "attempts": [r.metrics["router_attempts"] for r in res]}
        for rep in reps:
            rep.session.close()
        kv = DictKV()
        reps = _disagg_fleet(params, cfg, kv, knobs)
        res, victim, held, _, _ = _disagg_run(
            torch, DisaggRouter(reps, kv), reps, prompts, RP_FP32_NEW)
        runs["disagg_killed"] = {
            "tokens_equal": [r.tokens == w for r, w in zip(res, want)],
            "migrated": [r.metrics["migrated"] for r in res],
            "killed": victim, "flights_held_at_kill": held}
        for rep in reps:
            rep.session.close()
        counts = read_launches()
        emit({"phase": "replicas", "part": "fp32_exactness", "layers": 2,
              "d_model": cfg.d_model, "dtype": "float32", "tf32": False,
              "prompt_lens": [len(p) for p in prompts],
              "new_tokens": RP_FP32_NEW, "runs": runs, "launches": counts,
              "card": smi})
        if not all(all(r["tokens_equal"]) for r in runs.values()) or \
                not all(runs["disagg_killed"]["migrated"]):
            raise AssertionError(f"replicas fp32: {runs}")
        if counts["paged_decode"] == 0 or any(
                counts[n] for n in counts if n != "paged_decode"):
            raise AssertionError(f"replicas fp32: launches {counts}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    del params
    _free_cuda(torch)


def phase_replicas(torch, smi: str, served) -> None:
    from horovod_tpu_torch.models import llama

    _free_cuda(torch)
    cfg = llama.LlamaConfig.llama2_7b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)                          # the serve phase's weights
    params = llama.init_params(cfg, gen, "cuda")
    prompts = _serve_prompts(cfg)
    seqs = {"router": replicas_router(torch, smi, params, cfg, prompts,
                                      served)}
    _free_cuda(torch)
    seqs["disagg"] = replicas_disagg(torch, smi, params, cfg, prompts,
                                     served)
    _free_cuda(torch)
    shares = {part: teacher_forced(torch, params, cfg, s)
              for part, s in seqs.items()}
    emit({"phase": "replicas", "part": "teacher_forced",
          "delta_rel": FD_DELTA_REL, "parts": shares, "card": smi})
    del params
    _free_cuda(torch)
    replicas_fp32(torch, smi)


# ---------------------------------------------------------------------------
# training Llama-2-7B at full width and depth
# ---------------------------------------------------------------------------

TRAIN_S = 4096          # Llama 2's training context, one sequence a step
TRAIN_LR = 1e-3         # survives bf16 rounding of weights near 1/64


def _free_cuda(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(torch, smi: str, steps: int = 3) -> dict:
    import numpy as np

    from horovod_tpu_torch.models import llama

    _free_cuda(torch)
    cfg = llama.LlamaConfig.llama2_7b()            # bf16, remat=True
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, "cuda")
    n_params = sum(t.numel() for t in llama.trainable(params))
    opt = torch.optim.Adam(llama.trainable(params), lr=TRAIN_LR, fused=True)
    step = llama.make_train_step(cfg, opt)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(1, TRAIN_S + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches()                            # every counter of the path
    losses, step_s = [step(params, batch).item()], []   # warm-up step
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_steps = steps + 1
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "paged_decode": 0}
    if counts != {k: n_steps * v for k, v in want.items()}:
        raise AssertionError(f"launches over {n_steps} steps: {counts}; "
                             f"want per step {want}")
    ln_v = math.log(cfg.vocab_size)
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[0] - ln_v) <= 2
            and all(x < losses[0] for x in losses[1:])):
        raise AssertionError(f"losses {losses}: want finite, the first "
                             f"within 2 of ln V = {ln_v}, then below it")
    med = sorted(step_s)[len(step_s) // 2]
    # bench.py's count: 6 N per token for the dense parameters (forward and
    # backward) plus 12 L D S for the attention products.
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * TRAIN_S
    tok_s = TRAIN_S / med
    res = {"phase": "train", "model": "llama2_7b", "dtype": "bfloat16",
           "remat": cfg.remat, "batch": 1, "seq": TRAIN_S,
           "optimizer": f"Adam(lr={TRAIN_LR}, fused=True)",
           "params": n_params, "losses": losses, "step_s": step_s,
           "step_ms_median": med * 1e3, "tokens_per_s": tok_s,
           "mfu": tok_s * flops_per_token / BF16_FLOPS,
           "flops_per_token": flops_per_token,
           "launches": counts, "launches_per_step": want,
           "peak_mem_gb": peak_gb, "card": smi}
    emit(res)
    train_breakdown(torch, step, params, batch, med * 1e3, smi)
    del params, opt, step, batch
    _free_cuda(torch)
    return res


def train_breakdown(torch, step, params, batch, wall_ms: float,
                    smi: str, **tags) -> None:
    """Where one training step's time goes: the device time the profiler
    attributes to kernels, the idle share against the step's host clock
    (median of the timed steps), the top kernels, and the three flash
    kernels' device time in the step.  ``tags`` go into the line."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]

    def flash_ms(tag):
        return sum(e.self_device_time_total for e in kernels
                   if tag in e.key) / 1e3

    emit({"phase": "train_breakdown", **tags, "wall_ms_per_step": wall_ms,
          "device_ms_per_step": device_ms if kernels else "not measured",
          "device_idle_share": (1 - device_ms / wall_ms) if kernels
          else "not measured",
          "flash_ms_per_step": {
              "flash_fwd": flash_ms("flash_fwd_kernel"),
              "flash_bwd_dq": flash_ms("flash_bwd_dq_kernel"),
              "flash_bwd_dkv": flash_ms("flash_bwd_dkv_kernel")},
          "top_kernels_ms_per_step": {
              e.key[:80]: e.self_device_time_total / 1e3 for e in top},
          "card": smi})


# ---------------------------------------------------------------------------
# the training variants: remat="dots" and the blockwise cross-entropy
# ---------------------------------------------------------------------------

# The blockwise loss against train's dense one at the first step: the
# blockwise block logits stay fp32 where the dense path rounds its logits
# to bf16 (2^-8 of a logit of about 1-10 at random init), so the mean nll
# moves by far less than a ulp of the logits, not bitwise.
BLOCKWISE_FIRST_REL = 1e-3


def phase_train_variants(torch, smi: str, trained: dict,
                         steps: int = 3) -> None:
    """train's model, seed and batch, fresh weights for each variant, one
    warm-up and ``steps`` timed steps: remat="dots" (first loss bitwise
    equal to train's) and blockwise_ce=True with remat=True (first loss
    within ``BLOCKWISE_FIRST_REL``); the later losses within
    ``DP_LOSS_REL`` of train's; train's flash launches a step."""
    import dataclasses

    import numpy as np

    from horovod_tpu_torch.models import llama

    base = llama.LlamaConfig.llama2_7b()
    tokens = np.random.RandomState(0).randint(
        0, base.vocab_size, size=(1, TRAIN_S + 1))
    want = {k: (steps + 1) * v for k, v in trained["launches_per_step"].items()}
    for name, edit, first_rel in (
            ("remat_dots", dict(remat="dots"), 0.0),
            ("blockwise_ce", dict(blockwise_ce=True), BLOCKWISE_FIRST_REL)):
        _free_cuda(torch)
        cfg = dataclasses.replace(base, **edit)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda")
        opt = torch.optim.Adam(llama.trainable(params), lr=TRAIN_LR,
                               fused=True)
        step = llama.make_train_step(cfg, opt)
        batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        losses, step_s = [step(params, batch).item()], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(params, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss.item())
        counts = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        med = sorted(step_s)[len(step_s) // 2]
        base_losses = trained["losses"]
        first = abs(losses[0] - base_losses[0]) / abs(base_losses[0])
        rel = [first] + _loss_rel(losses, base_losses)
        emit({"phase": "train_variants", "variant": name,
              "remat": cfg.remat, "blockwise_ce": cfg.blockwise_ce,
              "losses": losses, "train_losses": trained["losses"],
              "loss_rel_to_train": rel, "first_rel_tol": first_rel,
              "later_rel_tol": DP_LOSS_REL, "step_s": step_s,
              "step_ms_median": med * 1e3,
              "train_step_ms_median": trained["step_ms_median"],
              "peak_mem_gb": peak_gb,
              "train_peak_mem_gb": trained["peak_mem_gb"],
              "launches": counts, "card": smi})
        if counts != want:
            raise AssertionError(f"{name}: launches over {steps + 1} steps "
                                 f"{counts}, want {want}")
        train_breakdown(torch, step, params, batch, med * 1e3, smi,
                        variant=name)
        first_ok = (losses[0] == base_losses[0] if first_rel == 0.0
                    else first <= first_rel)
        if not (all(math.isfinite(x) for x in losses) and first_ok
                and all(r <= DP_LOSS_REL for r in rel[1:])):
            raise AssertionError(f"{name}: losses {losses} against train's "
                                 f"{trained['losses']}")
        del params, opt, step, batch
    _free_cuda(torch)


# ---------------------------------------------------------------------------
# data-parallel training through Horovod's runtime (one rank over NCCL)
# ---------------------------------------------------------------------------

# Losses of train_dp's steps 2-4 against train's.  At one rank the
# allreduce hands every gradient back unchanged, so the two runs differ
# only where a kernel sums in an order that varies between runs (the
# embedding's backward adds rows by atomics); two builds of this step
# whose backward kernels summed in different orders gave losses 2e-4
# apart, and this allows ten times that.
DP_LOSS_REL = 2e-3
DP_VERB_DTYPES = ("float32", "bfloat16", "int32")


def _engine_metrics():
    """The engine's obs counters this phase reads, as plain numbers."""
    from horovod_tpu_torch.ops import engine as E
    fused = E._m_fusion_batch._default().cumulative_buckets()
    return {"entries": E._m_coll_v["allreduce"].value,
            "bytes": E._m_bytes_v["allreduce"].value,
            "dispatches_nccl": E._m_dispatches.labels(backend="nccl").value,
            "cycles": E._m_cycles.value,
            "groups": fused[-1][1], "groups_of_one": fused[0][1]}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def dp_collectives_check(torch, hvd) -> dict:
    """Every verb and ReduceOp of the runtime at one rank on the card:
    each gives back its input, bitwise, in float32, bfloat16 and int32
    (the world-1 result); then a 16 MB float32 allreduce through the
    engine, on the host clock (one rank moves no bytes between cards, so
    its bus bandwidth is 0 by definition)."""
    import torch.distributed as dist
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    checked = []
    for dt in DP_VERB_DTYPES:
        dtype = getattr(torch, dt)
        x = (torch.randn(8, 6, generator=gen, device="cuda") * 8).to(dtype)
        outs = {f"allreduce.{op.value}": hvd.allreduce(x, op)
                for op in (hvd.Average, hvd.Sum, hvd.Min, hvd.Max,
                           hvd.Product)}
        outs["allreduce_"] = hvd.allreduce_(x.clone(), hvd.Average)
        outs.update({f"grouped.{i}": o for i, o in enumerate(
            hvd.grouped_allreduce([x, x[:3], x[5:]], hvd.Average))})
        outs["allgather"] = hvd.allgather(x)
        outs["broadcast"] = hvd.broadcast(x, 0)
        outs["broadcast_"] = hvd.broadcast_(x.clone(), 0)
        outs["alltoall"] = hvd.alltoall(x)
        outs["alltoall.splits"] = hvd.alltoall(x, splits=[8])
        outs["reducescatter.sum"] = hvd.reducescatter(x, hvd.Sum)
        outs["reducescatter.average"] = hvd.reducescatter(x, hvd.Average)
        h = hvd.allreduce_async(x, hvd.Sum, name=f"dp_check.async.{dt}")
        outs["allreduce_async"] = hvd.synchronize(h)
        for name, got in outs.items():
            want = {"grouped.1": x[:3], "grouped.2": x[5:]}.get(name, x)
            if got.device != x.device or not torch.equal(got, want):
                raise AssertionError(f"world-1 {name} in {dt}: got "
                                     f"{got.device} {got.flatten()[:4]}")
            checked.append(f"{name}.{dt}")
    hvd.barrier()
    if hvd.broadcast_object({"a": [1, 2]}) != {"a": [1, 2]} or \
            hvd.allgather_object(7) != [7] or hvd.join() != 0:
        raise AssertionError("world-1 object verbs or join")

    buf = torch.randn(4 << 20, generator=gen, device="cuda")   # 16 MB
    times, raw = [], []
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hvd.allreduce_(buf, hvd.Sum, name="dp_check.16mb")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(buf)
        end.record()
        end.synchronize()
        raw.append(start.elapsed_time(end))
    times, raw = sorted(times[3:]), sorted(raw[3:])
    return {"verbs_checked": len(checked),
            "allreduce_16mb_ms_host": times[len(times) // 2],
            "dist_all_reduce_16mb_ms": raw[len(raw) // 2],
            "busbw_gbs": 0.0, **_perf_timing_check(torch, hvd, buf)}


def _perf_timing_check(torch, hvd, buf) -> dict:
    """The engine times a group with CUDA events on its stream, read in a
    later cycle, only where the performance model has a wire to time (two
    ranks or more), which one card cannot host.  So the one rank poses as
    two for one AVERAGE allreduce (NCCL at world size 1 hands the buffer
    back, and the engine's stream halves it: exact in float32), and a
    later cycle must feed the model one observation whose time lies
    inside the host's window around the call.  What it reports is no bus
    bandwidth: no byte crossed a link."""
    from horovod_tpu_torch.obs import perfmodel

    obs = perfmodel._m_obs.labels(verb="allreduce")
    state = hvd.global_state()
    before = obs.value
    want = buf / 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state.size = 2
    try:
        hvd.allreduce_(buf, hvd.Average, name="dp_check.timed")
        torch.cuda.synchronize()
    finally:
        state.size = 1
    host_s = time.perf_counter() - t0
    for _ in range(50):           # the engine reads the events after it
        if obs.value > before:    # completes the handle
            break
        hvd.allreduce_(buf[:1].clone(), hvd.Sum, name="dp_check.next")
        time.sleep(0.1)
    rows = [r for r in perfmodel.MODEL.summary()
            if r["verb"] == "allreduce" and r["n"] == 2]
    seconds = rows[0]["seconds"] if rows else None
    if obs.value - before != 1 or not seconds or seconds > host_s or \
            not torch.equal(buf, want):
        raise AssertionError(
            f"engine timing: {obs.value - before} observations, event "
            f"seconds {seconds} against the host's {host_s}")
    return {"timed_group_ms_events": seconds * 1e3,
            "timed_group_ms_host": host_s * 1e3}


def _engine_device_ms(prof) -> tuple:
    """(NCCL ms, engine-stream ms) of one profiled step: the device time
    of NCCL's kernels, and of everything else on the engine's own stream
    (packing a fusion buffer, the division, the copies out).  The
    engine's stream is found by marker kernels (``torch.cuda._sleep``'s
    ``spin_kernel``) launched on it before and after the step, since the
    profiler does not see the engine thread's host side; None when no
    marker or more than one stream shows up."""
    device = [e for e in prof.events() if e.device_type.name == "CUDA"]
    marks = [e for e in device if "spin" in e.name]
    streams = {getattr(e, "device_resource_id", None) for e in marks}
    if len(streams) != 1 or None in streams:
        return None, None

    def ms(evts):
        return sum(e.time_range.end - e.time_range.start for e in evts) / 1e3

    stream = streams.pop()
    return (ms(e for e in device if "nccl" in e.name.lower()),
            ms(e for e in device if e.device_resource_id == stream
               and "spin" not in e.name and "nccl" not in e.name.lower()))


def _dp_steps(torch, hvd, steps: int, span: str = "") -> dict:
    """The train phase's model, weights and batch, stepped through the
    initialized runtime: ``broadcast_parameters``, ``DistributedOptimizer``
    over fused Adam, one warm-up and ``steps`` timed steps, every count
    read per step, each step inside a trace span named ``span`` when one
    is given.  Returns what was measured, the faults found (all but the
    losses, which the caller holds against train's) and the step,
    parameters and batch."""
    import contextlib

    import numpy as np
    import torch.distributed as dist

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.obs import trace

    faults = []
    if dist.get_backend() != "nccl" or hvd.size() != 1 or \
            hvd.global_state().device != torch.device("cuda", 0):
        faults.append(f"runtime: backend {dist.get_backend()}, size "
                      f"{hvd.size()}, device {hvd.global_state().device}")
    cfg = llama.LlamaConfig.llama2_7b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, "cuda")
    named = llama.named_trainable(params)
    hvd.broadcast_parameters(named, root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([t for _, t in named], lr=TRAIN_LR, fused=True),
        named_parameters=named)
    step = llama.make_train_step(cfg, opt)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(1, TRAIN_S + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    grad_bytes = sum(t.numel() * t.element_size() for _, t in named)

    # Every buffer the engine hands NCCL, seen where it is handed over.
    seen = []
    real_all_reduce = dist.all_reduce

    def spy(tensor, *a, **kw):
        seen.append((tensor.device, tensor.numel() * tensor.element_size()))
        return real_all_reduce(tensor, *a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    dist.all_reduce = spy
    try:
        per_step, losses, step_s = [], [], []
        for i in range(steps + 1):
            before = _engine_metrics()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (trace.start_trace(span, lane="steps", step=i) if span
                  else contextlib.nullcontext()):
                loss = step(params, batch)
                torch.cuda.synchronize()
            if i:
                step_s.append(time.perf_counter() - t0)
            losses.append(loss.item())
            per_step.append(_delta(_engine_metrics(), before))
    finally:
        dist.all_reduce = real_all_reduce
    counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads_on_card = all(t.grad is not None and t.grad.device ==
                        torch.device("cuda", 0) for _, t in named)

    n_steps = steps + 1
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "paged_decode": 0}
    if counts != {k: n_steps * v for k, v in want.items()}:
        faults.append(f"launches {counts}, want per step {want}")
    for i, m in enumerate(per_step):
        if m["entries"] != len(named):
            faults.append(f"step {i}: {m['entries']} allreduce entries, "
                          f"want {len(named)}")
        if m["bytes"] != grad_bytes:
            faults.append(f"step {i}: {m['bytes']} bytes, want "
                          f"{grad_bytes}")
        if m["groups"] - m["groups_of_one"] < 1:
            faults.append(f"step {i}: no fused dispatch of > 1 tensor")
        if m["dispatches_nccl"] < 1:
            faults.append(f"step {i}: no NCCL dispatch")
    if not grads_on_card or {d for d, _ in seen} != \
            {torch.device("cuda", 0)}:
        faults.append(f"gradients on the card {grads_on_card}, NCCL "
                      f"buffers on {sorted({str(d) for d, _ in seen})}")

    med = sorted(step_s)[len(step_s) // 2]
    res = {"ranks": hvd.size(), "backend": dist.get_backend(), "batch": 1,
           "seq": TRAIN_S, "optimizer": f"DistributedOptimizer(Adam(lr="
           f"{TRAIN_LR}, fused=True))", "losses": losses, "step_s": step_s,
           "step_ms_median": med * 1e3,
           "peak_mem_gb": peak_gb, "grad_leaves": len(named),
           "grad_bytes": grad_bytes, "engine_per_step": per_step,
           "nccl_calls": len(seen), "launches": counts}
    return {"res": res, "faults": faults, "step": step, "params": params,
            "batch": batch}


def _loss_rel(losses: list, base: list) -> list:
    return [abs(a - b) / abs(b) for a, b in zip(losses[1:], base[1:])]


def _against_train(res: dict, trained: dict) -> dict:
    """Throughput and losses of a data-parallel run beside train's."""
    tok_s = TRAIN_S / (res["step_ms_median"] / 1e3)
    return {"tokens_per_s": tok_s,
            "mfu": tok_s * trained["flops_per_token"] / BF16_FLOPS,
            "train_losses": trained["losses"],
            "loss_rel_vs_train": _loss_rel(res["losses"], trained["losses"]),
            "loss_rel_tol": DP_LOSS_REL,
            "train_step_ms_median": trained["step_ms_median"]}


def _loss_faults(losses: list, base: list) -> list:
    """The first loss bitwise equal to ``base``'s, the later ones within
    ``DP_LOSS_REL``, all finite."""
    faults = []
    if losses[0] != base[0]:
        faults.append(f"first loss {losses[0]!r} != train's {base[0]!r}")
    if not all(math.isfinite(x) for x in losses) or \
            max(_loss_rel(losses, base)) > DP_LOSS_REL:
        faults.append(f"losses {losses} against train's {base}")
    return faults


def phase_train_dp(torch, smi: str, trained: dict, steps: int = 3) -> dict:
    """The train phase's model, weights and batch, stepped through
    Horovod's runtime at one rank: ``hvd.init()`` (NCCL on cuda:0),
    ``broadcast_parameters``, ``DistributedOptimizer`` over fused Adam.
    One warm-up and ``steps`` timed steps, every count checked per step;
    then one profiled step and the verbs at world size 1."""
    import horovod_tpu_torch as hvd

    _free_cuda(torch)
    hvd.init()
    try:
        run = _dp_steps(torch, hvd, steps)
        res = {"phase": "train_dp", "model": "llama2_7b", **run["res"],
               **_against_train(run["res"], trained),
               "step_vs_train": run["res"]["step_ms_median"]
               / trained["step_ms_median"], "card": smi}
        emit(res)
        faults = run["faults"] + _loss_faults(res["losses"],
                                              trained["losses"])
        if faults:
            raise AssertionError("train_dp: " + "; ".join(faults))
        dp_breakdown(torch, run["step"], run["params"], run["batch"],
                     res["step_ms_median"], smi)
        emit({"phase": "dp_collectives", **dp_collectives_check(torch, hvd),
              "card": smi})
        del run
        return res
    finally:
        hvd.shutdown()
        _free_cuda(torch)


def dp_breakdown(torch, step, params, batch, wall_ms: float,
                 smi: str) -> None:
    """One profiled data-parallel step: the device time of kernels, the
    idle share against the timed steps' median, and the engine's part:
    NCCL's kernels and the rest of what it launched (packing a fusion
    buffer, the division, the copies out), with its dispatches and its
    cycles in the step."""
    from torch.profiler import ProfilerActivity, profile

    import horovod_tpu_torch as hvd

    before = _engine_metrics()
    stream = hvd.global_state().engine._stream
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.cuda.stream(stream):
            torch.cuda._sleep(1000)                 # marks the stream
        step(params, batch)
        with torch.cuda.stream(stream):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    eng = _delta(_engine_metrics(), before)
    kernels = [e for e in device_kernels(prof) if "spin" not in e.key]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    nccl_ms, copy_ms = _engine_device_ms(prof)
    emit({"phase": "train_dp_breakdown", "wall_ms_per_step": wall_ms,
          "device_ms_per_step": device_ms if kernels else "not measured",
          "device_idle_share": (1 - device_ms / wall_ms) if kernels
          else "not measured",
          "engine_nccl_ms_per_step": "not measured" if nccl_ms is None
          else nccl_ms,
          "engine_pack_unpack_ms_per_step": "not measured"
          if copy_ms is None else copy_ms,
          "engine_dispatches_per_step": eng["dispatches_nccl"],
          "engine_cycles_per_step": eng["cycles"],
          "fused_groups_per_step": eng["groups"] - eng["groups_of_one"],
          "card": smi})


# ---------------------------------------------------------------------------
# the collective data plane: wire precision, the decomposed schedule, ZeRO-1
# ---------------------------------------------------------------------------

# The wire modes the dataplane phase runs on the 7B gradient set:
# name -> (wire mode, schedule descriptor).  "fp32" is the plain path: the
# payload's own dtype on the wire, as every gradient of train_dp goes.
DATAPLANE_MODES = {"fp32": ("fp32", ""), "bf16": ("bf16", ""),
                   "int8": ("int8", ""), "fp8": ("fp8", ""),
                   "int8.rs_ag4": ("int8", "rs_ag:4"),
                   "fp32.compiled4": ("fp32", "compiled:rs_ag:4"),
                   "int8.compiled4": ("int8", "compiled:rs_ag:4")}
# Modes each mode's result must equal bitwise on every group: the
# compiled schedule replays the dispatched walk, which equals monolithic
# (at one rank the fp32 walk hands each element back times 1.0).
DATAPLANE_BITWISE = {"int8.rs_ag4": ("int8",),
                     "int8.compiled4": ("int8.rs_ag4", "int8"),
                     "fp32.compiled4": ("fp32",)}
# Fused groups (first, middle, last) held against the same function on
# the CPU, over a Gloo group of one.
DATAPLANE_CPU_GROUPS = 3
# Per-element bound of the round trips one rank's result takes, in units
# of its block's largest value: int8 and fp8 two quantization steps
# (encode against the shared scale, then the requantization: amax/254
# and 2^-4 of amax each), the bf16 wire one rounding of an fp32 payload;
# a bf16 result's own rounding (2^-8) comes on top.
DATAPLANE_ROUNDTRIP = {"int8": 2 / 254, "fp8": 2 * 2.0 ** -4,
                       "bf16": 2.0 ** -8, "fp32": 0.0}


def _grad_set(torch, llama, cfg):
    """The 7B DP step's gradients: ``named_trainable``'s 291 shapes and
    dtypes (bf16 weights, fp32 norms) in backward order (the last
    layer's first, as the hooks fire), random from a seeded generator."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    params = llama.init_params(cfg, gen, "cuda")
    shapes = [(name, tuple(t.shape), t.dtype) for name, t in
              llama.named_trainable(params)]
    del params
    _free_cuda(torch)
    grads = []
    for name, shape, dtype in reversed(shapes):
        g = torch.empty(shape, dtype=dtype, device="cuda")
        g.normal_(generator=gen).mul_(1e-3)
        grads.append((name, g))
    return grads


def _bits(t):
    """``t``'s bits as integers, for a bitwise comparison."""
    import torch
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _dataplane_run(torch, eng, entries, groups, mode, sched):
    """One pass of the whole set through the engine's allreduce at one
    rank, on the engine's stream: device ms (CUDA events; the gaps the
    host leaves included), the host ms of issuing it, peak memory;
    results dropped as they come.  A compiled schedule's pass must only
    replay graphs the checks captured, one replay a group."""
    from horovod_tpu_torch.ops.sched import compiled
    for e in entries:
        e.precision, e.schedule = mode, sched
    before = compiled.stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with torch.cuda.stream(eng._stream):
        start.record()
        for group in groups:
            eng._allreduce(group, None, 1)
        end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    after = compiled.stats()
    run = {"device_ms": start.elapsed_time(end), "host_ms": host_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "working_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           # a graph pool's temporaries are reserved, never "allocated"
           "reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "replays": after["replays"] - before["replays"],
           "captures": after["captures"] - before["captures"]}
    if sched.startswith("compiled:") and (
            run["captures"] or run["replays"] != len(groups)):
        raise AssertionError(f"dataplane {mode} {sched}: {run['captures']} "
                             f"captures and {run['replays']} replays in "
                             f"the timed pass of {len(groups)} groups")
    return run


def _dataplane_checks(torch, eng, entries, groups, cpu_group):
    """Every group: each mode within its round-trip bound of the input,
    int8 rs_ag:4 bitwise equal to int8 monolithic; a few groups: each
    mode bitwise equal to the same function on the CPU (fp8 also within
    its bound), with the dtype of every collective call recorded."""
    import torch.distributed as dist

    from horovod_tpu_torch.ops import reduction as R
    from horovod_tpu_torch.ops.sched import executor as SE

    faults, calls = [], {}
    names = [n for n in ("reduce_scatter_single", "reduce_scatter_tensor",
                         "all_gather_single", "all_gather_into_tensor",
                         "all_reduce") if hasattr(dist, n)]
    real = {n: getattr(dist, n) for n in names}

    def spy(name):
        def call(*a, **kw):
            t = a[1] if name.startswith(("reduce_scatter", "all_gather")) \
                else a[0]
            op = kw.get("op")
            key = f"{name}:{str(t.dtype).rpartition('.')[2]}" + (
                ":max" if op is not None and op == dist.ReduceOp.MAX
                else "")
            if t.is_cuda:
                calls.setdefault(mode_now[0], set()).add(key)
            return real[name](*a, **kw)
        return call

    mode_now = [""]
    picks = {0, len(groups) // 2, len(groups) - 1}
    worst = {}
    for name in names:
        setattr(dist, name, spy(name))
    try:
        for gi, group in enumerate(groups):
            outs = {}
            for label, (mode, sched) in DATAPLANE_MODES.items():
                mode_now[0] = label
                for e in group:
                    e.precision, e.schedule = mode, sched
                with torch.cuda.stream(eng._stream):
                    outs[label] = eng._allreduce(group, None, 1)
                torch.cuda.current_stream().wait_stream(eng._stream)
            for label, res in outs.items():
                mode = DATAPLANE_MODES[label][0]
                for e, r in zip(group, res):
                    x = e.payload.float().reshape(-1)
                    tail = x.numel() % 512
                    pad = x.new_zeros((512 - tail) % 512)
                    amax = torch.cat([x.abs(), pad]).view(-1, 512).amax(-1)
                    amax = amax.repeat_interleave(512)[:x.numel()]
                    err = (r.float().reshape(-1) - x).abs()
                    out_ulp = 2.0 ** -8 if r.element_size() == 2 else 0.0
                    bound = amax * (DATAPLANE_ROUNDTRIP[mode] * 1.001
                                    + out_ulp)
                    if not bool((err <= bound).all()):
                        faults.append(f"{label} group {gi} {e.name}: "
                                      f"round trip beyond its bound")
                    worst[label] = max(worst.get(label, 0.0),
                                       float((err / amax.clamp_min(
                                           1e-30)).max()))
            for label, others in DATAPLANE_BITWISE.items():
                for other in others:
                    if not all(torch.equal(_bits(a), _bits(b)) for a, b in
                               zip(outs[label], outs[other])):
                        faults.append(f"group {gi}: {label} != {other}")
            if gi not in picks:
                continue
            mode_now[0] = "cpu"
            payload = [e.payload.cpu() for e in group]
            flat = torch.cat([p.reshape(-1) for p in payload])
            for label, (mode, sched) in DATAPLANE_MODES.items():
                if sched:
                    cpu = SE.execute_allreduce(
                        payload, group[0].op, descriptor=sched,
                        group=cpu_group, n=1, precision=mode)
                    cpu = torch.cat([c.reshape(-1) for c in cpu])
                elif mode == "fp32":
                    cpu = flat.clone()
                    dist.all_reduce(cpu, group=cpu_group)
                else:
                    cpu = R.allreduce(flat, group[0].op, mode, cpu_group, 1)
                gpu = torch.cat([r.reshape(-1) for r in outs[label]]).cpu()
                if not torch.equal(_bits(gpu), _bits(cpu)):
                    diff = float((gpu.float() - cpu.float()).abs().max())
                    faults.append(f"{label} group {gi}: card != CPU "
                                  f"(max abs diff {diff})")
            del outs
    finally:
        for name in names:
            setattr(dist, name, real[name])
    want = {"int8": "float16", "fp8": "float16", "int8.rs_ag4": "float16",
            "int8.compiled4": "float16"}
    for label, cont in want.items():
        seen = calls.get(label, set())
        rs = {k.split(":")[1] for k in seen if k.startswith("reduce_scat")}
        ag = {k.split(":")[1] for k in seen if k.startswith("all_gather")}
        if rs != {cont} or not ag <= {"int8", "uint8", "float32"} or \
                not any(k.endswith(":max") for k in seen):
            faults.append(f"{label}: collectives {sorted(seen)}, want a "
                          f"{cont} reduce-scatter, MAX all_reduce, 1-byte "
                          "and fp32 gathers")
    return faults, {k: sorted(v) for k, v in calls.items()}, worst


def phase_dataplane(torch, smi: str) -> None:
    """The port's cast and quantized allreduce functions, called directly
    at one rank over NCCL on cuda:0 on the engine's stream (past the
    one-rank gate, which sends every knob to fp32 monolithic), on a
    gradient set of the 7B DP step's shape fused as the engine fuses it:
    device ms of the whole set in each mode beside the plain path's, peak
    memory, and the checks of :func:`_dataplane_checks`."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import engine as E
    from horovod_tpu_torch.ops.sched import compiled

    _free_cuda(torch)
    hvd.init()
    try:
        eng = hvd.global_state().engine
        cfg = llama.LlamaConfig.llama2_7b()
        grads = _grad_set(torch, llama, cfg)
        nbytes = sum(g.numel() * g.element_size() for _, g in grads)
        numel = sum(g.numel() for _, g in grads)
        entries = [E.TensorTableEntry(name=f"grad.{n}", verb="allreduce",
                                      payload=g, op=hvd.Average)
                   for n, g in grads]
        groups = eng._fuse(entries, eng._group_cap())
        cpu_group = dist.new_group(backend="gloo")
        faults, calls, worst = _dataplane_checks(torch, eng, entries,
                                                 groups, cpu_group)
        captured = compiled.stats()
        runs = {label: _dataplane_run(torch, eng, entries, groups, *ms)
                for label, ms in DATAPLANE_MODES.items()}
        # the least traffic of any allreduce of the set at one rank: the
        # payload read once and the result written once
        bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        base = runs["fp32"]["device_ms"]
        emit({"phase": "dataplane", "ranks": 1, "backend": "nccl",
              "tensors": len(grads), "bytes": nbytes,
              "dtypes": sorted({str(g.dtype) for _, g in grads}),
              "fused_groups": len(groups),
              "fusion_threshold": eng._group_cap(),
              "device_ms": {k: v["device_ms"] for k, v in runs.items()},
              "host_issue_ms": {k: v["host_ms"] for k, v in runs.items()},
              "ms_per_gb": {k: v["device_ms"] / (nbytes / 1e9)
                            for k, v in runs.items()},
              "over_plain_ms": {k: v["device_ms"] - base
                                for k, v in runs.items()},
              "bound_ms": bound_ms, "bound_by": "bytes",
              "peak_mem_gb": {k: v["peak_gb"] for k, v in runs.items()},
              "working_mem_gb": {k: v["working_gb"]
                                 for k, v in runs.items()},
              "peak_reserved_gb": {k: v["reserved_gb"]
                                   for k, v in runs.items()},
              "elements": numel, "worst_err_over_block_amax": worst,
              "collectives": calls,
              "compiled": {
                  "graphs": captured["graphs"],
                  "capture_s": captured["capture_s"],
                  "pool_bytes": captured["pool_bytes"],
                  "replays_in_timed_pass": {
                      k: v["replays"] for k, v in runs.items()
                      if DATAPLANE_MODES[k][1].startswith("compiled:")}},
              "cpu_checked_groups": DATAPLANE_CPU_GROUPS, "card": smi})
        if faults:
            raise AssertionError("dataplane: " + "; ".join(faults[:8]))
        del grads, entries, groups
    finally:
        hvd.shutdown()
        _free_cuda(torch)


ZERO_STATE = ("exp_avg", "exp_avg_sq", "step")


def phase_train_zero(torch, smi: str, trained: dict, dp: dict,
                     steps: int = 3) -> dict:
    """Two runs under ``Config(wire_precision="int8",
    sched_mode="decomposed")`` at one rank.  First train_dp's step again:
    the knobs are inert at one rank (losses bitwise equal to train_dp's,
    no schedule walked, no wire byte saved).  Then train's model, weights
    and batch through ``ZeroDistributedOptimizer`` around fused Adam: the
    flash launches of a step, the first loss bitwise equal to train's and
    the later ones within ``DP_LOSS_REL``, ``hvd_zero_state_bytes`` equal
    to Adam's state over the shard (padding included), step time and
    peak memory beside train_dp's."""
    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import reduction as R
    from horovod_tpu_torch.ops.sched import executor as SE
    from horovod_tpu_torch.optim import zero as Z

    _free_cuda(torch)
    hvd.init(config=hvd.Config(wire_precision="int8",
                               sched_mode="decomposed"))
    try:
        faults = []
        before = (SE._m_sched.total(), R._m_wire_saved.total())
        inert = _dp_steps(torch, hvd, steps)
        moved = (SE._m_sched.total() - before[0],
                 R._m_wire_saved.total() - before[1])
        inert_losses = inert["res"]["losses"]
        faults += inert["faults"]
        if inert_losses != dp["losses"]:
            faults.append(f"knobs not inert: losses {inert_losses} != "
                          f"train_dp's {dp['losses']}")
        if moved != (0, 0):
            faults.append(f"hvd_sched_dispatches_total and "
                          f"hvd_wire_bytes_saved_total moved by {moved}")
        inert_ms = inert["res"]["step_ms_median"]
        del inert
        _free_cuda(torch)

        cfg = llama.LlamaConfig.llama2_7b()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda")
        leaves = llama.trainable(params)
        opt = hvd.ZeroDistributedOptimizer(
            torch.optim.Adam(leaves, lr=TRAIN_LR, fused=True))
        step = llama.make_train_step(cfg, opt)
        tokens = np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(1, TRAIN_S + 1))
        batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        losses, step_s = [step(params, batch).item()], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(params, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss.item())
        counts = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_steps = steps + 1
        want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
                "flash_bwd_dkv": cfg.n_layers, "paged_decode": 0}
        if counts != {k: n_steps * v for k, v in want.items()}:
            faults.append(f"launches {counts}, want per step {want}")
        faults += _loss_faults(losses, trained["losses"])
        plan = opt.plan
        pieces = sum(len(p) for p in opt._pieces)
        padding = plan.padded - plan.numel
        # two moments of each bucket's dtype over its shard, padding
        # included, and fused Adam's float32 step counter a piece
        state_want = sum(2 * torch.empty((), dtype=b.dtype).element_size()
                         * b.shard for b in plan.buckets) + 4 * pieces
        gauge = Z._g_state_bytes.value
        keys = {k for st in opt.state.values() for k in st}
        if not (gauge == opt.state_bytes() == state_want
                and keys == set(ZERO_STATE)):
            faults.append(f"hvd_zero_state_bytes {gauge}, state "
                          f"{opt.state_bytes()} ({sorted(keys)}), want "
                          f"{state_want}")
        grads_in_buckets = all(
            any(f.data_ptr() <= t.grad.data_ptr()
                < f.data_ptr() + f.numel() * f.element_size()
                for f in opt._flat_g) for t in leaves)
        if not grads_in_buckets:
            faults.append("a gradient is not a view into a flat bucket")
        med = sorted(step_s)[len(step_s) // 2]
        res = {"phase": "train_zero", "model": "llama2_7b", "ranks": 1,
               "optimizer": f"ZeroDistributedOptimizer(Adam(lr={TRAIN_LR}, "
               "fused=True))", "config": {"wire_precision": "int8",
                                          "sched_mode": "decomposed"},
               "losses": losses, "step_s": step_s,
               "step_ms_median": med * 1e3,
               "train_dp_step_ms_median": dp["step_ms_median"],
               "step_vs_train_dp": med * 1e3 / dp["step_ms_median"],
               "peak_mem_gb": peak_gb,
               "train_dp_peak_mem_gb": dp["peak_mem_gb"],
               "buckets": len(plan.buckets), "pieces": pieces,
               "padding_elements": padding,
               "zero_state_bytes": gauge, "state_bytes_want": state_want,
               "launches": counts, "launches_per_step": want,
               "loss_rel_vs_train": _loss_rel(losses, trained["losses"]),
               "inert": {"losses": inert_losses,
                         "train_dp_losses": dp["losses"],
                         "step_ms_median": inert_ms,
                         "sched_dispatches": moved[0],
                         "wire_bytes_saved": moved[1]},
               "card": smi}
        emit(res)
        if faults:
            raise AssertionError("train_zero: " + "; ".join(faults))
        del params, leaves, opt, step, batch
        return res
    finally:
        hvd.shutdown()
        _free_cuda(torch)


# ---------------------------------------------------------------------------
# the data-parallel step as a job of the port's launcher (hvdrun)
# ---------------------------------------------------------------------------

HVDRUN_TIMEOUT_S = 420      # the launcher, its worker's 7B init and 4 steps
# hvdrun_obs: the plane's knobs.  The alert rule fires (no hold) once the
# time-series tier has two samples with collectives between them; the
# tuner scores every two busy cycles after one warm-up sample, so the
# 30-60 busy cycles a step give it several trials a step.
OBS_SLO = "cycle=p99(cycle) < 250ms over 5m"
OBS_ALERT = "busy"
OBS_ALERTS = f"{OBS_ALERT}: rate(hvd_collectives_total[10s]) > 0 : info"
OBS_ENV = {"HVDTPU_SLO": OBS_SLO, "HVDTPU_ALERTS": OBS_ALERTS,
           "HVDTPU_TSDB_INTERVAL": "0.5",
           "HVDTPU_AUTOTUNE_WARMUP_SAMPLES": "1",
           "HVDTPU_AUTOTUNE_STEPS_PER_SAMPLE": "2"}
OBS_SPAN = "hvdrun_obs.step"
OBS_DEVMEM_REL = 0.01       # the profiler's peak against torch's


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_worker(torch, root: Path, name: str, *, obs: bool = False
                   ) -> dict:
    """Run ``python -m horovod_tpu_torch.runner -np 1 -- python
    chip_smoke.py --hvdrun-worker OUT`` with ``HVDTPU_METRICS_PORT`` set
    (with ``obs``, also the launcher's ``--autotune --autotune-log``,
    ``OBS_ENV`` and the worker's ``--obs``), once this process has
    released the card (no runtime up, no live tensor of the train phases).
    The launcher must exit 0 and the worker write OUT; returns what it
    wrote with the launcher's wall seconds and this process's memory
    before the launch."""
    import os
    import shutil
    import signal
    import tempfile

    _free_cuda(torch)
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    allocated_gb = torch.cuda.memory_allocated() / 1e9
    print(f"{name}: this process holds {reserved_gb:.3f} GB reserved, "
          f"{allocated_gb:.3f} GB allocated before the launch",
          file=sys.stderr, flush=True)
    if reserved_gb > 1.0:
        raise AssertionError(f"{name}: this process still holds "
                             f"{reserved_gb:.1f} GB of the card; the worker "
                             "needs train_dp's 54 GB")
    tmp = Path(tempfile.mkdtemp(prefix=f"{name}-"))
    out = tmp / "worker.json"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    env["HVDTPU_METRICS_PORT"] = str(_free_port())
    flags = []
    if obs:
        env.update(OBS_ENV)
        flags = ["--autotune", "--autotune-log", str(tmp / "autotune.log")]
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "1",
           "--verbose", *flags, "--", sys.executable,
           str(Path(__file__).resolve()), "--hvdrun-worker", str(out),
           "--root", str(root), *(["--obs"] if obs else [])]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=str(root),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        text, _ = proc.communicate(timeout=HVDRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)     # the launcher ends its worker
        try:
            text, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
    wall_s = time.perf_counter() - t0
    sys.stderr.write(text)
    sys.stderr.flush()
    try:
        if proc.returncode != 0 or not out.is_file():
            raise AssertionError(f"{name}: the launcher exited "
                                 f"{proc.returncode}; its output ends\n"
                                 f"{text[-4000:]}")
        w = json.loads(out.read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    w.update(launcher_rc=proc.returncode, launcher_wall_s=wall_s,
             parent_memory_reserved_gb=reserved_gb,
             parent_memory_allocated_gb=allocated_gb)
    return w


_WORKER_KEYS = ("launcher_rc", "launcher_wall_s", "parent_memory_reserved_gb",
                "parent_memory_allocated_gb", "ranks", "backend", "device",
                "launcher_env", "kernels_reused", "losses", "step_s",
                "peak_mem_gb", "grad_leaves", "grad_bytes", "engine_per_step",
                "nccl_calls", "launches", "metrics")


def phase_hvdrun(torch, smi: str, trained: dict, dp: dict,
                 root: Path) -> float:
    """``python -m horovod_tpu_torch.runner -np 1 -- python chip_smoke.py
    --hvdrun-worker OUT`` with ``HVDTPU_METRICS_PORT`` set: the script is
    its own worker (:func:`hvdrun_worker`).  The launcher must exit 0, the
    worker's first loss must equal train's bitwise and the later ones be
    within ``DP_LOSS_REL``; its step median is printed beside train_dp's
    of this call, and returned."""
    w = _launch_worker(torch, root, "hvdrun")
    faults = w["faults"] + _loss_faults(w["losses"], trained["losses"])
    med = w["step_ms_median"]
    emit({"phase": "hvdrun", "model": "llama2_7b",
          "command": "python -m horovod_tpu_torch.runner -np 1 -- python "
          "chip_smoke.py --hvdrun-worker OUT",
          **{k: w[k] for k in _WORKER_KEYS},
          **_against_train(w, trained),
          "step_ms_median": med,
          "train_dp_step_ms_median": dp["step_ms_median"],
          "step_vs_train_dp": med / dp["step_ms_median"],
          "card": smi})
    if faults:
        raise AssertionError("hvdrun: " + "; ".join(faults))
    return med


def phase_hvdrun_obs(torch, smi: str, trained: dict, dp, hvdrun_ms,
                     root: Path) -> None:
    """The hvdrun job with the rest of the observability plane armed (the
    launcher's ``--autotune``, ``OBS_ENV``) and the worker's ``--obs``
    checks.  Every loss must equal train's bitwise: at one rank every
    knob the tuner tries hands each gradient back unchanged.  The step
    median is printed beside train_dp's and hvdrun's of this call; no
    time is asserted."""
    w = _launch_worker(torch, root, "hvdrun_obs", obs=True)
    faults = list(w["faults"])
    if w["losses"] != trained["losses"]:
        faults.append(f"losses {w['losses']} not bitwise equal to train's "
                      f"{trained['losses']}")
    med = w["step_ms_median"]
    emit({"phase": "hvdrun_obs", "model": "llama2_7b",
          "command": "python -m horovod_tpu_torch.runner -np 1 --autotune "
          "--autotune-log D/autotune.log -- python chip_smoke.py "
          "--hvdrun-worker OUT --obs",
          "env": OBS_ENV, **{k: w[k] for k in _WORKER_KEYS}, "obs": w["obs"],
          **_against_train(w, trained),
          "step_ms_median": med,
          "train_dp_step_ms_median": dp and dp["step_ms_median"],
          "hvdrun_step_ms_median": hvdrun_ms,
          "step_vs_train_dp": dp and med / dp["step_ms_median"],
          "step_vs_hvdrun": hvdrun_ms and med / hvdrun_ms,
          "card": smi})
    if faults:
        raise AssertionError("hvdrun_obs: " + "; ".join(faults))


def _settled_metrics(hvd) -> str:
    """``hvd.metrics("prometheus")`` once two reads 0.2 s apart agree: the
    engine's thread may still be closing the cycle that finished the last
    step (its cycle histogram), and then the registry is still."""
    text = hvd.metrics("prometheus")
    for _ in range(50):
        time.sleep(0.2)
        again = hvd.metrics("prometheus")
        if again == text:
            break
        text = again
    return text


def _metrics_plane_check(hvd, bundle_path: Path) -> tuple:
    """``/metrics`` byte-identical to ``hvd.metrics("prometheus")`` read
    just before it and just after it; ``cluster_metrics()``'s ``rank="0"``
    series of ``hvd_collectives_total`` equal to the registry's; a
    flight-recorder bundle that parses and names rank 0 of 1.  The
    sampling profiler counts its ticks into the registry ten times a
    second, so it pauses around the byte comparison; the time-series
    tier and the alert engine write on their own cadence, so a read
    during which the registry moved is taken again.  Returns (what was
    read, faults, the bundle)."""
    import urllib.request

    from horovod_tpu_torch.obs import prof

    faults = []
    srv = hvd.global_state().metrics_server
    if srv is None:
        return {}, ["HVDTPU_METRICS_PORT: init bound no endpoint"], {}
    prof.PROFILER.stop()
    try:
        for attempt in range(5):
            text = _settled_metrics(hvd)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics", timeout=30) as r:
                served = r.read().decode()
            if hvd.metrics("prometheus") == text:
                break
    finally:
        prof.PROFILER.start()
    if served != text:
        faults.append(f"/metrics ({len(served)} bytes) differs from "
                      f"hvd.metrics('prometheus') ({len(text)} bytes)")

    def collectives(snap, rank=None):
        [fam] = [f for f in snap if f["name"] == "hvd_collectives_total"]
        return {s["labels"]["verb"]: s["value"] for s in fam["samples"]
                if s["labels"].get("rank") == rank}

    cluster = collectives(hvd.cluster_metrics(), "0")
    own = collectives(hvd.metrics())
    if not cluster or cluster != own:
        faults.append(f"cluster_metrics rank 0 {cluster}, registry {own}")
    path = hvd.flight_record(str(bundle_path))
    bundle = json.loads(Path(path).read_text()) if path else {}
    if (bundle.get("rank"), bundle.get("size")) != (0, 1):
        faults.append(f"flight record {path}: rank {bundle.get('rank')} of "
                      f"{bundle.get('size')}")
    return {"endpoint_port": srv.port, "metrics_bytes": len(text),
            "metrics_equal_served": served == text,
            "metrics_reads": attempt + 1,
            "cluster_rank0_collectives": cluster,
            "flight_record_events": len(bundle.get("events", ()))}, \
        faults, bundle


def _family(snap: list, name: str) -> list:
    return next((f["samples"] for f in snap if f["name"] == name), [])


def _good_fraction(edges, cum, threshold: float) -> float:
    """Share of a histogram's observations at or under ``threshold``, by
    linear interpolation inside the bucket that holds it (the
    ``histogram_quantile`` convention; 1 on no observation, and what lies
    past the last finite edge counts as over)."""
    total = cum[-1]
    if total <= 0:
        return 1.0
    i = next((j for j, e in enumerate(edges) if e >= threshold), len(edges))
    if i == len(edges):
        good = cum[-2]
    elif edges[i] == threshold:
        good = cum[i]
    else:
        lo, below = (edges[i - 1], cum[i - 1]) if i else (0.0, 0)
        good = below + (cum[i] - below) * (threshold - lo) / (edges[i] - lo)
    return min(1.0, max(0.0, good / total))


def _autotune_check(hvd, log_path: Path) -> tuple:
    """Tuner trials happened, the log holds its samples, and every knob it
    committed, in the log and in the live config, is on its grid."""
    import re

    from horovod_tpu_torch.utils import autotune as AT

    faults = []
    trials = sum(s["value"] for s in _family(hvd.metrics(),
                                             "hvd_autotune_trials_total"))
    lines = log_path.read_text().splitlines() if log_path.is_file() else []
    commits = [tuple(m.groups()) for m in (re.search(
        r"threshold=(\d+) cycle_ms=([\d.]+) .* bucket=(\d+)", ln)
        for ln in lines if "-> next" in ln or "converged:" in ln) if m]
    cfg = hvd.global_state().config
    commits.append((cfg.fusion_threshold, cfg.cycle_time_ms,
                    cfg.bucket_bytes))
    off = [c for c in commits if int(c[0]) not in AT._THRESHOLDS
           or float(c[1]) not in AT._CYCLE_TIMES
           or int(c[2]) not in AT._BUCKET_BYTES]
    samples = sum("sample #" in ln for ln in lines)
    if trials <= 0 or samples <= 0:
        faults.append(f"autotune: {trials} trials, {samples} sample lines")
    if off:
        faults.append(f"autotune: knobs off the grid {off[:4]}")
    return {"trials": trials, "sample_lines": samples,
            "commits": len(commits) - 1,
            "converged": any("converged:" in ln for ln in lines),
            "final": list(commits[-1])}, faults


def _obs_plane_check(torch, hvd) -> tuple:
    """The plane this phase arms, read on the running worker before its
    metrics-plane check: the profiler (``/profz.json``, its device-memory
    poll against torch's peak), the alert rule on ``/alertz.json``, the
    step spans on ``/tracez``.  Returns (what was read, faults)."""
    import urllib.request

    from horovod_tpu_torch.obs import REGISTRY

    faults = []
    port = hvd.global_state().metrics_server.port

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return json.loads(r.read().decode())

    # The profiler polls every 20th tick (2 s at 10 Hz): wait for a poll
    # taken after the steps, whose peak is then torch's own.
    want = torch.cuda.max_memory_allocated(0)
    got = None
    for _ in range(30):
        fam = REGISTRY.get("hvd_prof_device_memory_bytes")
        got = fam and fam.labels(device="cuda:0",
                                 kind="peak_bytes_in_use").value
        if got == want:
            break
        time.sleep(0.2)
    if not got or abs(got - want) > OBS_DEVMEM_REL * want:
        faults.append(f"profiler peak device memory {got}, torch {want}")
    profz = get("/profz.json")
    phases = profz["engine_phases"]
    if profz["samples"] <= 0 or sum(phases.values()) <= 0:
        faults.append(f"/profz.json: {profz['samples']} samples, engine "
                      f"phases {phases}")
    alertz = get("/alertz.json")
    state = {a["alert"]: a for a in alertz["alerts"]}.get(OBS_ALERT, {})
    if state.get("state") != "firing":
        faults.append(f"/alertz.json: {alertz}")
    tracez = get("/tracez")
    steps = [e for e in tracez["traceEvents"]
             if e.get("name") == OBS_SPAN and e.get("pid") == 0]
    names = [e for e in tracez["traceEvents"] if e.get("ph") == "M"
             and e.get("name") == "process_name" and e.get("pid") == 0]
    if not steps or not names:
        faults.append(f"/tracez: {len(steps)} step spans on pid 0, "
                      f"process_name {names}")
    return {"profiler_samples": profz["samples"], "engine_phases": phases,
            "profiler_self_seconds": profz["self_seconds"],
            "devmem_peak_prof": got, "devmem_peak_torch": want,
            "alert": {k: state.get(k) for k in ("state", "value",
                                                "fired_total")},
            "tracez_events": len(tracez["traceEvents"]),
            "tracez_step_spans": len(steps)}, faults


def _obs_bundle_and_slo_check(hvd, bundle: dict) -> tuple:
    """After the metrics-plane check (the registry settled): the flight
    bundle carries the profiler's ring and the alert's transition; the SLO
    gauge equals the good fraction of the registry's cycle histogram
    (this process's whole run lies inside the SLO's 5 m window); the
    performance model took no observation at one rank."""
    from horovod_tpu_torch.obs import slo

    faults = []
    fired = [e for e in bundle.get("events", ())
             if e["kind"] == "alert_fired" and e["name"] == OBS_ALERT]
    profile = bundle.get("profile") or {}
    if not fired or not profile.get("ring"):
        faults.append(f"flight bundle: {len(fired)} alert_fired events, "
                      f"profile keys {sorted(profile)}")
    slo.status()                  # a fresh sample and evaluation
    snap = hvd.metrics()
    att = [s["value"] for s in _family(snap, "hvd_slo_attainment")
           if s["labels"] == {"slo": "cycle"}]
    [hist] = [f for f in snap if f["name"] == "hvd_cycle_seconds"]
    edges = [b for b, _ in hist["samples"][0]["buckets"]][:-1]
    cum = [sum(s["buckets"][i][1] for s in hist["samples"])
           for i in range(len(edges) + 1)]
    want = _good_fraction(edges, cum, 0.25)
    if len(att) != 1 or abs(att[0] - want) > 1e-9:
        faults.append(f"hvd_slo_attainment{{slo=\"cycle\"}} {att}, good "
                      f"fraction of hvd_cycle_seconds {want}")
    perf = sum(s["value"] for s in _family(snap,
                                           "hvd_perf_observations_total"))
    if perf != 0:
        faults.append(f"{perf} performance-model observations at one rank")
    return {"slo_attainment": att, "slo_good_fraction": want,
            "cycles": cum[-1], "alert_fired_events": len(fired),
            "profile_ring": len(profile.get("ring", ())),
            "perf_observations": perf}, faults


def hvdrun_worker(torch, out: Path, steps: int = 3,
                  obs: bool = False) -> int:
    """The worker of the hvdrun phases, run by the port's launcher: the
    launcher's env, the kernels the parent built (no rebuild), ``hvd.init``
    over NCCL on cuda:0, train_dp's model, weights, batch, optimizer and
    checks, then the metrics plane; with ``obs`` each step inside a trace
    span and the rest of the plane checked too.  Writes what it found to
    ``out`` and exits non-zero on any fault."""
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as FA

    faults = []
    env = ("HVDTPU_SECRET", "HVDTPU_CONTROLLER_ADDR",
           "HVDTPU_RENDEZVOUS_ADDR")
    missing = [k for k in env if not os.environ.get(k)]
    if missing:
        faults.append(f"the launcher's env lacks {missing}")
    built = {lib: _build._target(lib)[1] for lib in KERNEL_LIBS}
    reused = all(so.is_file() for so in built.values())
    if not reused:
        faults.append(f"kernels not built by the parent: {built}")
    for lib in KERNEL_LIBS:
        _build.load(lib, FA._SIGNATURES[lib])
    hvd.init()
    try:
        if obs and not hvd.global_state().config.autotune:
            faults.append("--autotune did not reach the worker")
        run = _dp_steps(torch, hvd, steps, span=OBS_SPAN if obs else "")
        res = run["res"]
        faults += run["faults"]       # the parent holds the losses
        if obs:
            plane, ofaults = _obs_plane_check(torch, hvd)
            faults += ofaults
        metrics, mfaults, bundle = _metrics_plane_check(
            hvd, out.parent / "flight.json")
        faults += mfaults
        if obs:
            more, ofaults = _obs_bundle_and_slo_check(hvd, bundle)
            tuned, tfaults = _autotune_check(
                hvd, Path(hvd.global_state().config.autotune_log))
            faults += ofaults + tfaults
            res["obs"] = {**plane, **more, "autotune": tuned}
        res.update(device=str(hvd.global_state().device),
                   launcher_env=[k for k in env if k not in missing],
                   kernels_reused=reused, metrics=metrics, faults=faults)
        del run
    finally:
        hvd.shutdown()
    out.write_text(json.dumps(res))
    print(f"hvdrun worker: {len(faults)} fault(s)", flush=True)
    return 1 if faults else 0


# ---------------------------------------------------------------------------
# elastic: a 7B-width job killed, blacklisted, relaunched and resumed; the
# in-process recovery path
# ---------------------------------------------------------------------------

ELASTIC_LAYERS = 4          # Llama-2-7B's width, depth cut to 4 layers
ELASTIC_STEPS = 6
ELASTIC_CKPT_EVERY = 2      # a checkpoint after every second step
# The job runs with fusion off, so every step is exactly one allreduce
# dispatch a trainable leaf (9 a layer and 3 more) after one broadcast a
# leaf at start: the death lands in step ELASTIC_DIE_STEP, at its
# ELASTIC_DIE_AT-th gradient, past the checkpoint of step 4.
ELASTIC_DIE_STEP = 4
ELASTIC_DIE_AT = 20
# The in-process path: a dispatch error in step ELASTIC_ERR_STEP, then,
# once recovered, another in the step after it (so a leak a reinit would
# show twice).
ELASTIC_ERR_STEP = 2
ELASTIC_MEM_REL = 0.01      # device memory after each reinit against before
ELASTIC_TIMEOUT_S = 600


def _elastic_leaves() -> int:
    return 9 * ELASTIC_LAYERS + 3


def _elastic_model(torch, hvd):
    """Train's model at Llama-2-7B width and ELASTIC_LAYERS layers, its
    seed and batch, stepped through ``DistributedOptimizer`` over fused
    Adam on the initialized runtime."""
    import dataclasses

    import numpy as np

    from horovod_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(),
                              n_layers=ELASTIC_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, "cuda")
    named = llama.named_trainable(params)
    hvd.broadcast_parameters(named, root_rank=0)
    adam = torch.optim.Adam([t for _, t in named], lr=TRAIN_LR, fused=True)
    opt = hvd.DistributedOptimizer(adam, named_parameters=named)
    step = llama.make_train_step(cfg, opt)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(1, TRAIN_S + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    return {"cfg": cfg, "params": params, "named": named, "adam": adam,
            "opt": opt, "step": step, "batch": batch}


def _elastic_per_step(cfg) -> dict:
    return {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "paged_decode": 0}


def elastic_worker(torch, work: Path) -> int:
    """The elastic phase's worker, run by the port's elastic driver: the
    kernels the parent built, ``hvd.init`` over NCCL, ``_elastic_model``,
    a ``FileBackedState`` committed each step and a ``Checkpointer`` of
    the parameters, Adam's state and the step every ELASTIC_CKPT_EVERY
    steps; a start restores the latest checkpoint.  Appends one JSON
    record a line to ``work/log.jsonl``."""
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import FileBackedState
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.utils.checkpoint import Checkpointer, tree_bytes

    def log(**rec):
        with open(work / "log.jsonl", "a") as f:
            f.write(json.dumps({"t_unix": time.time(), **rec}) + "\n")

    t_start = time.time()
    for lib in KERNEL_LIBS:
        _build.load(lib, FA._SIGNATURES[lib])
    hvd.init()
    try:
        m = _elastic_model(torch, hvd)
        params, adam = m["params"], m["adam"]
        ckpt = Checkpointer(str(work / "ckpt"), max_to_keep=1)
        state = FileBackedState(str(work / "state.json"), step=0)
        file_step = state.step
        start = 0
        if ckpt.latest_step() is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree = ckpt.restore(target={"params": params})
            with torch.no_grad():
                for k, v in tree["params"]["layers"].items():
                    params["layers"][k].copy_(v)
                for k in ("embed", "final_norm", "lm_head"):
                    params[k].copy_(tree["params"][k])
            adam.load_state_dict(tree["adam"])
            torch.cuda.synchronize()
            start = int(tree["step"])
            log(kind="restore", step=start, s=time.perf_counter() - t0,
                bytes=tree_bytes(tree))
            del tree
        state.step = start
        log(kind="start", resume_step=start, file_state_step=file_step,
            pid=os.getpid(), t_process=t_start,
            elastic_env=os.environ.get("HVDTPU_ELASTIC"))
        zero_launches()

        @hvd.elastic.run
        def train(state):
            for i in range(state.step, ELASTIC_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = m["step"](params, m["batch"]).item()
                log(kind="step", step=i, loss=loss.hex(),
                    step_s=time.perf_counter() - t0,
                    launches=read_launches())
                if (i + 1) % ELASTIC_CKPT_EVERY == 0:
                    tree = {"params": params, "adam": adam.state_dict(),
                            "step": i + 1}
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ckpt.save(i + 1, tree)
                    log(kind="save", step=i + 1,
                        s=time.perf_counter() - t0, bytes=tree_bytes(tree))
                state.step = i + 1
                state.commit()

        train(state)
        ckpt.close()
        log(kind="done", step=state.step)
    finally:
        hvd.shutdown()
    return 0


def _elastic_measure(torch, leaves) -> dict:
    """Device memory with the gradients dropped (the next step's
    ``zero_grad`` would drop them) and the caches emptied."""
    for t in leaves:
        t.grad = None
    _free_cuda(torch)
    free, total = torch.cuda.mem_get_info()
    return {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "device_used_gb": (total - free) / 1e9,
            # the CUDA context, NCCL's buffers and anything else the
            # caching allocator does not hold
            "outside_allocator_gb": (total - free
                                     - torch.cuda.memory_reserved()) / 1e9}


def _elastic_job(torch, root: Path, work: Path) -> tuple:
    """The launched job: the driver's output and the worker's records."""
    import os
    import signal

    disc = work / "discover.sh"
    disc.write_text("#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n")
    disc.chmod(0o755)
    latch = work / "die.latch"
    after = _elastic_leaves() * (1 + ELASTIC_DIE_STEP) + ELASTIC_DIE_AT
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env.update({
        "PYTHONPATH": str(root) + os.pathsep + env.get("PYTHONPATH", ""),
        "HVDTPU_FAULTS": f"dispatch:rank=0:die:after={after}:once={latch}",
        "HVDTPU_FLIGHT_RECORDER_DIR": str(work / "flightrec"),
        "HVDTPU_FUSION_THRESHOLD": "0",
        "HVDTPU_LOG_LEVEL": "info"})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "1",
           "--min-np", "1", "--max-np", "1", "--host-discovery-script",
           str(disc), "--verbose", "--", sys.executable,
           str(Path(__file__).resolve()), "--elastic-worker", str(work),
           "--root", str(root)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=str(root),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        text, _ = proc.communicate(timeout=ELASTIC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        try:
            text, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
    wall_s = time.perf_counter() - t0
    sys.stderr.write(text[-20000:])
    sys.stderr.flush()
    log = work / "log.jsonl"
    recs = ([json.loads(x) for x in log.read_text().splitlines()]
            if log.is_file() else [])
    return proc.returncode, text, wall_s, recs, after


def phase_elastic(torch, smi: str, root: Path) -> None:
    """The elastic job (``python -m horovod_tpu_torch.runner
    --host-discovery-script D --min-np 1 --max-np 1``, D printing
    ``localhost:1`` and ``127.0.0.1:1``) killed by an injected death,
    blacklisted and relaunched on the other "host", resumed from its
    checkpoint; then the in-process path: a ``dispatch:err`` under
    ``hvd.elastic.run`` re-initializes NCCL in this process and
    ``TorchState`` restores.  Every loss of both against an uninterrupted
    run in this process, bitwise."""
    import glob
    import os
    import shutil

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.elastic import TorchState
    from horovod_tpu_torch.elastic import runner as elastic_runner

    _free_cuda(torch)
    if torch.cuda.memory_reserved() > 1e9:
        raise AssertionError("elastic: this process still holds "
                             f"{torch.cuda.memory_reserved() / 1e9:.1f} GB")
    work = root / "build" / f"elastic-{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    faults = []
    try:
        rc, text, wall_s, recs, after = _elastic_job(torch, root, work)
        if rc != 0:
            raise AssertionError(f"elastic: the launcher exited {rc}; its "
                                 f"output ends\n{text[-4000:]}")
        launches_on = [ln.split("launching on ", 1)[1] for ln in
                       text.splitlines() if "elastic: launching on " in ln]
        starts = [r for r in recs if r["kind"] == "start"]
        steps = [r for r in recs if r["kind"] == "step"]
        saves = [r for r in recs if r["kind"] == "save"]
        restores = [r for r in recs if r["kind"] == "restore"]
        bundles = glob.glob(str(work / "flightrec" /
                                "flightrec-rank0-*-injected_death-*.json"))
        if len(launches_on) != 2 or len(starts) != 2 or \
                "localhost" not in launches_on[0] or \
                "localhost" in launches_on[1] or \
                "127.0.0.1" not in launches_on[1]:
            faults.append(f"want one relaunch on 127.0.0.1: launches "
                          f"{launches_on}, starts {len(starts)}")
        if "elastic: blacklisted host localhost" not in text:
            faults.append("the dead host was not blacklisted")
        if len(starts) == 2 and not starts[1]["resume_step"] > 0:
            faults.append(f"the relaunch resumed at {starts[1]}")
        death = None
        if not bundles:
            faults.append("no injected_death flight bundle")
        else:
            b = json.loads(Path(bundles[0]).read_text())
            death = b["t_unix"]
            if b["extra"]["site"] != "dispatch" or \
                    "die" not in b["extra"]["rule"]:
                faults.append(f"the bundle names {b['extra']}")
        job_losses = {r["step"]: float.fromhex(r["loss"]) for r in steps}

        # the uninterrupted run, then the in-process recovery path
        hvd.init(config=hvd.Config(fusion_threshold=0))
        try:
            m = _elastic_model(torch, hvd)
            per_step = _elastic_per_step(m["cfg"])
            zero_launches()
            ref, ref_ms = [], []
            for _ in range(ELASTIC_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref.append(m["step"](m["params"], m["batch"]).item())
                ref_ms.append((time.perf_counter() - t0) * 1e3)
            if read_launches() != {k: ELASTIC_STEPS * v
                                   for k, v in per_step.items()}:
                faults.append(f"uninterrupted launches {read_launches()}")
            del m
            _free_cuda(torch)
            if [job_losses.get(i) for i in range(ELASTIC_STEPS)] != ref:
                faults.append(f"job losses {job_losses} != uninterrupted "
                              f"{ref}")

            m = _elastic_model(torch, hvd)
            leaves = [t for _, t in m["named"]]
            state = TorchState(optimizer=m["opt"], params=m["params"],
                               step=0)
            got, step_ms, mem, times = {}, {}, {}, {}
            real_reinit = elastic_runner._reinitialize

            def timed_reinit():
                t0 = time.perf_counter()
                real_reinit()
                times.setdefault("reinit_s", []).append(
                    time.perf_counter() - t0)
                engines.append(hvd.global_state().engine)

            resets = []

            def on_reset():
                resets.append(time.perf_counter())
                mem[f"after_reinit{len(resets)}"] = _elastic_measure(
                    torch, leaves)
                if len(resets) == 1:     # the next error, a step later
                    chaos.arm(f"dispatch:err:after="
                              f"{_elastic_leaves() + ELASTIC_DIE_AT}"
                              ":times=1")
            state.register_reset_callbacks([on_reset])
            commit_s = []

            @hvd.elastic.run
            def train(state):
                for i in range(state.step, ELASTIC_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    try:
                        got[i] = m["step"](m["params"], m["batch"]).item()
                    except hvd.HorovodInternalError:
                        fails.append(time.perf_counter())
                        raise
                    step_ms.setdefault(i, []).append(
                        (time.perf_counter() - t0) * 1e3)
                    state.step = i + 1
                    t0 = time.perf_counter()
                    state.commit()
                    commit_s.append(time.perf_counter() - t0)
                    if i == ELASTIC_ERR_STEP - 1 and "before" not in mem:
                        mem["before"] = _elastic_measure(torch, leaves)
                        engines.append(hvd.global_state().engine)

            engines, fails = [], []
            elastic_runner._reinitialize = timed_reinit
            zero_launches()
            chaos.arm(f"dispatch:err:after="
                      f"{_elastic_leaves() * ELASTIC_ERR_STEP + ELASTIC_DIE_AT}"
                      ":times=1")
            try:
                train(state)
            finally:
                chaos.disarm()
                elastic_runner._reinitialize = real_reinit
            in_process_launches = read_launches()
            # two steps ran twice: each failed one and its retry
            if in_process_launches != {k: (ELASTIC_STEPS + 2) * v
                                       for k, v in per_step.items()}:
                faults.append(f"in-process launches {in_process_launches}")
            if [got.get(i) for i in range(ELASTIC_STEPS)] != ref:
                faults.append(f"in-process losses {got} != {ref}")
            if len(times.get("reinit_s", [])) != 2 or len(resets) != 2 or \
                    len({id(e) for e in engines}) != 3:
                faults.append(f"want two reinits, each a new engine: "
                              f"{times}, {len(resets)} resets")
            for label in ("after_reinit1", "after_reinit2"):
                for key in ("allocated_gb", "device_used_gb"):
                    a, b = mem["before"][key], mem[label][key]
                    if abs(b - a) > ELASTIC_MEM_REL * a:
                        faults.append(f"{key} {a} before the reinits, "
                                      f"{b} {label}")
            del m, state, leaves
        finally:
            hvd.shutdown()
            _free_cuda(torch)

        first_after = [r for r in steps if starts and len(starts) == 2
                       and r["t_unix"] > starts[1]["t_unix"]]
        relaunch = starts[1] if len(starts) == 2 else None
        save_gb = [r["bytes"] / 1e9 for r in saves]
        emit({"phase": "elastic", "model": "llama2_7b", "layers":
              ELASTIC_LAYERS, "depth_cut_from": 32, "seq": TRAIN_S,
              "command": "python -m horovod_tpu_torch.runner -np 1 "
              "--min-np 1 --max-np 1 --host-discovery-script D -- python "
              "chip_smoke.py --elastic-worker W",
              "faults_spec": f"dispatch:rank=0:die:after={after}:once=L",
              "launcher_rc": rc, "launcher_wall_s": wall_s,
              "launches_on": launches_on,
              "resume_step": relaunch and relaunch["resume_step"],
              "job_losses": [job_losses.get(i)
                             for i in range(ELASTIC_STEPS)],
              "uninterrupted_losses": ref,
              "uninterrupted_step_ms": ref_ms,
              "time_to_recover_s": (first_after[0]["t_unix"] - death
                                    if death and first_after else None),
              "death_to_relaunch_start_s": (relaunch["t_unix"] - death
                                            if death and relaunch
                                            else None),
              "death_to_relaunch_process_s": (relaunch["t_process"] - death
                                              if death and relaunch
                                              else None),
              "checkpoint": {
                  "gb": save_gb[0] if save_gb else None,
                  "save_s": [r["s"] for r in saves],
                  "save_gb_per_s": [r["bytes"] / 1e9 / r["s"]
                                    for r in saves],
                  "restore_s": [r["s"] for r in restores],
                  "restore_gb_per_s": [r["bytes"] / 1e9 / r["s"]
                                       for r in restores]},
              "job_step_ms": {r["step"]: r["step_s"] * 1e3 for r in steps},
              "job_launches": [r["launches"] for r in steps],
              "in_process": {
                  "losses": [got.get(i) for i in range(ELASTIC_STEPS)],
                  "step_ms": step_ms,
                  "reinit_s": times.get("reinit_s"),
                  "failure_to_retry_s": [b - a for a, b in
                                         zip(fails, resets)],
                  "commit_s": commit_s,
                  "memory": mem,
                  "launches": in_process_launches},
              "card": smi})
        if faults:
            raise AssertionError("elastic: " + "; ".join(faults[:8]))
    finally:
        shutil.rmtree(work, ignore_errors=True)


# Tolerance of train_parity.  Both runs are bf16; the kernels round p and
# ds to bf16 before each product, as the Pallas kernels do, the plain
# versions keep them in fp32, so every attention output and gradient
# differs by a few bf16 ulps (2^-8 relative) and the weight gradients that
# sum them by about that.  A wrong block, head or mask moves a leaf by
# order 1.
# ---------------------------------------------------------------------------
# Switch-MoE training at Llama-2-7B width, and the hierarchy's one-rank gate
# ---------------------------------------------------------------------------

MOE_LAYERS = 4          # Llama-2-7B's width, depth cut to 4 layers
MOE_EXPERTS = 8
# Adam's first steps move every weight by about lr.  At train's 1e-3 the
# fp32 router's logits move by up to D * lr = 4 a step, and on one
# repeated batch the routing collapsed onto one expert by the third step
# (3,448 of 4,096 tokens a layer dropped, aux 7.9 a layer of at most 8)
# and the fourth loss rose above the first (H100 run, PR 12).  At 1e-4 a
# step moves a logit by 0.4 at most, and an update still survives bf16
# rounding of a weight near 1/64 (its spacing is 6.1e-5).
MOE_LR = 1e-4
MOE_OUT_REL = 1e-4      # the fp32 layer on the card against the CPU's
MOE_CATEGORIES = ("flash", "experts", "dispatch_combine", "router",
                  "projections_lm_head", "adam", "elementwise_other")


def _moe_flops(cfg, T: int) -> dict:
    """Model FLOPs of one step, by product: under per-layer recompute a
    layer's products run four times (forward, recompute, two backward
    products), the lm_head three; attention at bench.py's 12 L D S a
    token (forward and backward)."""
    from horovod_tpu_torch.parallel.moe import capacity_of
    L, D, F, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    C = capacity_of(T, E, cfg.capacity_factor)
    return {"experts": 3 * 2 * E * C * D * F * 4 * L,
            "dispatch_combine": 2 * 2 * T * E * C * D * 4 * L,
            "projections": 4 * 2 * T * D * D * 4 * L,
            "router": 2 * T * D * E * 4 * L,
            "attention": 12 * L * D * T * T,
            "lm_head": 2 * T * D * cfg.vocab_size * 3}


def _moe_category(op: str, shapes, cfg, C: int) -> str:
    """The product a CPU-side op's kernels belong to, by its input shapes:
    the expert products carry d_ff, dispatch and combine the E x C slot
    dim, the router's products E as a matrix dim."""
    dims = {d for s in shapes or () for d in s}
    if cfg.d_ff in dims and cfg.n_experts in dims:
        return "experts"
    if cfg.n_experts * C in dims:
        return "dispatch_combine"
    gemm = op in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
    if gemm and any(len(s) == 2 and cfg.n_experts in s
                    for s in shapes or ()):
        return "router"
    if gemm:
        return "projections_lm_head"
    return "elementwise_other"


def moe_breakdown(torch, step, params, batch, cfg, wall_ms: float,
                  smi: str) -> dict:
    """Device ms of one MoE step by product: the flash kernels and fused
    Adam by kernel name, every other kernel by the CPU-side op that
    launched it (:func:`_moe_category`)."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.parallel.moe import capacity_of
    C = capacity_of(TRAIN_S, cfg.n_experts, cfg.capacity_factor)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ms = dict.fromkeys(MOE_CATEGORIES, 0.0)
    for e in kernels:
        if "flash_" in e.key:
            ms["flash"] += e.self_device_time_total / 1e3
        elif "Adam" in e.key:
            ms["adam"] += e.self_device_time_total / 1e3
    attributed = 0.0
    for ev in prof.events():
        if ev.device_type.name != "CPU" or not ev.kernels:
            continue
        for k in ev.kernels:
            if "flash_" in k.name or "Adam" in k.name:
                continue
            cat = _moe_category(ev.name, ev.input_shapes, cfg, C)
            ms[cat] += k.duration / 1e3
            attributed += k.duration / 1e3
    # kernels no CPU-side op claimed go with the elementwise rest
    ms["elementwise_other"] += max(
        0.0, device_ms - ms["flash"] - ms["adam"] - attributed)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    res = {"phase": "train_moe_breakdown", "wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms if kernels else "not measured",
           "device_idle_share": (1 - device_ms / wall_ms) if kernels
           else "not measured",
           "ms_per_step": ms if kernels else "not measured",
           "top_kernels_ms_per_step": {
               e.key[:80]: e.self_device_time_total / 1e3 for e in top},
           "card": smi}
    emit(res)
    return res


def _switch_routing(x, lp, cfg):
    """The routing ``_moe_mlp`` takes on ``x``: each token's expert, the
    dropped mask and the top-2 logit gap."""
    from horovod_tpu_torch.parallel.moe import capacity_of, switch_route
    flat = x.reshape(-1, x.shape[-1])
    logits = flat.float() @ lp["router"].float()
    cap = capacity_of(flat.shape[0], cfg.n_experts, cfg.capacity_factor)
    _, _, _, dropped = switch_route(logits, cap)
    top2 = logits.topk(2, dim=-1).values
    return logits.argmax(-1), dropped, top2[:, 0] - top2[:, 1]


def moe_mlp_parity(torch, llama, params, cfg) -> dict:
    """Layer 0's MoE MLP in fp32 at full width on 4096 tokens, on the card
    (TF32 off) and on the CPU: the same expert for every token, the same
    drops, outputs within ``MOE_OUT_REL`` of the largest.  A token routed
    differently has its top-2 logit gap printed."""
    import dataclasses
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    lp = {k: params["layers"][k][0].float()
          for k in ("router", "w_gate", "w_up", "w_down")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x = torch.randn(1, TRAIN_S, cfg.d_model, generator=gen, device="cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            out_g, aux_g = llama._moe_mlp(x, lp, cfg32)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            route_g = _switch_routing(x, lp, cfg32)
            lp_c = {k: v.cpu() for k, v in lp.items()}
            t0 = time.perf_counter()
            out_c, aux_c = llama._moe_mlp(x.cpu(), lp_c, cfg32)
            cpu_s = time.perf_counter() - t0
            route_c = _switch_routing(x.cpu(), lp_c, cfg32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    flips = (route_g[0].cpu() != route_c[0]).nonzero()[:, 0].tolist()
    drops_differ = int((route_g[1].cpu() != route_c[1]).sum())
    rel = ((out_g.cpu() - out_c).abs().max()
           / out_c.abs().max().clamp_min(1e-30)).item()
    res = {"tokens": TRAIN_S, "dtype": "float32", "tf32": False,
           "routing_flips": len(flips),
           "flip_top2_gaps": [route_c[2][t].item() for t in flips[:16]],
           "dropped_card": int(route_g[1].sum()),
           "dropped_cpu": int(route_c[1].sum()),
           "drops_differ": drops_differ, "out_rel_err": rel,
           "out_rel_tol": MOE_OUT_REL,
           "aux_card": aux_g.item(), "aux_cpu": aux_c.item(),
           "smallest_top2_gap": route_c[2].min().item(),
           "card_s": card_s, "cpu_s": cpu_s}
    if flips or drops_differ or not rel <= MOE_OUT_REL:
        emit({"phase": "train_moe_mlp_parity", **res})
        raise AssertionError(f"train_moe: the fp32 MoE layer on the card "
                             f"against the CPU: {res}")
    return res


def _moe_routing(torch, llama, moe, params, batch, cfg) -> dict:
    """One forward without gradients on the batch: each layer's dropped
    tokens (a spy on ``switch_route``, which ``_moe_mlp`` looks up at each
    call) and the aux loss summed over layers."""
    seen = []
    real = moe.switch_route

    def spy(logits, capacity):
        out = real(logits, capacity)
        seen.append(int(out[3].sum()))
        return out

    moe.switch_route = spy
    try:
        with torch.no_grad():
            _, aux = llama.forward(params, batch["tokens"][:, :-1], cfg)
    finally:
        moe.switch_route = real
    return {"dropped": seen, "aux": aux.item()}


def phase_train_moe(torch, smi: str, steps: int = 3) -> dict:
    """Llama-2-7B at full width as a Switch-MoE of 8 experts, depth cut
    to 4 layers, bf16, per-layer recompute, one sequence of 4096 tokens a
    step, fused Adam: one warm-up and ``steps`` timed steps.  Every
    counter is zeroed just before and read just after: 8/4/4 flash
    launches a step (forward and recompute), ``paged_decode`` never; the
    drop counter untouched (the model path records no drops, as in the
    JAX package); the losses finite, starting near ln V and falling.
    Then the routing of the last weights (drops a layer, aux), the
    profile by product and the fp32 layer's card-against-CPU check."""
    import numpy as np

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import moe

    _free_cuda(torch)
    cfg = llama.LlamaConfig.llama2_7b(use_moe=True, n_experts=MOE_EXPERTS,
                                      n_layers=MOE_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, "cuda")
    n_params = sum(t.numel() for t in llama.trainable(params))
    opt = torch.optim.Adam(llama.trainable(params), lr=MOE_LR, fused=True)
    step = llama.make_train_step(cfg, opt)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(1, TRAIN_S + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    first_routing = _moe_routing(torch, llama, moe, params, batch, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dropped0 = moe._m_dropped.total()

    zero_launches()                            # every counter of the path
    losses, step_s = [step(params, batch).item()], []   # warm-up step
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counted_drops = moe._m_dropped.total() - dropped0

    last_routing = _moe_routing(torch, llama, moe, params, batch, cfg)

    n_steps = steps + 1
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "paged_decode": 0}
    med = sorted(step_s)[len(step_s) // 2]
    flops = _moe_flops(cfg, TRAIN_S)
    res = {"phase": "train_moe", "model": "llama2_7b", "moe": True,
           "experts": cfg.n_experts, "capacity_factor": cfg.capacity_factor,
           "capacity": moe.capacity_of(TRAIN_S, cfg.n_experts,
                                       cfg.capacity_factor),
           "layers": cfg.n_layers, "reduced": "n_layers 32 -> 4",
           "dtype": "bfloat16", "remat": cfg.remat, "batch": 1,
           "seq": TRAIN_S, "optimizer": f"Adam(lr={MOE_LR}, fused=True)",
           "params": n_params, "losses": losses, "step_s": step_s,
           "step_ms_median": med * 1e3, "tokens_per_s": TRAIN_S / med,
           "model_tflop_per_step": {k: v / 1e12 for k, v in flops.items()},
           "mfu": sum(flops.values()) / med / BF16_FLOPS,
           "routing_at_first_weights": first_routing,
           "routing_at_last_weights": last_routing,
           "drop_counter_delta": counted_drops,
           "launches": counts, "launches_per_step": want,
           "peak_mem_gb": peak_gb, "card": smi}
    emit(res)
    if counts != {k: n_steps * v for k, v in want.items()}:
        raise AssertionError(f"train_moe: launches over {n_steps} steps "
                             f"{counts}; want per step {want}")
    ln_v = math.log(cfg.vocab_size)
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[0] - ln_v) <= 2
            and all(x < losses[0] for x in losses[1:])):
        raise AssertionError(f"train_moe: losses {losses}: want finite, the "
                             f"first within 2 of ln V = {ln_v}, then below")
    if counted_drops != 0 or len(last_routing["dropped"]) != cfg.n_layers:
        raise AssertionError(f"train_moe: the model path counted "
                             f"{counted_drops} drops; routed "
                             f"{len(last_routing['dropped'])} layers")
    moe_breakdown(torch, step, params, batch, cfg, med * 1e3, smi)
    del opt, step, batch
    _free_cuda(torch)
    parity = moe_mlp_parity(torch, llama, params, cfg)
    emit({"phase": "train_moe_mlp_parity", **parity, "card": smi})
    del params
    _free_cuda(torch)
    return res


def phase_hier(torch, smi: str) -> None:
    """The hierarchy's one-rank gate over NCCL: ``init`` accepts the
    hierarchical knobs; at one rank no split is valid, so no tier group
    is made, a 16 MB allreduce and the 7B gradient set (291 tensors fused
    as the DP step fuses them) come back bitwise whole and no tiered
    dispatch or two-tier route runs; the rank mesh builds with every
    axis of size 1 on the card."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import hierarchical as H
    from horovod_tpu_torch.ops.sched import executor
    from horovod_tpu_torch.parallel import AXES, MeshConfig, build_mesh

    _free_cuda(torch)
    knobs = dict(hierarchical_allreduce=True, hierarchical_local_size=2,
                 hierarchical_cross_precision="int8")
    hvd.init(config=hvd.Config(**knobs))
    routes = [0]
    real = H.hierarchical_allreduce_

    def counting(*a, **kw):
        routes[0] += 1
        return real(*a, **kw)

    H.hierarchical_allreduce_ = counting
    try:
        state = hvd.global_state()
        cfg = state.config
        faults = [f"{k}={getattr(cfg, k)!r}" for k, v in knobs.items()
                  if getattr(cfg, k) != v]
        sched0 = executor._m_sched.total()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        x = torch.randn(4 << 20, generator=gen, device="cuda")
        want = x.clone()
        t0 = time.perf_counter()
        got = hvd.allreduce(x, name="hier.16mb")
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(_bits(got), _bits(want)):
            faults.append("16 MB allreduce changed")
        grads = _grad_set(torch, llama, llama.LlamaConfig.llama2_7b())
        copies = [g.clone() for _, g in grads]
        eng = state.engine
        eng.pause()
        hs = [hvd.allreduce_async_(g, hvd.Average, name=f"hier.{n}")
              for n, g in grads]
        eng.resume()
        for h in hs:
            hvd.synchronize(h)
        torch.cuda.synchronize()
        changed = sum(not torch.equal(_bits(g), _bits(c))
                      for (_, g), c in zip(grads, copies))
        if changed:
            faults.append(f"{changed} gradients changed")
        mesh = build_mesh(MeshConfig())
        res = {"phase": "hier", "ranks": state.size, "backend": state.backend,
               "knobs": {k: getattr(cfg, k) for k in knobs},
               "split": C._hier_split(None),
               "tier_groups": len(state.tier_groups),
               "allreduce_16mb_ms": one_ms,
               "grad_tensors": len(grads),
               "grad_bytes": sum(g.numel() * g.element_size()
                                 for _, g in grads),
               "hier_dispatches": executor._m_sched.total() - sched0,
               "two_tier_routes": routes[0],
               "mesh_axes": list(mesh.mesh_dim_names),
               "mesh_shape": list(mesh.mesh.shape),
               "mesh_device_type": mesh.device_type, "card": smi}
        emit(res)
        if (res["split"] is not None or res["tier_groups"]
                or res["hier_dispatches"] or routes[0]
                or res["mesh_axes"] != list(AXES)
                or res["mesh_shape"] != [1] * len(AXES)
                or mesh.device_type != "cuda"):
            faults.append("the one-rank gate let a tier through")
        if faults:
            raise AssertionError("hier: " + "; ".join(faults))
        del grads, copies, hs, x, want, got
    finally:
        H.hierarchical_allreduce_ = real
        hvd.shutdown()
        _free_cuda(torch)


# Every collective and point-to-point call of torch.distributed: the
# train_mesh phase counts them while its steps run (none may).
DIST_CALLS = ("all_reduce", "all_gather", "all_gather_into_tensor",
              "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
              "all_to_all_single", "broadcast", "reduce", "gather",
              "scatter", "barrier", "batch_isend_irecv", "isend", "irecv",
              "send", "recv", "all_gather_object", "broadcast_object_list")


def _count_dist_calls(dist, calls: dict) -> dict:
    """Wrap every ``torch.distributed`` call of :data:`DIST_CALLS`,
    counting into ``calls``; returns the real functions."""
    real = {n: getattr(dist, n) for n in DIST_CALLS if hasattr(dist, n)}

    def counting(name):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*a, **kw)
        return call

    for name in real:
        setattr(dist, name, counting(name))
    return real


def phase_train_mesh(torch, smi: str, trained: dict, steps: int = 3) -> dict:
    """train's step through the mesh path at one rank: the same weights
    (``init_params(mesh=)`` against the unsharded draw), the same losses,
    no collective, the same kernels."""
    import numpy as np
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import AXES, MeshConfig, build_mesh

    _free_cuda(torch)
    hvd.init()
    real: dict = {}
    try:
        mesh = build_mesh(MeshConfig())
        cfg = llama.LlamaConfig.llama2_7b()            # bf16, remat=True
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        t0 = time.perf_counter()
        params = llama.init_params(cfg, gen, "cuda", mesh=mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen.manual_seed(0)
        plain = llama.init_params(cfg, gen, "cuda")
        unequal = [k for k in plain["layers"] if not torch.equal(
            plain["layers"][k], params["layers"][k])]
        unequal += [k for k in ("embed", "final_norm", "lm_head")
                    if not torch.equal(plain[k], params[k])]
        del plain
        _free_cuda(torch)
        opt = torch.optim.Adam(llama.trainable(params), lr=TRAIN_LR,
                               fused=True)
        step = llama.make_train_step(cfg, opt, mesh=mesh)
        tokens = np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(1, TRAIN_S + 1))
        batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
        calls: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        real = _count_dist_calls(dist, calls)
        zero_launches()                        # every counter of the path
        losses, step_s = [step(params, batch).item()], []  # warm-up step
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(params, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss.item())
        counts = read_launches()
        for name, fn in real.items():
            setattr(dist, name, fn)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_steps = steps + 1
        want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
                "flash_bwd_dkv": cfg.n_layers, "paged_decode": 0}
        med = sorted(step_s)[len(step_s) // 2]
        tok_s = TRAIN_S / med
        res = {"phase": "train_mesh", "model": "llama2_7b",
               "mesh_axes": list(mesh.mesh_dim_names),
               "mesh_shape": list(mesh.mesh.shape),
               "mesh_device_type": mesh.device_type,
               "init_s": init_s, "weights_unequal": unequal,
               "collectives": calls, "losses": losses,
               "train_losses": trained["losses"],
               "losses_bitwise_train": losses == trained["losses"],
               "loss_rel_vs_train": _loss_rel(losses, trained["losses"]),
               "loss_rel_tol": DP_LOSS_REL, "step_s": step_s,
               "step_ms_median": med * 1e3,
               "train_step_ms_median": trained["step_ms_median"],
               "step_vs_train": med * 1e3 / trained["step_ms_median"],
               "tokens_per_s": tok_s,
               "train_tokens_per_s": trained["tokens_per_s"],
               "mfu": tok_s * trained["flops_per_token"] / BF16_FLOPS,
               "train_mfu": trained["mfu"], "peak_mem_gb": peak_gb,
               "train_peak_mem_gb": trained["peak_mem_gb"],
               "launches": counts, "launches_per_step": want, "card": smi}
        emit(res)
        faults = _loss_faults(losses, trained["losses"])
        if unequal:
            faults.append(f"weights unequal to the unsharded draw: {unequal}")
        if calls:
            faults.append(f"collectives at one rank: {calls}")
        if counts != {k: n_steps * v for k, v in want.items()}:
            faults.append(f"launches over {n_steps} steps: {counts}; want "
                          f"per step {want}")
        if (res["mesh_axes"] != list(AXES)
                or res["mesh_shape"] != [1] * len(AXES)
                or mesh.device_type != "cuda"):
            faults.append(f"mesh {res['mesh_axes']} {res['mesh_shape']} on "
                          f"{mesh.device_type}")
        if faults:
            raise AssertionError("train_mesh: " + "; ".join(faults))
        del params, opt, step, batch
        return res
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
        hvd.shutdown()
        _free_cuda(torch)


PARITY_LOSS_REL = 1e-2
PARITY_GRAD_REL_L2 = 5e-2


def phase_train_parity(torch, smi: str) -> None:
    import dataclasses

    import numpy as np

    from horovod_tpu_torch.models import llama

    _free_cuda(torch)
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = llama.init_params(cfg, gen, "cuda")
    leaves = llama.trainable(params)
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(1, TRAIN_S + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}

    def run(plain: bool):
        for t in leaves:
            t.grad = None
        old = llama._FORCE_ATTENTION_REFERENCE
        llama._FORCE_ATTENTION_REFERENCE = plain
        zero_launches()
        try:
            loss = llama.loss_fn(params, batch, cfg)
            loss.backward()
        finally:
            llama._FORCE_ATTENTION_REFERENCE = old
        torch.cuda.synchronize()
        return loss.item(), [t.grad.float() for t in leaves], read_launches()

    k_loss, k_grads, k_counts = run(False)
    p_loss, p_grads, p_counts = run(True)
    if not (k_counts["flash_fwd"] == 2 * cfg.n_layers
            and k_counts["flash_bwd_dkv"] == cfg.n_layers
            and sum(p_counts.values()) == 0):
        raise AssertionError(f"launches through the kernels {k_counts}, "
                             f"through the plain versions {p_counts}")
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(k_grads, p_grads)]
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    emit({"phase": "train_parity", "layers": cfg.n_layers, "seq": TRAIN_S,
          "loss_kernel": k_loss, "loss_plain": p_loss, "loss_rel": loss_rel,
          "loss_rel_tol": PARITY_LOSS_REL, "grad_leaves": len(rel),
          "grad_rel_l2_max": max(rel), "grad_rel_l2_median":
          sorted(rel)[len(rel) // 2], "grad_rel_l2_tol": PARITY_GRAD_REL_L2,
          "card": smi})
    if not (loss_rel <= PARITY_LOSS_REL and max(rel) <= PARITY_GRAD_REL_L2
            and all(math.isfinite(r) for r in rel)):
        raise AssertionError(f"kernel vs plain training step: loss rel "
                             f"{loss_rel}, worst gradient rel L2 {max(rel)}")
    del params, leaves, k_grads, p_grads
    _free_cuda(torch)


# ---------------------------------------------------------------------------
# the pipeline on one card, and sharded serving at one rank
# ---------------------------------------------------------------------------

TRAIN_PP_STAGES = 2     # layers 0-15 and 16-31
TRAIN_PP_B = 4          # rows a step
TRAIN_PP_M = 4          # microbatches of one row
TRAIN_PP_S = 4096       # 2048 where the peak would pass TRAIN_PP_PEAK_GB
TRAIN_PP_PEAK_GB = 75.0


class _FirstGrads:
    """The optimizer of a run: at its first ``step()`` the gradients are
    copied to the host (``against`` None) or held against ``against``'s,
    leaf by leaf on the card (relative L2), then it steps."""

    def __init__(self, opt, leaves, against=None):
        self.opt, self.leaves, self.against = opt, leaves, against
        self.grads = self.rel = None

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        if self.grads is None and self.rel is None:
            if self.against is None:
                self.grads = [p.grad.to("cpu", copy=True)
                              for p in self.leaves]
            else:
                self.rel = []
                for p, b in zip(self.leaves, self.against):
                    a, b = p.grad.float(), b.to(p.device).float()
                    self.rel.append(((a - b).norm()
                                     / b.norm().clamp_min(1e-30)).item())
        self.opt.step()


def _train_pp_run(torch, llama, cfg, batch, make_step, steps: int,
                  smi: str, path: str, against=None) -> dict:
    """train's weights (seed 0) stepped ``steps + 1`` times by
    ``make_step(optimizer)``'s step, the first untimed, then one more
    under the profiler (:func:`train_breakdown`, tagged ``path``)."""
    _free_cuda(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, "cuda")
    leaves = llama.trainable(params)
    opt = _FirstGrads(torch.optim.Adam(leaves, lr=TRAIN_LR, fused=True),
                      leaves, against)
    step = make_step(opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                            # every counter of the path
    losses, step_s = [step(params, batch).item()], []   # warm-up step
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    out = {"losses": losses, "step_s": step_s,
           "step_ms_median": sorted(step_s)[len(step_s) // 2] * 1e3,
           "launches": read_launches(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "grads": opt.grads, "grad_rel": opt.rel}
    train_breakdown(torch, step, params, batch, out["step_ms_median"], smi,
                    path=path)
    del params, leaves, opt, step
    _free_cuda(torch)
    return out


def pp_launches(cfg, M: int, pp: int) -> dict:
    """Flash launches of one 1F1B step of the one-process driver: a stage
    but the last runs each microbatch's forward without autograd, then
    its recompute under autograd and the per-layer recompute of the
    backward (3 forwards a layer); the last stage runs the forward under
    autograd once, then the backward's recompute (2 forwards a layer);
    one dq and one dkv a layer and microbatch."""
    lp = cfg.n_layers // pp
    return {"flash_fwd": M * (3 * lp * (pp - 1) + 2 * lp),
            "flash_bwd_dq": M * cfg.n_layers,
            "flash_bwd_dkv": M * cfg.n_layers, "paged_decode": 0}


def phase_train_pp(torch, smi: str, steps: int = 3) -> dict:
    """Llama-2-7B at full width as two pipeline stages on one card: the
    one-process driver (``llama.make_pipeline_step_local``, every stage
    in this process, the handoffs in memory) on the 1F1B schedule, beside
    the pp=1 mesh step on the same batch and weights.  On one card the
    stages run one after the other: this measures the schedule's
    recompute and bookkeeping, never a pipelining speed-up."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh

    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(),
                              pp_microbatches=TRAIN_PP_M)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(TRAIN_PP_B, TRAIN_PP_S + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    _free_cuda(torch)
    hvd.init()
    calls: dict = {}
    real: dict = {}
    try:
        mesh = build_mesh(MeshConfig())
        real = _count_dist_calls(dist, calls)
        base = _train_pp_run(torch, llama, cfg, batch,
                             lambda opt: llama.make_train_step(
                                 cfg, opt, mesh=mesh), steps, smi,
                             "train_pp.pp1")
        piped = _train_pp_run(torch, llama, cfg, batch,
                              lambda opt: llama.make_pipeline_step_local(
                                  cfg, opt, TRAIN_PP_STAGES),
                              steps, smi, "train_pp.1f1b",
                              against=base.pop("grads"))
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
        hvd.shutdown()
    n_steps = steps + 1
    want_base = {"flash_fwd": 2 * cfg.n_layers,
                 "flash_bwd_dq": cfg.n_layers,
                 "flash_bwd_dkv": cfg.n_layers, "paged_decode": 0}
    want = pp_launches(cfg, TRAIN_PP_M, TRAIN_PP_STAGES)
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd = (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim
    n_params = 2 * cfg.vocab_size * D + D + L * (2 * D + 2 * D * hd
                                                 + 3 * D * F)
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.d_model \
        * TRAIN_PP_S
    tok = TRAIN_PP_B * TRAIN_PP_S

    def rate(ms):
        return tok / (ms / 1e3)

    rel = piped.pop("grad_rel")
    piped.pop("grads")
    base.pop("grad_rel")
    res = {"phase": "train_pp", "model": "llama2_7b", "dtype": "bfloat16",
           "remat": cfg.remat, "stages": TRAIN_PP_STAGES,
           "layers_per_stage": cfg.n_layers // TRAIN_PP_STAGES,
           "schedule": "1f1b", "driver": "one process, handoffs in memory",
           "batch": TRAIN_PP_B, "microbatches": TRAIN_PP_M,
           "seq": TRAIN_PP_S, "collectives": calls,
           "losses": piped["losses"], "pp1_losses": base["losses"],
           "loss_rel_vs_pp1": _loss_rel(piped["losses"], base["losses"]),
           "first_loss_rel_vs_pp1": abs(piped["losses"][0]
                                        - base["losses"][0])
           / abs(base["losses"][0]),
           "loss_rel_tol": DP_LOSS_REL,
           "grad_rel_l2_max": max(rel),
           "grad_rel_l2_median": sorted(rel)[len(rel) // 2],
           "grad_rel_l2_tol": PARITY_GRAD_REL_L2,
           "step_s": piped["step_s"], "pp1_step_s": base["step_s"],
           "step_ms_median": piped["step_ms_median"],
           "pp1_step_ms_median": base["step_ms_median"],
           "step_vs_pp1": piped["step_ms_median"] / base["step_ms_median"],
           "tokens_per_s": rate(piped["step_ms_median"]),
           "pp1_tokens_per_s": rate(base["step_ms_median"]),
           "mfu": rate(piped["step_ms_median"]) * flops_per_token
           / BF16_FLOPS,
           "pp1_mfu": rate(base["step_ms_median"]) * flops_per_token
           / BF16_FLOPS,
           "flops_per_token": flops_per_token,
           "peak_mem_gb": piped["peak_mem_gb"],
           "pp1_peak_mem_gb": base["peak_mem_gb"],
           "launches": piped["launches"], "launches_per_step": want,
           "pp1_launches": base["launches"],
           "pp1_launches_per_step": want_base, "card": smi}
    emit(res)
    faults = []
    if calls:
        faults.append(f"torch.distributed calls: {calls}")
    for name, run, per in (("pp", piped, want), ("pp=1", base, want_base)):
        if run["launches"] != {k: n_steps * v for k, v in per.items()}:
            faults.append(f"{name} launches over {n_steps} steps: "
                          f"{run['launches']}; want per step {per}")
    losses = piped["losses"]
    if not (all(math.isfinite(x) for x in losses + rel)
            and res["first_loss_rel_vs_pp1"] <= DP_LOSS_REL
            and max(res["loss_rel_vs_pp1"]) <= DP_LOSS_REL
            and losses[-1] < losses[0]):
        faults.append(f"losses {losses} against pp=1's {base['losses']}")
    if max(rel) > PARITY_GRAD_REL_L2:
        faults.append(f"first gradients: worst rel L2 {max(rel)}")
    if piped["peak_mem_gb"] > TRAIN_PP_PEAK_GB:
        faults.append(f"peak {piped['peak_mem_gb']} GB at S={TRAIN_PP_S}")
    if faults:
        raise AssertionError("train_pp: " + "; ".join(faults))
    return res


SERVE_MESH_GEN = dict(B=2, P=128, new=16)


def phase_serve_mesh(torch, smi: str, served: dict) -> dict:
    """``serve(mesh=)`` and ``generate(mesh=)`` on a one-rank mesh at
    Llama-2-7B width (serve's weights and requests): bitwise serve's and
    the plain ``generate``'s tokens, ``paged_decode`` 32 times a decode
    tick, no ``torch.distributed`` call.  Its latency is held against
    the plain ``serve()`` session's under the same ``hvd.init()``, the
    two timed in turn (plain, mesh, mesh, plain): the serve phase runs
    with no runtime, so its numbers alone would not isolate ``mesh=``."""
    import numpy as np
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh

    _free_cuda(torch)
    cfg = llama.LlamaConfig.llama2_7b()
    hvd.init()
    calls: dict = {}
    real = {}
    runs: dict = {"plain": [], "mesh": []}
    try:
        mesh = build_mesh(MeshConfig())
        real = _count_dist_calls(dist, calls)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda", mesh=mesh)
        sessions = {kind: serving.serve(params, cfg, num_blocks=512,
                                        max_active=8, block_size=16, **kw)
                    for kind, kw in (("plain", {}),
                                     ("mesh", {"mesh": mesh}))}
        rng = np.random.RandomState(0)
        for sess in sessions.values():
            warm = sess.submit(rng.randint(0, cfg.vocab_size, size=(16,)), 2)
            sess.drain()
            assert len(warm.result().tokens) == 2
        for kind in ("plain", "mesh", "mesh", "plain"):
            runs[kind].append(_serve_timed(torch, sessions[kind],
                                           served["prompts"], 32))
        for sess in sessions.values():
            sess.close()
        g = SERVE_MESH_GEN
        prompt = torch.from_numpy(np.random.RandomState(2).randint(
            0, cfg.vocab_size, size=(g["B"], g["P"]))).to("cuda")
        t0 = time.perf_counter()
        meshed = llama.generate(params, prompt, cfg,
                                max_new_tokens=g["new"], mesh=mesh)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        plain = llama.generate(params, prompt, cfg, max_new_tokens=g["new"])
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
        hvd.shutdown()
    results, counts, ticks, timing = runs["mesh"][0]
    tokens = {kind: [[list(r.tokens) for r in run[0]] for run in rs]
              for kind, rs in runs.items()}
    m = served["metrics"]
    keys = ("wall_s", "ttft_p50_s", "ttft_max_s", "itl_p50_s", "itl_p99_s",
            "decode_tokens_per_s")

    def mean(kind, k):
        return sum(run[3][k] for run in runs[kind]) / len(runs[kind])

    res = {"phase": "serve_mesh", "model": "llama2_7b",
           "mesh_shape": list(mesh.mesh.shape), "requests": len(results),
           "max_tokens": 32, "decode_ticks": ticks,
           "paged_decode_launches": counts["paged_decode"],
           "tokens_bitwise_serve": all(t == served["tokens"]
                                       for ts in tokens.values()
                                       for t in ts),
           **timing,
           "order": ["plain", "mesh", "mesh", "plain"],
           "mesh_runs": [run[3] for run in runs["mesh"]],
           "plain_under_init_runs": [run[3] for run in runs["plain"]],
           **{f"{k}_vs_plain_under_init": mean("mesh", k) / mean("plain", k)
              for k in ("ttft_p50_s", "itl_p50_s", "decode_tokens_per_s")},
           **{f"serve_{k}": m[k] for k in keys},
           "generate": {**g, "s": gen_s,
                        "bitwise_plain": bool(torch.equal(meshed, plain))},
           "collectives": calls, "card": smi}
    emit(res)
    faults = []
    if not res["tokens_bitwise_serve"]:
        faults.append("tokens differ from serve's")
    for kind, rs in runs.items():
        for _, c, n_ticks, _ in rs:
            if c["paged_decode"] != n_ticks * cfg.n_layers or n_ticks == 0:
                faults.append(f"{kind}: paged_decode {c['paged_decode']} "
                              f"over {n_ticks} ticks; want {cfg.n_layers} "
                              f"a tick")
            if any(c[n] for n in c if n != "paged_decode"):
                faults.append(f"{kind}: serving launched a training "
                              f"kernel: {c}")
    if not res["generate"]["bitwise_plain"]:
        faults.append("generate(mesh=) differs from generate")
    if calls:
        faults.append(f"torch.distributed calls: {calls}")
    del params, sessions
    _free_cuda(torch)
    if faults:
        raise AssertionError("serve_mesh: " + "; ".join(faults))
    return {"counts": counts, "metrics": res}


# ---------------------------------------------------------------------------
# the model zoo: ResNet-50, BERT-Large and DLRM trained at one rank
# ---------------------------------------------------------------------------

FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
ZOO_STEPS = 3
# check_tol: the first forward's logits on the card against the fp32
# model's on the CPU with the same weights and inputs, max |card - cpu|
# over max |cpu|; each about four times the H100's reading (7.27e-3
# ResNet-50, 5.34e-3 BERT-Large, both bf16; 2.04e-6 DLRM, fp32 both with
# TF32 off).
# check_scale: every block's last norm for the check (at its initial 0
# no 3x3 convolution reaches the logits: tests/test_torch_models.py,
# test_resnet50_card_check_reaches_every_convolution).  Not 1: under the
# batch statistics of 4 images the freshly drawn network is then chaotic,
# and bf16 rounding alone moves its logits by a large share.
RESNET = dict(batch=128, image=224, classes=1000, lr=0.1, momentum=0.9,
              check_batch=4, check_scale=0.2, check_tol=2.0 ** -5)
BERT = dict(batch=16, seq=512, lr=1e-4, check_batch=2, check_seq=128,
            check_tol=2e-2)
# MLPerf's DLRM (Criteo 1TB): 13 dense features, 26 tables of 128-wide
# embeddings, its bottom and top MLPs; 500k rows a table.
DLRM_MLPERF = dict(n_dense=13, n_sparse=26, vocab_per_table=500_000,
                   embed_dim=128, bottom_mlp=(512, 256, 128),
                   top_mlp=(1024, 1024, 512, 256, 1))
# lr 1e-4: at 1e-3 Adam's first step (every weight moved by about lr)
# overshot at the 1024-wide top MLP and the second loss rose.
DLRM = dict(batch=32768, lr=1e-4, check_batch=256, check_tol=1e-5)


def _zoo_steps(torch, step) -> dict:
    """One warm-up and ``ZOO_STEPS`` timed steps of ``step()`` (which
    returns the loss), every kernel counter zeroed just before and read
    just after; the peak device memory of the run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, step_s = [], []
    for i in range(ZOO_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        if i:
            step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    med = sorted(step_s)[len(step_s) // 2]
    return {"losses": losses, "step_s": step_s, "step_ms_median": med * 1e3,
            "launches": read_launches(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _logits_check(card, cpu, tol: float) -> dict:
    err = (card.float().cpu() - cpu).abs().max().item()
    ref = cpu.abs().max().item()
    return {"max_abs_err": err, "max_abs_ref": ref, "rel": err / ref,
            "tol": tol}


def _zoo_faults(run: dict) -> list:
    """No ported kernel launched (the JAX package computes these models
    outside any Pallas kernel), the losses finite and falling, the card's
    first logits within their tolerance of the CPU's, and (DLRM) three
    ``all_to_all_single`` a step."""
    faults = []
    if any(run["launches"].values()):
        faults.append(f"kernel launches {run['launches']}, want none")
    losses = run["losses"]
    if not (all(math.isfinite(x) for x in losses)
            and all(x < losses[0] for x in losses[1:])):
        faults.append(f"losses {losses}: want finite and below the first")
    chk = run["first_logits"]
    if not chk["rel"] <= chk["tol"]:
        faults.append(f"first logits on the card against the CPU's: max "
                      f"abs err {chk['max_abs_err']!r} over max |cpu| "
                      f"{chk['max_abs_ref']!r} = {chk['rel']} > "
                      f"{chk['tol']}")
    if "dist_calls" in run:
        a2a = run["dist_calls"].get("all_to_all_single", 0)
        if a2a != 3 * (ZOO_STEPS + 1):
            faults.append(f"{a2a} all_to_all_single calls, want 3 a step "
                          f"(the two exchanges forward, the embeddings' "
                          f"back)")
    return faults


def _zoo_phase(torch, smi: str, label: str, run_fn, extra: dict) -> dict:
    """``run_fn(torch, hvd)`` under ``hvd.init()`` at one rank (NCCL):
    its line (``extra`` first), one more step under the profiler
    (``train_breakdown``), then its faults, which fail the run."""
    import horovod_tpu_torch as hvd

    _free_cuda(torch)
    hvd.init()
    try:
        run = run_fn(torch, hvd)
        step = run.pop("step")
        res = {**extra, **run, "card": smi}
        emit(res)
        train_breakdown(torch, lambda *_: step(), None, None,
                        run["step_ms_median"], smi, path=label)
    finally:
        hvd.shutdown()
        _free_cuda(torch)
    faults = _zoo_faults(run)
    if faults:
        raise AssertionError(f"{label}: " + "; ".join(faults))
    return res


def resnet_run(torch, hvd) -> dict:
    """ResNet-50 at ``RESNET``'s batch and image size, SGD with momentum
    through ``DistributedOptimizer``.  The check: the logits of
    ``check_batch`` images on the device against the fp32 model's on the
    CPU with the same weights (batch statistics both), with every
    block's last norm at ``check_scale`` instead of its initial 0, so
    that every convolution reaches the logits; training then starts from
    the initial weights."""
    import numpy as np
    import torch.nn.functional as F

    from horovod_tpu_torch.models import resnet

    c = RESNET
    dev = hvd.global_state().device
    gen = torch.Generator(device=dev).manual_seed(0)
    model = resnet.resnet50(num_classes=c["classes"], device=dev,
                            generator=gen)
    model = model.to(memory_format=torch.channels_last)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(c["batch"], c["image"], c["image"], 3)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, c["classes"],
                                     size=(c["batch"],))).to(dev)
    start = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    cb = c["check_batch"]
    model.train()
    with torch.no_grad():
        for block in model.blocks:
            block.bn2.scale.fill_(c["check_scale"])
        weights = {k: v.detach().cpu().clone()
                   for k, v in model.state_dict().items()}
        card = model(x[:cb])
    model.load_state_dict(start)    # the initial weights and statistics
    cpu = resnet.resnet50(num_classes=c["classes"], dtype=torch.float32,
                          device="meta")
    cpu.load_state_dict(weights, assign=True)
    cpu.train()
    with torch.no_grad():
        check = _logits_check(card, cpu(x[:cb].cpu()), c["check_tol"])
    del cpu, start, weights, card

    named = list(model.named_parameters())
    hvd.broadcast_parameters(named, root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=c["lr"],
                        momentum=c["momentum"]), named_parameters=named)

    def step():
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss

    run = _zoo_steps(torch, step)
    macs = resnet.forward_macs(model, c["image"])
    ips = c["batch"] / (run["step_ms_median"] / 1e3)
    flops_per_image = 3 * 2 * macs
    return {**run, "step": step, "params": sum(p.numel() for _, p in named),
            "forward_macs_per_image": macs,
            "flops_per_image": flops_per_image, "images_per_s": ips,
            "mfu": ips * flops_per_image / BF16_FLOPS,
            "first_logits": check}


def phase_train_resnet(torch, smi: str) -> dict:
    """ResNet-50 (bf16 convolutions, flax's fp32 batch norm) on 224x224x3,
    batch 128, 1000 classes."""
    return _zoo_phase(torch, smi, "train_resnet", resnet_run, {
        "phase": "train_resnet", "model": "resnet50",
        "dtype": "bfloat16 convolutions, fp32 norms and head",
        "batch": RESNET["batch"], "image": RESNET["image"],
        "optimizer": f"DistributedOptimizer(SGD(lr={RESNET['lr']}, "
                     f"momentum={RESNET['momentum']}))"})


def bert_run(torch, hvd) -> dict:
    """BERT-Large on ``BERT``'s synthetic MLM batch (15% masked), fused
    Adam through ``DistributedOptimizer``; the check: the logits of a
    small batch on the device against the fp32 model's on the CPU."""
    import dataclasses

    from horovod_tpu_torch.models import bert

    c = BERT
    cfg = bert.BertConfig.bert_large()
    dev = hvd.global_state().device
    gen = torch.Generator(device=dev).manual_seed(0)
    model = bert.Bert(cfg, device=dev, generator=gen)
    batch = bert.synthetic_mlm_batch(cfg, c["batch"], c["seq"], seed=0,
                                     device=dev)
    small = bert.synthetic_mlm_batch(cfg, c["check_batch"], c["check_seq"],
                                     seed=1, device=dev)["tokens"]
    with torch.no_grad():
        card = model(small)
    cpu = bert.Bert(dataclasses.replace(cfg, dtype=torch.float32),
                    device="meta")
    cpu.load_state_dict({k: v.detach().cpu() for k, v in
                         model.state_dict().items()}, assign=True)
    with torch.no_grad():
        check = _logits_check(card, cpu(small.cpu()), c["check_tol"])
    del cpu, card

    named = list(model.named_parameters())
    hvd.broadcast_parameters(named, root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([p for _, p in named], lr=c["lr"], fused=True),
        named_parameters=named)

    def step():
        opt.zero_grad()
        loss = bert.mlm_loss(model, batch)
        loss.backward()
        opt.step()
        return loss

    run = _zoo_steps(torch, step)
    n = sum(p.numel() for _, p in named)
    # 6 N a token for the products of the parameters (the tied head's
    # included), 12 L d S for the attention's two products, forward and
    # backward.
    flops_per_token = 6 * n + 12 * cfg.n_layers * cfg.d_model * c["seq"]
    tok_s = c["batch"] * c["seq"] / (run["step_ms_median"] / 1e3)
    masked = int((batch["labels"] >= 0).sum())
    return {**run, "step": step, "params": n, "masked_tokens": masked,
            "flops_per_token": flops_per_token, "tokens_per_s": tok_s,
            "mfu": tok_s * flops_per_token / BF16_FLOPS,
            "first_logits": check}


def phase_train_bert(torch, smi: str) -> dict:
    """BERT-Large (``BertConfig.bert_large()``: bf16 compute, fp32
    parameters), S=512, B=16, MLM at 15%, fused Adam."""
    return _zoo_phase(torch, smi, "train_bert", bert_run, {
        "phase": "train_bert", "model": "bert_large",
        "dtype": "bfloat16 compute, fp32 params and norms",
        "batch": BERT["batch"], "seq": BERT["seq"],
        "optimizer": f"DistributedOptimizer(Adam(lr={BERT['lr']}, "
                     f"fused=True))"})


def dlrm_run(torch, hvd, cfg) -> dict:
    """DLRM at ``cfg`` on ``DLRM``'s synthetic batch: the dense half
    through ``DistributedOptimizer``, the rank's tables stepped by their
    own fused Adam (a dense, table-shaped gradient, so every row is
    updated), the lookup's two exchanges over a group of its own, every
    ``all_to_all_single`` counted.  The check: the logits of a small
    batch on the device against the CPU's, with the rows that batch
    reads."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from horovod_tpu_torch.models import dlrm

    c = DLRM
    dev = hvd.global_state().device
    # The exchange's group is a new one (the engine issues the dense
    # gradients' allreduces on the world group from its own thread); the
    # CPU's check runs over Gloo.
    group = dist.new_group(list(range(hvd.size())))
    cpu_group = dist.new_group(list(range(hvd.size())), backend="gloo")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = dlrm.DlrmDense(cfg, device=dev, generator=gen)
    tables = torch.nn.Parameter(dlrm.init_embedding_tables(cfg, gen, dev))
    batch = dlrm.synthetic_batch(cfg, c["batch"], seed=0, device=dev)

    def logits_of(m, t, b, g):
        return m(b["dense"], dlrm.sharded_embedding_lookup_local(
            t, b["sparse"], group=g))

    cb = c["check_batch"]
    small = {k: v[:cb] for k, v in batch.items()}
    with torch.no_grad():
        card = logits_of(model, tables, small, group)
        # the rows the small batch reads: sample j reads row j of every
        # table of the CPU's copy
        rows = tables[torch.arange(cfg.n_sparse, device=dev)[:, None],
                      small["sparse"].long().t()].cpu()
    cpu = dlrm.DlrmDense(cfg, device="meta")
    cpu.load_state_dict({k: v.detach().cpu() for k, v in
                         model.state_dict().items()}, assign=True)
    cpu_small = {k: v.cpu() for k, v in small.items()}
    cpu_small["sparse"] = torch.arange(cb, dtype=torch.int32)[:, None] \
        .expand(cb, cfg.n_sparse).contiguous()
    with torch.no_grad():
        check = _logits_check(card, logits_of(cpu, rows, cpu_small,
                                              cpu_group),
                              c["check_tol"])
    del cpu, rows, card

    named = list(model.named_parameters())
    hvd.broadcast_parameters(named, root_rank=0)
    dense_opt = hvd.DistributedOptimizer(
        torch.optim.Adam([p for _, p in named], lr=c["lr"], fused=True),
        named_parameters=named)
    table_opt = torch.optim.Adam([tables], lr=c["lr"], fused=True)
    table_ms = []

    def step():
        dense_opt.zero_grad()
        table_opt.zero_grad()
        loss = F.binary_cross_entropy_with_logits(
            logits_of(model, tables, batch, group), batch["label"])
        loss.backward()
        if hvd.size() > 1:                  # the loss is the ranks' mean
            tables.grad.div_(hvd.size())
        dense_opt.step()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        table_opt.step()
        t1.record()
        t1.synchronize()
        table_ms.append(t0.elapsed_time(t1))
        return loss

    calls: dict = {}
    real = _count_dist_calls(dist, calls)
    try:
        run = _zoo_steps(torch, step)
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    T, D = cfg.n_sparse, cfg.embed_dim
    mlp_macs = 0
    for sizes, fan_in in ((cfg.bottom_mlp, cfg.n_dense),
                          (cfg.top_mlp, D + T * (T + 1) // 2)):
        for n_out in sizes:
            mlp_macs += fan_in * n_out
            fan_in = n_out
    flops_per_sample = 3 * 2 * (mlp_macs + (T + 1) ** 2 * D)
    sps = c["batch"] / (run["step_ms_median"] / 1e3)
    table_bytes = tables.numel() * tables.element_size()
    # A step's traffic over the tables: the dense gradient's zero fill
    # (the gather's backward) and fused Adam's reads of the parameter,
    # gradient and both moments and its writes of the parameter and
    # moments.
    traffic = (1 + 4 + 3) * table_bytes
    return {**run, "step": step,
            "dense_params": sum(p.numel() for _, p in named),
            "table_params": tables.numel(), "table_gb": table_bytes / 1e9,
            "dist_calls": calls,
            "flops_per_sample": flops_per_sample, "samples_per_s": sps,
            "mfu_fp32": sps * flops_per_sample / FP32_FLOPS,
            "table_traffic_gb_per_step": traffic / 1e9,
            "table_traffic_bound_ms": traffic / HBM_BYTES_PER_S * 1e3,
            "table_adam_ms": table_ms,
            "first_logits": check}


def phase_train_dlrm(torch, smi: str) -> list:
    """DLRM: first the JAX package's ``DlrmConfig()``, then MLPerf's
    widths with 500k rows a table (6.66 GB of fp32 tables), batch
    32,768, Adam."""
    import dataclasses

    from horovod_tpu_torch.models import dlrm

    out = []
    for name, cfg in (("reference", dlrm.DlrmConfig()),
                      ("mlperf", dataclasses.replace(dlrm.DlrmConfig(),
                                                     **DLRM_MLPERF))):
        out.append(_zoo_phase(
            torch, smi, f"train_dlrm.{name}",
            lambda torch, hvd, cfg=cfg: dlrm_run(torch, hvd, cfg), {
                "phase": "train_dlrm", "config": name,
                "widths": {k: getattr(cfg, k) for k in DLRM_MLPERF},
                "batch": DLRM["batch"],
                "optimizer": f"DistributedOptimizer(Adam(lr={DLRM['lr']}, "
                             f"fused=True)), tables: Adam"}))
    return out


# ---------------------------------------------------------------------------
# the estimator: TorchEstimator fitting the MNIST ConvNet at one rank
# ---------------------------------------------------------------------------

# BASELINE.json's config 1 (the MNIST ConvNet at its published widths)
# fitted as upstream's examples/spark/pytorch/pytorch_spark_mnist.py does:
# 60,000 rows of 784 features, global batch 128, Adam 1e-3, 3 epochs.
# check_tol: TorchModel.predict's logits on the card against a CPU fp32
# copy of the fitted weights, max |card - cpu| over max |cpu|; 2^-7 with
# cuDNN's TF32 convolutions on (PyTorch's default: a 10-bit mantissa on
# the 400- and 800-term conv sums), 1e-5 with them off.
ESTIMATOR = dict(rows=60_000, batch=128, epochs=3, lr=1e-3, check_rows=1024,
                 check_tol_tf32=2.0 ** -7, check_tol=1e-5, profile_steps=20)


def estimator_data(seed: int, rows: int) -> dict:
    """``rows`` synthetic MNIST-shaped rows from ``seed``: pixels uniform
    in [0, 1) as a ``[rows, 784]`` feature column, labels the argmax of a
    seeded linear teacher on the centred pixels (learnable, about
    balanced over the 10 classes)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    x = rng.rand(rows, 784).astype(np.float32)
    teacher = rng.randn(784, 10).astype(np.float32)
    return {"features": x, "label": ((x - 0.5) @ teacher).argmax(-1)}


def estimator_model(torch, dev, seed: int):
    """The MNIST ConvNet behind ``nn.Unflatten``: the estimator's
    ``[B, 784]`` feature matrix read as NHWC ``[B, 28, 28, 1]``."""
    from horovod_tpu_torch.models import mnist
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Unflatten(1, (28, 28, 1)),
                               mnist.ConvNet(device=dev, generator=gen))


def phase_train_estimator(torch, smi: str, seed: int) -> dict:
    """``TorchEstimator`` fits the MNIST ConvNet under ``hvd.init()`` at
    one rank (NCCL) through ``DistributedOptimizer``, checkpointing every
    epoch into a ``LocalStore`` in a temporary directory; every kernel
    counter zeroed just before the fit and read just after (none may
    launch: the estimator is host code around the model, and the JAX
    package computes this model outside any Pallas kernel)."""
    import copy
    import shutil
    import tempfile

    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.estimator import (LocalStore, TorchEstimator,
                                             TorchModel)
    from horovod_tpu_torch.optim.distributed import _DistributedOptimizer
    from horovod_tpu_torch.utils.checkpoint import Checkpointer, tree_bytes

    class TimedStore(LocalStore):
        """Marks each epoch's end: ``checkpoint_path`` is the first call
        of the checkpoint (after the epoch's loss was read, a device
        sync), ``sync`` the last."""

        def __init__(self, prefix: str) -> None:
            super().__init__(prefix)
            self.marks: list = []

        def checkpoint_path(self, run_id: str) -> str:
            self.marks.append(("save", time.perf_counter()))
            return super().checkpoint_path(run_id)

        def sync(self, run_id: str) -> None:
            super().sync(run_id)
            self.marks.append(("synced", time.perf_counter()))

    c = ESTIMATOR
    work = tempfile.mkdtemp(prefix="hvdtpu-estimator-")
    _free_cuda(torch)
    hvd.init()
    try:
        dev = hvd.global_state().device
        data = estimator_data(seed, c["rows"])
        model = estimator_model(torch, dev, seed)
        store = TimedStore(work)
        est = TorchEstimator(
            model=model, feature_cols=["features"], label_cols=["label"],
            loss="xent", batch_size=c["batch"], epochs=c["epochs"],
            optimizer=torch.optim.Adam(model.parameters(), lr=c["lr"]),
            store=store, run_id="mnist", seed=seed)
        before = _engine_metrics()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        fitted = est.fit(data)
        fit_s = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        entries = _delta(_engine_metrics(), before)["entries"]

        steps = c["rows"] // c["batch"]
        ends = [t for k, t in store.marks if k == "save"]
        synced = [t for k, t in store.marks if k == "synced"]
        starts = [t0] + synced[:-1]
        epoch_ms = [(e - b) * 1e3 for b, e in zip(starts, ends)]
        save_ms = [(e - b) * 1e3 for b, e in zip(ends, synced)]
        steady_ms = sorted(epoch_ms[1:])[len(epoch_ms[1:]) // 2]

        ckpt = Checkpointer(store.checkpoint_path("mnist"), read_only=True)
        restored = ckpt.restore()["params"]
        fitted_sd = fitted.module.state_dict()
        restored_equal = sorted(restored) == sorted(fitted_sd) and all(
            torch.equal(restored[k], v.cpu()) for k, v in fitted_sd.items())
        ckpt_file = Path(store.checkpoint_path("mnist")) / str(
            ckpt.latest_step()) / "tree.pt"

        rows = {k: v[:c["check_rows"]] for k, v in data.items()}
        tf32 = bool(torch.backends.cudnn.allow_tf32)
        card = fitted.predict(rows)
        cpu_model = TorchModel(module=copy.deepcopy(fitted.module).cpu(),
                               feature_cols=["features"],
                               label_cols=["label"])
        cpu = cpu_model.predict(rows)
        err = float(np.abs(card - cpu).max())
        ref = float(np.abs(cpu).max())
        check = {"max_abs_err": err, "max_abs_ref": ref, "rel": err / ref,
                 "tol": c["check_tol_tf32"] if tf32 else c["check_tol"],
                 "cudnn_tf32": tf32, "rows": c["check_rows"],
                 "accuracy_card": float((card.argmax(-1) == rows["label"])
                                        .mean())}

        # where a step's time goes: one more short epoch of the same
        # estimator (its DistributedOptimizer; no store) under the profiler
        from torch.profiler import ProfilerActivity, profile
        few = {k: v[:c["profile_steps"] * c["batch"]]
               for k, v in data.items()}
        est.store, est.epochs = None, 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            est.fit(few)
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        device_ms_step = sum(e.self_device_time_total
                             for e in kernels) / 1e3 / c["profile_steps"]
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]

        res = {"phase": "train_estimator", "model": "mnist.ConvNet",
               "rows": c["rows"], "global_batch": c["batch"],
               "epochs": c["epochs"], "steps_per_epoch": steps,
               "optimizer": f"DistributedOptimizer(Adam(lr={c['lr']}))",
               "distributed_optimizer": isinstance(est._opt,
                                                   _DistributedOptimizer),
               "allreduce_entries": entries,
               "params": sum(p.numel() for p in fitted.module.parameters()),
               "history": fitted.history, "fit_s": fit_s,
               "epoch_ms": epoch_ms, "steady_epoch_ms": steady_ms,
               "ms_per_step": steady_ms / steps,
               "samples_per_s": steps * c["batch"] / (steady_ms / 1e3),
               "samples_per_s_epoch0": steps * c["batch"]
               / (epoch_ms[0] / 1e3),
               "checkpoint_steps": ckpt.all_steps(),
               "checkpoint_restores_equal": restored_equal,
               "checkpoint_tensor_bytes": tree_bytes(
                   {"params": fitted_sd}),
               "checkpoint_file_bytes": ckpt_file.stat().st_size,
               "checkpoint_save_ms": save_ms,
               "peak_mem_gb": peak_gb, "launches": launches,
               "predict_check": check,
               "device_ms_per_step": device_ms_step if kernels
               else "not measured",
               "device_idle_share": 1 - device_ms_step / (steady_ms / steps)
               if kernels else "not measured",
               "top_kernels_ms_per_step": {
                   e.key[:80]: e.self_device_time_total / 1e3
                   / c["profile_steps"] for e in top},
               "card": smi}
        emit(res)
    finally:
        hvd.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        _free_cuda(torch)

    faults = []
    if any(launches.values()):
        faults.append(f"kernel launches {launches}, want none")
    losses = [h["loss"] for h in res["history"]]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        faults.append(f"epoch losses {losses}: want finite, the last below "
                      f"the first")
    if res["checkpoint_steps"] != list(range(c["epochs"])):
        faults.append(f"checkpoints {res['checkpoint_steps']}, want one an "
                      f"epoch")
    if not restored_equal:
        faults.append("the last checkpoint does not restore the fitted "
                      "parameters")
    if not (res["distributed_optimizer"]
            and entries == c["epochs"] * steps * 8):
        faults.append(f"{entries} allreduce entries through "
                      f"DistributedOptimizer={res['distributed_optimizer']},"
                      f" want 8 a step ({c['epochs'] * steps * 8})")
    if not check["rel"] <= check["tol"]:
        faults.append(f"predict on the card against the CPU's fp32: "
                      f"{check['rel']} > {check['tol']}")
    if faults:
        raise AssertionError("train_estimator: " + "; ".join(faults))
    return res


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--root", default=None,
                    help="drive the horovod_tpu_torch package of the checkout "
                    "at this directory (default: this script's own), to time "
                    "two trees with one script in one call")
    ap.add_argument("--hvdrun-worker", default=None, metavar="OUT",
                    help="run as the hvdrun phase's worker (started by the "
                    "port's launcher) and write what it found to OUT")
    ap.add_argument("--elastic-worker", default=None, metavar="DIR",
                    help="run as the elastic phase's worker (started by the "
                    "port's elastic driver), its records and state in DIR")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of train_estimator's data and weights")
    ap.add_argument("--obs", action="store_true",
                    help="with --hvdrun-worker: the hvdrun_obs phase's "
                    "worker (step spans, the rest of the plane checked)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "train_dp" in phases and "train" not in phases:
        ap.error("train_dp is held against train's losses and step time: "
                 "run both")
    if "hvdrun" in phases and "train_dp" not in phases:
        ap.error("hvdrun is held against train's losses and train_dp's "
                 "step time: run train, train_dp and hvdrun")
    if "hvdrun_obs" in phases and "train" not in phases:
        ap.error("hvdrun_obs is held against train's losses: run train "
                 "and hvdrun_obs")
    if "train_zero" in phases and "train_dp" not in phases:
        ap.error("train_zero is held against train's and train_dp's losses "
                 "and step time: run train, train_dp and train_zero")
    if "train_mesh" in phases and "train" not in phases:
        ap.error("train_mesh is held against train's weights and losses: "
                 "run train and train_mesh")
    if "serve_mesh" in phases and "serve" not in phases:
        ap.error("serve_mesh is held against serve's tokens and latency: "
                 "run serve and serve_mesh")
    if "train_variants" in phases and "train" not in phases:
        ap.error("train_variants is held against train's losses: run train "
                 "and train_variants")
    if "frontdoor" in phases and "build" not in phases:
        ap.error("frontdoor launches the kernels: run build and frontdoor")
    if "replicas" in phases and "build" not in phases:
        ap.error("replicas launches the kernels: run build and replicas")
    if "train_moe" in phases and "build" not in phases:
        ap.error("train_moe launches the kernels: run build and train_moe")
    if "elastic" in phases and "build" not in phases:
        ap.error("elastic's worker loads the kernels build builds: run "
                 "build and elastic")

    # The checkout's own package, never an installed one: without it (the
    # script alone in a directory) there is nothing to drive.
    root = Path(args.root or __file__).resolve()
    if not args.root:
        root = root.parent
    sys.path.insert(0, str(root))
    try:
        import horovod_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: no horovod_tpu_torch under {root}: {e}",
              file=sys.stderr)
        return 2
    if Path(horovod_tpu_torch.__file__).resolve().parent.parent != root:
        print(f"chip_smoke: horovod_tpu_torch comes from "
              f"{horovod_tpu_torch.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if args.hvdrun_worker:
        return hvdrun_worker(torch, Path(args.hvdrun_worker), obs=args.obs)
    if args.elastic_worker:
        return elastic_worker(torch, Path(args.elastic_worker))
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
        seconds = _build.build(KERNEL_LIBS)      # one nvcc each, all at once
        for lib in KERNEL_LIBS:
            _build.load(lib, FA._SIGNATURES[lib])
        emit({"phase": "build", "seconds": seconds,
              "wall_s": time.perf_counter() - t0,
              "libraries": {n: str(_build._target(n)[1])
                            for n in KERNEL_LIBS}})
    res = phase_kernel(torch) if "kernel" in phases else None
    served = phase_serve(torch, smi) if "serve" in phases else None
    if "frontdoor" in phases:
        phase_frontdoor(torch, smi)
    if "replicas" in phases:
        phase_replicas(torch, smi, served)
    trained = phase_train(torch, smi) if "train" in phases else None
    if "train_variants" in phases:
        phase_train_variants(torch, smi, trained)
    dp = phase_train_dp(torch, smi, trained) if "train_dp" in phases \
        else None
    if "train_zero" in phases:
        phase_train_zero(torch, smi, trained, dp)
    if "dataplane" in phases:
        phase_dataplane(torch, smi)
    hvdrun_ms = phase_hvdrun(torch, smi, trained, dp, root) \
        if "hvdrun" in phases else None
    if "hvdrun_obs" in phases:
        phase_hvdrun_obs(torch, smi, trained, dp, hvdrun_ms, root)
    if "elastic" in phases:
        phase_elastic(torch, smi, root)
    if "train_parity" in phases:
        phase_train_parity(torch, smi)
    moe_trained = phase_train_moe(torch, smi) if "train_moe" in phases \
        else None
    if "hier" in phases:
        phase_hier(torch, smi)
    meshed = phase_train_mesh(torch, smi, trained) \
        if "train_mesh" in phases else None
    piped = phase_train_pp(torch, smi) if "train_pp" in phases else None
    served_mesh = phase_serve_mesh(torch, smi, served) \
        if "serve_mesh" in phases else None
    zoo = {}
    if "train_resnet" in phases:
        zoo["train_resnet"] = phase_train_resnet(torch, smi)["launches"]
    if "train_bert" in phases:
        zoo["train_bert"] = phase_train_bert(torch, smi)["launches"]
    if "train_dlrm" in phases:
        for dlrm_res in phase_train_dlrm(torch, smi):
            zoo[f"train_dlrm.{dlrm_res['config']}"] = dlrm_res["launches"]
    if "train_estimator" in phases:
        zoo["train_estimator"] = phase_train_estimator(
            torch, smi, args.seed)["launches"]
    # launches: paged_decode on the serving paths, the flash kernels on
    # the training paths (each counted in its own run), summed; the
    # kernel phase's numbers where it ran (null where it did not).
    paths = {}
    if served is not None:
        paths["serve"] = {"paged_decode": served["counts"]["paged_decode"]}
    if trained is not None:
        paths["train"] = trained["launches"]
    if moe_trained is not None:
        paths["train_moe"] = moe_trained["launches"]
    if meshed is not None:
        paths["train_mesh"] = meshed["launches"]
    if piped is not None:
        paths["train_pp"] = piped["launches"]
    if served_mesh is not None:
        paths["serve_mesh"] = {"paged_decode":
                               served_mesh["counts"]["paged_decode"]}
    paths.update(zoo)              # every counter 0 there, checked above
    if paths:
        keys = ("max_abs_err", "worst_row_rel_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": f"{SRC}{lib}.cu",
             "replaces": replaces,
             "launches": sum(p.get(name, 0) for p in paths.values()),
             "launches_by_path": {k: p.get(name, 0)
                                  for k, p in paths.items()},
             **{k: res[name][k] if res is not None else None
                for k in keys}}
            for name, (lib, replaces) in KERNELS.items()]})
    emit({"phase": "total", "wall_s": time.perf_counter() - t_start,
          "phases": phases, "card": smi})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
