"""Variants of ``flash_simple_dq`` on the card, side by side.

Builds patched copies of ``horovod_tpu_torch/csrc/flash_simple.cu`` (one
``nvcc`` each, all at once), calls each copy's ``flash_simple_dq`` C
entry point on the same tensors, and prints one JSON line a (shape,
variant): the worst row against the fp32 plain version (the bar
``chip_smoke.py`` holds the kernel to) and, for fp32, against an fp64
evaluation of the same formula on the same inputs, beside the fp32 plain
version's own distance from it; and the kernel's time on the timed
shapes (``chip_smoke.time_cold``, twice).  Run from the repository root
on a machine with one card::

    python3 tools/flash_dq_variants.py [--parent DIR] [--out FILE]

``--parent DIR`` adds the ``flash_simple.cu`` of another tree (``git
archive HEAD~1`` unpacked there) as the variant ``parent``.  A variant
is a list of text substitutions of this tree's source; one whose text is
gone fails its build and is reported, not run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as FA  # noqa: E402

CSRC = ROOT / "horovod_tpu_torch" / "csrc"
CUT_DP = ("      if (edge)\n"
          "        fma_nt<DP, NJ>(dp, dos, m0, ks + BK * DP);\n"
          "      else\n"
          "        mma_nt<DP, NJ>(dp, dos, m0, ks + BK * DP, 0);")
WARPS = "static constexpr int kWarps = DP == 256 ? 4 : 8;"
KEYS = "static constexpr int BK = DP <= 64 ? 64 : DP == 128 ? 32 : 16;"
# name -> substitutions of this tree's flash_simple.cu
VARIANTS = {
    "tree": [],
    "dp_tensor_cores": [(CUT_DP, "      mma_nt<DP, NJ>(dp, dos, m0, ks + BK * DP, 0);")],
    "dp_fma": [(CUT_DP, "      fma_nt<DP, NJ>(dp, dos, m0, ks + BK * DP);")],
    "rows64_keys64": [
        (WARPS, "static constexpr int kWarps = DP >= 128 ? 4 : 8;"),
        (KEYS, "static constexpr int BK = DP <= 128 ? 64 : 16;")],
    "rows32_keys32": [
        (WARPS, "static constexpr int kWarps = DP == 256 ? 2 : 8;"),
        (KEYS, "static constexpr int BK = DP <= 64 ? 64 : 32;")],
    "bf16_two_stages": [("constexpr int kStages = 3;",
                         "constexpr int kStages = 2;")],
}
# (label, B, S, H, KV, D, causal, bf16, timed)
SHAPES = (
    ("tiny_fp32", 2, 100, 4, 2, 16, True, False, False),
    ("d64_gqa", 1, 520, 8, 2, 64, True, False, False),
    ("d128_full", 1, 777, 4, 2, 128, False, False, False),
    ("d128_causal", 1, 1024, 8, 8, 128, True, False, False),
    ("d256_fp32", 1, 1024, 8, 8, 256, True, False, True),
    ("wide_bh_fp32", 17500, 64, 4, 4, 16, True, False, False),
    ("s4000_fp32_full", 1, 4000, 32, 8, 128, False, False, False),
    ("llama2_7b_train_fp32", 1, 4096, 32, 32, 128, True, False, True),
    ("d256_bf16", 1, 2048, 16, 16, 256, True, True, True),
    ("d160_bf16", 1, 1000, 16, 4, 160, True, True, False),
)


def build(name: str, source: str, work: Path) -> tuple[str, str]:
    """Compile ``source`` beside the headers into ``work/name``; returns
    (library path or "", compiler output)."""
    d = work / name
    d.mkdir(parents=True, exist_ok=True)
    for hdr in CSRC.glob("*.cuh"):
        shutil.copy(hdr, d)
    (d / "flash_simple.cu").write_text(source)
    so = d / "flash_simple.so"
    p = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", str(so), str(d / "flash_simple.cu")],
                       capture_output=True, text=True)
    return (str(so) if p.returncode == 0 else ""), p.stdout + p.stderr


def fp64_dq(torch, q, k, v, do, lse, delta, scale, causal):
    """The plain formula of ``flash_backward_dq_reference`` in fp64."""
    rep = q.shape[2] // k.shape[2]
    qd, kd, vd, dod = (t.double() for t in (
        q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2), do))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                     device=q.device).triu(1), -1e30)
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd)
    ds = p * (dp - delta.double()[..., None]) * scale
    return torch.einsum("bhqk,bkhd->bqhd", ds, kd)


def row_ratio(torch, got, ref, scale):
    return (got.double() - ref.double()).abs().amax(-1) / scale


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another tree whose flash_simple.cu runs too")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "flash_dq_variants.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = ROOT / "build" / "dq_variants"
    base = (CSRC / "flash_simple.cu").read_text()
    sources = {}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            text = text.replace(old, new) if old in text else ""
        sources[name] = text
    if args.parent:
        sources["parent"] = (Path(args.parent) / "horovod_tpu_torch" /
                             "csrc" / "flash_simple.cu").read_text()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(
            lambda n: build(n, sources[n], work) if sources[n] else ("", ""),
            sources)))
    fns = {}
    for name, (so, log) in built.items():
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line]
        print(json.dumps({"variant": name, "built": bool(so),
                          "spill_lines": spills}), flush=True)
        if so:
            f = ctypes.CDLL(so).flash_simple_dq
            f.restype, f.argtypes = FA._SIGNATURES["flash_simple"][
                "flash_simple_dq"]
            fns[name] = f
    records = []
    for label, B, S, H, KV, D, causal, bf16, timed in SHAPES:
        dt = torch.bfloat16 if bf16 else torch.float32
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        q, k, v, do = CS.flash_case(torch, gen, B, S, H, KV, D, dt)
        sc = 1.0 / math.sqrt(D)
        o, lse = FA.flash_forward(q, k, v, sc, causal)
        delta = FA.flash_delta(o, do)
        ref = FA.flash_backward_dq_reference(q, k, v, do, lse, delta, sc,
                                             causal).float()
        mag = ref.abs().amax(-1)
        scale = torch.maximum(mag, CS.FLOOR_SHARE * mag.median()).double()
        exact = plain_vs_exact = None
        if not bf16:
            exact = fp64_dq(torch, q, k, v, do, lse, delta, sc, causal)
            plain_vs_exact = row_ratio(torch, ref, exact, scale)
        dp = FA.flash_plan(dt, D)[1]
        padded = [torch.nn.functional.pad(t, (0, dp - D)).contiguous()
                  for t in (q, k, v, do)]
        for name, fn in fns.items():
            if bf16 and name.startswith(("dp_", "rows")):
                continue
            if not bf16 and name.startswith("bf16_"):
                continue
            dq = torch.empty_like(padded[0])

            def call():
                rc = fn(*(t.data_ptr() for t in padded), lse.data_ptr(),
                        delta.data_ptr(), dq.data_ptr(), B, S, H, KV, dp,
                        sc, int(causal), FA._DTYPE_CODE[dt],
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            call()
            torch.cuda.synchronize()
            got = dq[..., :D].float()
            rec = {"shape": label, "variant": name, "dtype": str(dt)[6:],
                   "worst_row_vs_plain":
                   row_ratio(torch, got, ref, scale).max().item()}
            if exact is not None:
                rec["worst_row_vs_fp64"] = row_ratio(
                    torch, got, exact, scale).max().item()
                rec["plain_worst_row_vs_fp64"] = plain_vs_exact.max().item()
            if timed:
                rec["ms"] = [CS.time_cold(torch, call) for _ in range(2)]
            records.append(rec)
            print(json.dumps(rec), flush=True)
        del q, k, v, do, o, lse, delta, ref, exact, padded
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": CS.nvidia_smi_line(), "records": records}, indent=1))
    print(CS.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
