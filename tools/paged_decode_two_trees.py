"""``paged_decode`` of two trees in one process, on the same tensors.

Builds ``csrc/paged_decode.cu`` of another tree (``--other DIR``, e.g.
``git archive HEAD~1`` unpacked there) beside this tree's library, calls
both through this tree's wrapper (``flash_attention.paged_attention``) on
the same inputs at ``chip_smoke.py``'s timed decode shapes, checks that
their outputs are bitwise equal, and times them in turns (other, this,
this, other, other, this) with ``chip_smoke.time_cold``.  One JSON line a
shape.  It separates a change in the kernel from a difference between
two ``chip_smoke.py --root`` runs of the whole kernel phase.  Run from
the repository root on a machine with one card::

    python3 tools/paged_decode_two_trees.py --other DIR
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as FA  # noqa: E402

RAGGED = [1, 17, 300, 777, 1024, 1500, 2000, 2048]
# chip_smoke.py's timed paged_decode shapes
SHAPES = (
    ("llama2_7b_decode", dict(B=8, H=32, KV=32, Dh=128, BS=16,
                              lengths=RAGGED, n_cols=128)),
    ("gqa_rep4", dict(B=8, H=32, KV=8, Dh=128, BS=16, lengths=RAGGED,
                      n_cols=128)),
    ("serve_decode", dict(B=8, H=32, KV=32, Dh=128, BS=16,
                          lengths=[65, 129, 193, 257, 321, 385, 449, 513],
                          n_cols=64)),
    ("long_gqa", dict(B=1, H=32, KV=8, Dh=128, BS=16, lengths=[4096],
                      n_cols=256)),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other tree's root")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    sig = FA._SIGNATURES["paged_decode"]
    this = _build.load("paged_decode", sig)
    src = Path(args.other) / "horovod_tpu_torch" / "csrc" / "paged_decode.cu"
    out = ROOT / "build" / "paged_decode_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    other = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in sig.items():
        getattr(other, fn).restype = restype
        getattr(other, fn).argtypes = list(argtypes)
    same_source = src.read_bytes() == (
        ROOT / "horovod_tpu_torch" / "csrc" / "paged_decode.cu").read_bytes()
    libs = {"other": other, "this": this}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    for label, kw in SHAPES:
        q, kp, vp, tables, lens = CS.paged_case(torch, gen,
                                                dtype=torch.bfloat16, **kw)

        def call():
            return FA.paged_attention(q, kp, vp, tables, lens)
        outs, ms = {}, {"other": [], "this": []}
        try:
            for name, lib in libs.items():
                _build._libs["paged_decode"] = lib
                outs[name] = call().clone()
            for name in ("other", "this", "this", "other", "other", "this"):
                _build._libs["paged_decode"] = libs[name]
                ms[name].append(CS.time_cold(torch, call))
        finally:
            _build._libs["paged_decode"] = this
        print(json.dumps({
            "shape": label, "same_source": same_source,
            "bitwise_equal": bool(torch.equal(outs["other"], outs["this"])),
            "ms_other": ms["other"], "ms_this": ms["this"]}), flush=True)
    print(CS.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
