"""The benchmark's cells cut to a size the CPU tests run in seconds, at
the precision of the plain versions, so a sound program agrees with the
reference to rounding."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "mistral-7b": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, rope_theta=1e6,
                       rms_norm_eps=1e-5, torch_dtype="float32",
                       sliding_window=None),
    "resnet50": dict(stage_sizes=[1, 1], width=8, num_classes=10,
                     image_size=32, channels=3, conv_dtype="float32",
                     batch_norm={"momentum": 0.9, "epsilon": 1e-5},
                     zero_init_last_bn=True),
}
TINY_TRAFFIC = {"mistral-7b": dict(seq=32, rows=8),
                "resnet50": dict(batch=8, rows=4)}
# Limits of the tiny fp32 cells: a sound run reads about 1e-6.
TINY_LIMITS = {"loss_rel": 1e-4, "grad1_gap": 1e-3, "change_gap": 1e-3}



# The data-parallel traffic of Mistral-7B kept for a later cell
# (``portbench/traffic/dp4.s4096.json``), run here on two CPU ranks.
DP_TRAFFIC = "dp4.s4096"


def tiny_cell(workload: str, traffic_file: str = "", **traffic):
    """The cell as ``BENCHMARK.json`` has it, cut to the test size; with
    ``traffic_file``, under that traffic mix instead of its own."""
    from portbench.harness import spec

    c = spec.find_cell(workload)
    if traffic_file:
        c.traffic = spec.read_json(spec.BENCH_DIR / "traffic"
                                   / f"{traffic_file}.json")
    c.config = dict(TINY[c.config_name])
    c.traffic = dict(c.traffic, **TINY_TRAFFIC[c.config_name], **traffic)
    c.limits = dict(TINY_LIMITS)
    return c
