"""The whole training step's share of the bf16 peak: tokens a second over
every rank x (6 N + 12 L D S) a token, over 989 TFLOP/s a card."""

from portbench.harness import layers, yardstick


def read(ctx):
    c, tr = ctx.cell.config, ctx.cell.traffic
    return layers.mfu_pct(ctx, yardstick.llama_flops_per_token(c, tr["seq"]))
