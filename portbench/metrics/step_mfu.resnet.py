"""The whole training step's share of the bf16 peak: images a second x
3 x 2 x the forward's multiply-adds, over 989 TFLOP/s."""

from portbench.harness import layers, yardstick


def read(ctx):
    c = ctx.cell.config
    macs = yardstick.resnet_forward_macs(c["stage_sizes"], c["width"],
                                         c["num_classes"], c["image_size"])
    return layers.mfu_pct(ctx, 3 * 2 * macs)
