"""The flash forward kernel's share of its roofline over the profiled
steps: the least time of its launches at the cell's causal shape, over
their device time, in percent."""

from portbench.harness import layers


def read(ctx):
    return layers.roofline_pct(
        ctx, {"flash_fwd_kernel": layers.flash_bound_s(ctx, "fwd")})
