"""The flash backward kernels' (dQ and dK/dV) share of their roofline
over the profiled steps, in percent."""

from portbench.harness import layers


def read(ctx):
    return layers.roofline_pct(
        ctx, {"flash_bwd_dq_kernel": layers.flash_bound_s(ctx, "dq"),
              "flash_bwd_dkv_kernel": layers.flash_bound_s(ctx, "dkv")})
