"""Device ms a step of what the runtime launched (NCCL kernels, and its
packing and unpacking on its own stream), the mean over ranks."""

from portbench.harness import layers


def read(ctx):
    return layers.mean_over_ranks(ctx, layers.runtime_ms)
