"""Ms a step in which a runtime kernel runs and no compute kernel does,
from the device timeline, the mean over ranks."""

from portbench.harness import layers


def read(ctx):
    return layers.mean_over_ranks(ctx, layers.exposed_ms)
