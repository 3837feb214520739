"""The share of the profiled steps in which no device operation ran on any
stream, of the fullest rank, in percent."""

from portbench.harness import layers


def read(ctx):
    return layers.idle_share_pct(ctx)
