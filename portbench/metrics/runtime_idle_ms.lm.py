"""Ms a step in which no device operation ran while the training thread
waited in ``synchronize()`` (``hvd.step.allreduce_wait`` on the device
timeline)."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "hvd.step.allreduce_wait")
