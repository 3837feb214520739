"""Host ms a step the training thread waited in ``synchronize()`` for the
gradients' allreduces (the ``hvd.step.allreduce_wait`` spans)."""

from portbench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "hvd.step.allreduce_wait")
