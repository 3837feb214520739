"""Host ms a step of the engine's cycles that carried entries (the
``hvd.engine.cycle`` spans: negotiation, fusion, dispatch)."""

from portbench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "hvd.engine.cycle")
