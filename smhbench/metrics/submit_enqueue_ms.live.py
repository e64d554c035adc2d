"""The submit half's staging, H2D enqueue, the fused pass's launches and
the hostpack D2H enqueue (vision.dispatch), mean per submit in the window
(ms)."""

from smhbench import spans


def read(run):
    return spans.per_submit_ms(run, "vision.dispatch")
