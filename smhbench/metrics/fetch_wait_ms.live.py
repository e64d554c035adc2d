"""The consume half's wait on the hostpack's D2H event (vision.fetch_wait),
mean per frame consumed in the window (ms)."""

from smhbench import spans


def read(run):
    return spans.mean_ms(run, "vision.fetch_wait")
