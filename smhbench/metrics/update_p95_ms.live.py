"""The 95th percentile of frame -> update over every update of the window
(ms), at the traffic's frame rate."""

from smhbench import readers


def read(run):
    return readers.latency_ms(run, 0.95)
