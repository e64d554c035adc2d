"""The share of the profiled slices with nothing on the card (%)."""

from smhbench import readers


def read(run):
    return readers.device_idle_pct(run)
