"""The median of frame -> update over every update of the window (ms), at
the traffic's frame rate: what a player waits for one frame, which swings
with the host's speed from run to run more than the loop's rate does."""

from smhbench import readers


def read(run):
    return readers.latency_ms(run, 0.5)
