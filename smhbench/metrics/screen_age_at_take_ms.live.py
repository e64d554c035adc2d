"""The mean age of a frame when the loop takes it, screen -> take, over
every update of the window (ms): the grab, the dedup compare and the time
in the capture mailbox, read by the benchmark's own clock."""

from smhbench import readers


def read(run):
    ages = readers.screen_ms(run, 5)
    return sum(ages) / len(ages) if ages else None
