"""The 95th percentile of screen -> update over every update of the window
(ms): the screen's read, stamped when the benchmark's source is grabbed, to
the update in `on_update`; the tail of what a player waits."""

from smhbench import readers
from smhbench import yardstick as Y


def read(run):
    waits = readers.screen_ms(run, 4)
    return Y.quantile(waits, 0.95) if waits else None
