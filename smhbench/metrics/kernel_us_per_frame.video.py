"""Kernel time on the card per frame (us), from the profiled slices."""

from smhbench import readers


def read(run):
    return readers.kernel_us_per_frame(run)
