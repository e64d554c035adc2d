"""The ray march's kernel time (kernel 4) per frame in the profiled slices (us)."""

from smhbench import march


def read(run):
    return march.us_per_update(run)
