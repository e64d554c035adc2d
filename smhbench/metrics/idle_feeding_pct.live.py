"""The share of the device's idle time in the profiled slices during which
the submit half was feeding it (%)."""

from smhbench import spans


def _share(run, k: int):
    split = spans.idle_split(run)
    return None if split is None else split[k]


def read(run):
    return _share(run, 0)
