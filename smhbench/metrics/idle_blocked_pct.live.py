"""The share of the device's idle time in the profiled slices during which
the submitter waited on a full queue and fed nothing (%)."""

from smhbench import spans


def _share(run, k: int):
    split = spans.idle_split(run)
    return None if split is None else split[k]


def read(run):
    return _share(run, 1)
