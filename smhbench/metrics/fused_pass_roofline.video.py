"""The fused pass's kernels' share of their byte bound (%)."""

from smhbench import readers


def read(run):
    return readers.pass_roofline(run)
