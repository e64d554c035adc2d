"""The kernel library's lookup (or build) and dlopen in set-up (s)."""

from smhbench import spans


def read(run):
    return spans.setup_kernels_s(run)
