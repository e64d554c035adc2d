"""Seed batches the cuda engine launched (CudaBackend.stats lsd_marches) per
frame in the window."""

from smhbench import march


def read(run):
    return march.per_update(run, "lsd_marches")
