"""Seeds the cuda engine marched, speculative ones included (CudaBackend.stats
lsd_seeds_marched), per frame in the window."""

from smhbench import march


def read(run):
    return march.per_update(run, "lsd_seeds_marched")
