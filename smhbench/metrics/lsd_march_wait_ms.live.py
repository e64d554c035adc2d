"""The cuda engine's waits for its seed batches' winners (lsd.march_wait),
summed per update (ms)."""

from smhbench import march


def read(run):
    return march.march_wait_ms(run)
