"""The host's own part of the cuda engine's seed scan (lsd.scan less the
marches and waits under it), mean per update (ms)."""

from smhbench import march


def read(run):
    return march.scan_ms(run)
