"""Bytes copied device -> host per frame in the window (CudaBackend.stats
d2h_bytes over frames)."""

from smhbench import spans


def read(run):
    return spans.d2h_per_frame(run, "frames")
