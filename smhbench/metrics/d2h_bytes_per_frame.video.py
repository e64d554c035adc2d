"""Bytes copied device -> host per frame submitted in the window
(BatchPipeline.stats d2h_bytes)."""

from smhbench import spans


def read(run):
    return spans.d2h_per_frame(run, "frames_in")
