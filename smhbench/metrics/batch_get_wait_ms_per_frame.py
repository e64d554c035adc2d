"""The batch consumer's wait on an empty queue (batch.queue_get) per frame
submitted in the window (ms)."""

from smhbench import spans


def read(run):
    return spans.per_frame_ms(run, "batch.queue_get")
