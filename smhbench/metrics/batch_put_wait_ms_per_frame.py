"""The batch submitter's wait on a full queue (batch.queue_put) per frame
submitted in the window (ms)."""

from smhbench import spans


def read(run):
    return spans.per_frame_ms(run, "batch.queue_put")
