"""Wall time less the thread's CPU time of the batch's pack and diff
(batch.pack + batch.diff) per frame submitted in the window (ms)."""

from smhbench import spans


def read(run):
    return spans.per_frame_ms(run, ("batch.pack", "batch.diff"), offcpu=True)
