"""The submit half's pack and diff (vision.load_frame), mean per submit in
the window (ms)."""

from smhbench import spans


def read(run):
    return spans.per_submit_ms(run, "vision.load_frame")
