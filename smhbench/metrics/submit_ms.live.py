"""Mean time of VisionState.submit per frame in the window (ms): the loop's submit half."""

from smhbench import readers


def read(run):
    return readers.span_ms(run, "submit")
