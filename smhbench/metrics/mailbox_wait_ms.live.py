"""A frame's time in the capture mailbox, publish to the loop's take, mean
per frame taken in the window (ms): the age of the frame a submit starts on."""

from smhbench import spans


def read(run):
    return spans.mean_ms(run, "capture.mailbox")
