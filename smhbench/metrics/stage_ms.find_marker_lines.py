"""Mean find_marker_lines time per update (ms): the host LSD."""

from smhbench import readers


def read(run):
    return readers.stage_ms(run, "find_marker_lines")
