"""Mean crop_to_map time per update (ms): the hostpack's D2H wait and its parse."""

from smhbench import readers


def read(run):
    return readers.stage_ms(run, "crop_to_map")
