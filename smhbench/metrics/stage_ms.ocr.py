"""Mean host OCR time per update (ms), 0 where the legend's checksum hit the cache."""

from smhbench import readers


def read(run):
    return readers.stage_ms(run, "ocr")
