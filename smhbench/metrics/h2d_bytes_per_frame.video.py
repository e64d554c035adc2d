"""Bytes uploaded to the card per frame submitted in the window (BatchPipeline.stats)."""


def read(run):
    n = run.counters["frames_in"]
    return run.counters["stats"]["h2d_bytes"] / n if n else None
