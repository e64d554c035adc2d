"""The batch's host stage (collect's host_stage) per frame collected in the window (ms)."""


def read(run):
    n = run.counters["frames_out"]
    return run.counters["stats"]["t_host_ms"] / n if n else None
