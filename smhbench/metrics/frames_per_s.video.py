"""The video's frames collected in the window per second of it that the
program was let run (frames/s): `video_fps` before it left the end-to-end
metrics, read in the traced run less the profiler's holds."""


def read(run):
    n, s = run.counters["frames_out"], run.t1 - run.t0 - run.paused_s
    return n / s if n and s > 0 else None
