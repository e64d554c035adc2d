"""Host pack, diff and poke per frame submitted in the window (ms; BatchPipeline.stats)."""


def read(run):
    st, n = run.counters["stats"], run.counters["frames_in"]
    return (st["t_pack_ms"] + st["t_diff_ms"] + st["t_poke_ms"]) / n if n else None
