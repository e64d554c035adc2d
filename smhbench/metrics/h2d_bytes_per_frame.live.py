"""Bytes uploaded to the card per frame in the window (CudaBackend.stats)."""


def read(run):
    st = run.counters["stats"]
    return st["h2d_bytes"] / st["frames"] if st.get("frames") else None
