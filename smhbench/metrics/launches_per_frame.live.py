"""Kernel launches of the fused pass per frame submitted in the window (kernels.LAUNCHES)."""


def read(run):
    n = run.counters["submits"]
    return sum(run.counters["launches"].values()) / n if n else None
