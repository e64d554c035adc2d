"""Bounded slices of the device timeline, read by torch.profiler.

A trace loses the records that come first (on an H100: 2 as a rule; after
traces of thousands of launches, up to all of them), and a profiler
started or stopped while other threads launch work crashed one traced run
in four when a run took 25 slices (a segmentation fault, "free(): invalid
pointer"), each slice costing seconds more than the one before. So a
traced run takes few slices, and each starts and stops the profiler only
while the program is quiet: the feed holds it at the door where frames
enter and waits until every frame let in is answered (`pause`), and opens
the door again (`resume`) once the profiler runs. Around that sit two runs
of SPINS spin kernels (`torch.cuda._sleep`), left out of every count; a
slice is taken again when its spins or its kernels show a loss: the
program's kernels launched between the slice's two launch-counter readings
all ran between the two runs of spins, so the trace must hold at least
that many. The slice's window runs from `resume` to `pause`, on the host's
clock.
"""

from __future__ import annotations

import re
import sys
import time

SPINS = 20
TRIES = 4


def _short(name: str) -> str:
    """A kernel's function name (`..._kernel`) out of its demangled
    signature, as "void (anonymous namespace)::hostpack_kernel<...>(...)"."""
    m = re.search(r"(\w+_kernel)\b", name)
    return m.group(1) if m else name


def take(seconds: float, launches, clock, pause, resume) -> dict:
    """Profile `seconds` of the program's work on the card (its CUDA
    activity alone). `launches()` reads the program's launch counter,
    `clock()` the host clock the spans use; `pause()` and `resume()` stop
    and restart the offered frames (the program is paused when this is
    called, and is resumed when it returns). The start spins' synchronize
    returning puts the device's clock on the host's. -> the slice: its
    window [lo, hi] in host seconds and every device row that overlaps it as
    (name, start, end, kind), kind "kernel" or "copy" (copies and memsets);
    None where every try lost records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def spin() -> None:
        for _ in range(SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    try:
        for attempt in range(TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                spin()
                c0 = clock()  # the start spins have just ended on the card
                n0 = launches()
                lo = clock()
                resume()
                time.sleep(seconds)
                pause()
                hi = clock()
                n1 = launches()
                spin()
            rows = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            spins = sorted((e.time_range.start, e.time_range.end) for e in rows if "spin_kernel" in e.name)
            work = [e for e in rows if "spin_kernel" not in e.name]
            kernels = [e for e in work if not e.name.startswith(("Memcpy", "Memset"))]
            if len(spins) <= SPINS:
                lost = f"{2 * SPINS - len(spins)} of {2 * SPINS} spin kernels"
            elif len(kernels) < n1 - n0:
                lost = f"{n1 - n0 - len(kernels)} of {n1 - n0} kernels"
            else:
                break
            print(f"profile: slice {attempt + 1} of {TRIES} lost {lost}; taken again", file=sys.stderr, flush=True)
        else:
            return None
    finally:
        resume()
    # The start spins end before the widest gap between spin starts.
    starts = [a for a, _ in spins]
    cut = max(range(1, len(starts)), key=lambda i: starts[i] - starts[i - 1])
    off = c0 - max(b for _, b in spins[:cut]) * 1e-6  # device-clock us -> host seconds
    kernel_ids = {id(e) for e in kernels}
    out = []
    for e in work:
        a, b = e.time_range.start * 1e-6 + off, e.time_range.end * 1e-6 + off
        if b > lo and a < hi:
            kind = "kernel" if id(e) in kernel_ids else "copy"
            out.append((_short(e.name) if kind == "kernel" else e.name, a, b, kind))
    return {"lo": lo, "hi": hi, "rows": out}
