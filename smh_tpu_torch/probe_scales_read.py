"""Where the scales read kernel's device time goes, phase by phase, and
against another build of the same entry point, on the card.

    python -m smh_tpu_torch.probe_scales_read [--against DIR] [--out FILE]

Run from the root of a checkout (the planes come from chip_smoke.py).
Builds csrc/scales_read.cu as it is and patched (VARIANTS: other designs,
ablations, a timeline, and the chain's steps), and with --against the same
source from DIR/smh_tpu_torch/csrc (an unpacked archive of another commit),
as it is and with the cumulative ablations, whose patches apply to both
designs; each build into its own library under smh_tpu_torch/build/probe-*,
one nvcc per build, all started together.

The cumulative ablations return from the kernel where the source's
top-level comment "  // k. " opens phase k, so "through phase k" minus
"through phase k - 1" is phase k's device time; they compute no record and
only time. The timeline build stamps clock64() where each phase opens and
at steps inside the phases and prints each phase's cycles in the slowest
block. The chain builds repeat one dependent step N more times (a cluster
barrier, the word grouping), and a pointer chase times one dependent load:
chain_floor() counts CHAIN_STEPS of each beside the kernel. Every other
build must equal scales_records_plain in every lane but the score lanes
(within 1) on every input.

Inputs: chip_smoke.py's BRQ planes, the verify frame's at 1080p (411 x
493) and 4K (822 x 986), random words, bars and blobs at both, and B = 3
and 8 frames of both kinds cut from the rows of one buffer whose rows lie
an odd number of bytes apart. In turns (against, as built, as built,
against) on every input, and the variants and ablations on three of them:
device us per call (torch.profiler, the call's CUDA rows), CUDA launches
per call, and host us per call to enqueue. Prints one line per input, the
chain floor, and a JSON summary last (--out: also every block's timeline).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from . import _build, _probe

SOURCE = "scales_read.cu"
# Phase k of the kernel opens at the top-level comment "  // k. " in both
# designs.
PHASES = {0: "templates", 1: "text rows and bands", 2: "band columns and glyph runs", 3: "glyph windows",
          4: "words", 5: "bar scan", 6: "record"}


def _stop_before(k: int, settle: bool) -> tuple:
    """Returns from the kernel where phase k opens; with settle, a band's
    block first waits for its templates' bulk copy (no block exits with a
    copy into its shared memory in flight)."""
    wait = "    await_templates(s, rank);\n" if settle else ""
    return (f"\n  // {k}. ", f"\n  if (h > 0) {{  // probe: stop before phase {k}\n{wait}    return;\n  }}\n  // {k}. ")


def _stops(settle: bool) -> dict:
    """{name: [patch]}: the cumulative ablations, through phase k."""
    stops = {f"ablation: through phase {k - 1}": [_stop_before(k, settle)] for k in range(1, 7)}
    stops["ablation: empty"] = [_stop_before(0, False)]  # before the copy starts
    return stops


STOPS = _stops(settle=True)
# The same for --against a single-block build of the kernel, which copies
# no templates in the background.
AGAINST_STOPS = _stops(settle=False)
_BAR = ("\n  // 5. ", "\n  if (h < 0)  // probe: no bar scan\n  // 5. ")
_SMEM_ATTR = ("    err = cudaFuncSetAttribute(scales_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, "
              "(int)MAX_SMEM);\n")
# The templates' bulk copy, and in its place every thread loading them (the
# mbarrier then completes at the one arrive).
_TPL_COPY = """    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem_addr(s.tpl)),
        "l"(tpl), "r"(bytes), "r"(bar)
        : "memory");
  }
"""
_TPL_LOADS = """    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
    (void)bytes;
  }
  for (int i = threadIdx.x; i < T * GLYPH_PX; i += blockDim.x) s.tpl[i] = __ldg(tpl + i);  // probe
"""
# {variant: [(text, replacement), ...]} on scales_read.cu.
VARIANTS = {
    "as built": [],
    "a cluster of 16 blocks": [
        ("constexpr int CLUSTER = 8;", "constexpr int CLUSTER = 16;"),
        (_SMEM_ATTR, _SMEM_ATTR + "    if (err == cudaSuccess)  // probe: past the portable cluster size\n"
                                  "      err = cudaFuncSetAttribute(scales_read_kernel, "
                                  "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")],
    "8 loads in flight in the row pass": [("constexpr int LOADS = 4;", "constexpr int LOADS = 8;")],
    "a word a thread when staging": [("constexpr int GROUP = 2;", "constexpr int GROUP = 1;")],
    "4 words a thread when staging": [("constexpr int GROUP = 2;", "constexpr int GROUP = 4;")],
    "templates by loads, not a bulk copy": [(_TPL_COPY, _TPL_LOADS)],
    "ablation: no bar scan": [_BAR],
    **STOPS,
}
# Timing variants that lengthen the chain by N more of one dependent step;
# (time - as built) / N is that step's latency on the card.
_BEFORE_5, _BEFORE_6 = "\n  // 5. ", "\n  // 6. "
CHAIN = {
    "chain: 32 more cluster barriers": (32, "cluster barrier", [(
        _BEFORE_6, "\n  for (int i = 0; i < 32; ++i) cluster.sync();  // probe\n  // 6. ")]),
    "chain: 16 more word groupings": (16, "word grouping", [(
        _BEFORE_5, "\n  if (warp == 0)  // probe\n"
                   "    for (int i = 0; i < 16; ++i) group_band(s, lb, h, w, budget);\n"
                   "  __syncthreads();\n  // 5. ")]),
}
VARIANTS.update({name: patches for name, (_n, _step, patches) in CHAIN.items()})
# A pointer chase on the card (one thread, each load's address the value of
# the one before, through L2): (time at CHASE_STEPS - time at 0) / CHASE_STEPS
# is one dependent load's latency. Appended to the as-built source.
CHASE = "chain: a pointer chase"
CHASE_STEPS = 512
VARIANTS[CHASE] = [("  return (int)cudaGetLastError();\n}\n", """  return (int)cudaGetLastError();
}

__global__ void probe_chase_kernel(const int* next, int steps, int* out) {
  int i = 0;
  for (int k = 0; k < steps; ++k) i = __ldcg(next + i);
  *out = i;
}

extern "C" int smh_probe_chase(const void* next, int steps, void* out, void* stream) {
  probe_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(next), steps,
                                                                     static_cast<int*>(out));
  return (int)cudaGetLastError();
}
""")]


def load_latency_us(lib, profile, dev) -> float:
    """One dependent load's latency (us) through L2, from the pointer chase:
    a 4 MB ring of int32 indices, each 32,771 entries (128 KB) on."""
    import ctypes

    n = 1 << 20
    nxt = ((torch.arange(n, dtype=torch.int64, device=dev) + 32771) % n).to(torch.int32)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    lib.smh_probe_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.smh_probe_chase.restype = ctypes.c_int

    def chase(steps):
        def fn():
            _build.check(lib.smh_probe_chase(nxt.data_ptr(), steps, out.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream), "smh_probe_chase")
        return fn

    return (profile(chase(CHASE_STEPS), n=20)["us"] - profile(chase(0), n=20)["us"]) / CHASE_STEPS


def _stamp(k: int, who: str = "tid") -> str:
    return f"  if ({who} == 0) s.probe_t[{k}] = clock64();  // probe\n"


# A timing variant: clock64() of thread 0 of every block where each phase
# opens, at steps inside phases 1 and 2, and at its end, and of lane 0 of
# the warp on glyph slot 0 inside the classify; each block writes its
# deltas (cycles, int32) over the record, 24 per block: phases 0-6, then
# TIMELINE_PARTS. It runs the word grouping twice: the second run's code is
# in the instruction cache.
TIMELINE = "timeline: cycles per phase per block"
TIMELINE_PARTS = ("templates wait", "window", "gate", "resample and norm", "template dots", "words again",
                  "strip read", "strip sync", "cluster wait", "exchange", "band runs", "staging", "staging sync",
                  "glyph runs")
VARIANTS[TIMELINE] = [
    ("  unsigned long long bar_key[MAX_WPB];\n};", "  unsigned long long bar_key[MAX_WPB];\n  long long probe_t[24];\n};"),
    ("\n  // 0. ", "\n  if (tid == 0)  // probe\n    for (int k = 0; k < 24; ++k) s.probe_t[k] = k ? 0 : clock64();\n  // 0. "),
    *[(f"\n  // {k}. ", f"\n{_stamp(k)}  // {k}. ") for k in range(1, 7)],
    ("  await_templates(s, rank);\n  if (warp < MAX_GPB)", f"  await_templates(s, rank);\n{_stamp(8)}  if (warp < MAX_GPB)"),
    ("  if (warp == 0) group_band(s, lb, h, w, budget);\n  __syncthreads();\n",
     "  if (warp == 0) group_band(s, lb, h, w, budget);\n  __syncthreads();\n"
     f"{_stamp(13)}  if (warp == 0) group_band(s, lb, h, w, budget);  // probe\n  __syncthreads();\n{_stamp(14)}"),
    ("MarkRows{s.rowflag, w});\n  __syncthreads();\n", f"MarkRows{{s.rowflag, w}});\n{_stamp(15)}  __syncthreads();\n{_stamp(16)}"),
    ("  cluster_wait();  // every block has started\n", f"  cluster_wait();  // every block has started\n{_stamp(17)}"),
    ("  cluster.sync();  // every block's words are in every block; block 0's header barrier is initialised\n",
     f"  cluster.sync();  // every block's words are in every block; block 0's header barrier is initialised\n{_stamp(18)}"),
    ("  __syncthreads();\n  const Band band = band_of(s, b, h);", f"  __syncthreads();\n{_stamp(19)}  const Band band = band_of(s, b, h);"),
    ("    clear_pads(bits, rows, nk, sw);\n    __syncthreads();\n",
     f"    clear_pads(bits, rows, nk, sw);\n{_stamp(20)}    __syncthreads();\n{_stamp(21)}"),
    ("      warp_runs(s.colbits, w, MAX_GPB, s.g_start, s.g_end, &s.n_g);\n    }\n    __syncthreads();\n",
     f"      warp_runs(s.colbits, w, MAX_GPB, s.g_start, s.g_end, &s.n_g);\n    }}\n    __syncthreads();\n{_stamp(22)}"),
    # only the timeline writes the record
    ("words[i] = (int16_t)word_lane(s, i / WORD_I16, i % WORD_I16);", "(void)words;  // probe"),
    ("  __syncwarp();\n  const uint64_t rows =", f"  __syncwarp();\n{_stamp(9, 'threadIdx.x')}  const uint64_t rows ="),
    ("  if (!ok) return;\n\n  // Canonical", f"  if (!ok) return;\n{_stamp(10, 'threadIdx.x')}\n  // Canonical"),
    ("  const bool unit = norm > 1e-6f;\n", f"  const bool unit = norm > 1e-6f;\n{_stamp(11, 'threadIdx.x')}"),
    ("  if (lane == 0) {\n    s.chr[j] = best_t;", f"{_stamp(12, 'threadIdx.x')}  if (lane == 0) {{\n    s.chr[j] = best_t;"),
    ("    if (tid < HDR_I16) out[tid] = (int16_t)header_lane(s, T, tid);\n  }\n}",
     "  }\n"
     "  if (tid == 0) {  // probe\n"
     "    s.probe_t[7] = clock64();\n"
     "    int* t32 = reinterpret_cast<int*>(out) + 24 * rank;\n"
     "    for (int k = 0; k < 7; ++k) t32[k] = (int)(s.probe_t[k + 1] - s.probe_t[k]);\n"
     "    t32[7] = (int)(s.probe_t[8] - s.probe_t[3]);\n"
     "    for (int k = 8; k < 12; ++k) t32[k] = s.probe_t[k + 1] && s.probe_t[k] ? (int)(s.probe_t[k + 1] - s.probe_t[k]) : -1;\n"
     "    t32[12] = (int)(s.probe_t[14] - s.probe_t[13]);\n"
     "    t32[13] = (int)(s.probe_t[15] - s.probe_t[1]);\n"
     "    for (int k = 14; k < 18; ++k) t32[k] = (int)(s.probe_t[k + 2] - s.probe_t[k + 1]);\n"
     "    t32[18] = (int)(s.probe_t[20] - s.probe_t[2]);\n"
     "    for (int k = 19; k < 21; ++k) t32[k] = (int)(s.probe_t[k + 2] - s.probe_t[k + 1]);\n"
     "  }\n}"),
]


def timeline(fn, text: torch.Tensor) -> dict:
    """{frame: {block: {part: cycles}}} from one call of the timeline build."""
    from .ops import scales_device as sd

    fn()
    torch.cuda.synchronize()
    t32 = fn().view(torch.int32).reshape(text.shape[0], -1)[:, : 24 * sd.CLUSTER].reshape(text.shape[0], sd.CLUSTER, 24)
    names = [PHASES[k] for k in range(7)] + list(TIMELINE_PARTS)
    return {b: {r: dict(zip(names, t32[b, r, : len(names)].tolist())) for r in range(sd.CLUSTER)}
            for b in range(text.shape[0])}
# The steps of one frame's chain that the design cannot overlap: the launch
# (an empty kernel of the same shape), a load round trip in each of the row
# pass and the staging pass, two cluster-scope synchronisations (the row
# bits' exchange, block 0's wait for the band blocks: mbarriers, each timed
# as a cluster barrier), and the one-warp word grouping. (The templates'
# copy overlaps the row pass; the windows and bar rows read shared memory.)
CHAIN_STEPS = {"launch": 1, "dependent load": 2, "cluster barrier": 2, "word grouping": 1}


def patched(csrc: pathlib.Path, patches: list) -> dict:
    """{SOURCE: text} with the patches applied."""
    return _probe.patched(csrc, (SOURCE,), {SOURCE: patches})


def call(lib, text: torch.Tensor, sbool: torch.Tensor, tpl: torch.Tensor):
    """A zero-argument launch of one library's entry on [B, H, W] planes
    into an output allocated here; returns the i16 [B, REC_I16] records."""
    from .ops import scales_device as sd

    bsz, h, w = text.shape
    out = torch.empty((bsz, sd.REC_I16), dtype=torch.int16, device=text.device)
    budget = sd.scan_budget(w)

    def fn():
        code = lib.smh_scales_read(text.data_ptr(), text.stride(0), sbool.data_ptr(), sbool.stride(0),
                                   tpl.data_ptr(), tpl.shape[0], h, w, bsz, budget, out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_scales_read")
        return out

    return fn


def chain_floor(text: torch.Tensor, sbool: torch.Tensor, tpl: torch.Tensor, profile, libs=None) -> dict:
    """The chain floor on these planes: each step of CHAIN_STEPS timed on the
    card (profile: chip_smoke.device_profile) and counted. libs: {variant:
    library} holding "as built", "ablation: empty" and the CHAIN variants,
    built here when None."""
    names = ("as built", "ablation: empty", *CHAIN)
    if libs is None:
        libs = _probe.build({n: patched(_build.CSRC, VARIANTS[n]) for n in (*names, CHASE)}, (SOURCE,))
    us = {n: profile(call(libs[n], text, sbool, tpl), n=50)["us"] for n in names}
    latency = {"launch": us["ablation: empty"], "dependent load": load_latency_us(libs[CHASE], profile, text.device)}
    for name, (n, step, _patches) in CHAIN.items():
        latency[step] = (us[name] - us["as built"]) / n
    floor = sum(k * latency[step] for step, k in CHAIN_STEPS.items())
    return {"kernel_us": us["as built"], "latency_us": latency, "steps": CHAIN_STEPS, "floor_us": floor}


def host_us(fn, n: int = 200) -> float:
    """Host us per call to enqueue (no synchronisation inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def strided(planes: list, dev: torch.device) -> tuple:
    """[B, H, W] text and sbool views of the rows of two buffers whose rows
    lie H * W + 37 and H * W + 11 bytes apart (odd frame strides)."""
    h, w = planes[0][0].shape
    bsz = len(planes)
    t_rows = torch.zeros((bsz, h * w + 37), dtype=torch.bool, device=dev)
    s_rows = torch.ones((bsz, h * w + 11), dtype=torch.bool, device=dev)
    t = t_rows[:, : h * w].view(bsz, h, w)
    s = s_rows[:, : h * w].view(bsz, h, w)
    for i, (a, b) in enumerate(planes):
        t[i] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        s[i] = torch.from_numpy(np.ascontiguousarray(b)).to(dev)
    return t, s


def inputs(dev: torch.device) -> dict:
    """{label: (text, sbool)} [B, H, W] bool planes on the card."""
    import chip_smoke as cs

    rng = np.random.default_rng(11)
    out = {}
    for fw, fh in ((1920, 1080), (3840, 2160)):
        vt, vs = cs.brq_planes(cs.frame_for(fw, fh))
        h, w = vt.shape
        out[f"verify {h}x{w}"] = strided([(vt, vs)], dev)
        out[f"random {h}x{w}"] = strided([cs.random_scales_planes(rng, h, w)], dev)
        for bsz in (3, 8):
            planes = [(vt, vs) if i % 3 == 0 else cs.random_scales_planes(rng, h, w) for i in range(bsz)]
            out[f"{h}x{w} B={bsz}"] = strided(planes, dev)
    return out


VARIANT_INPUTS = ("verify 411x493", "verify 822x986", "411x493 B=8")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=pathlib.Path, help="a checkout whose smh_tpu_torch/csrc to time beside")
    ap.add_argument("--out", type=pathlib.Path, help="write the full JSON (every block's timeline) to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_scales_read needs a CUDA device")
    import chip_smoke as cs
    from .ops import scales_device as sd

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    builds = {name: patched(_build.CSRC, p) for name, p in VARIANTS.items()}
    if args.against:
        csrc = args.against / "smh_tpu_torch" / "csrc"
        builds = {"against": patched(csrc, []), **builds,
                  **{f"against {name}": patched(csrc, p) for name, p in AGAINST_STOPS.items()}}
    t0 = time.perf_counter()
    libs = _probe.build(builds, (SOURCE,), ptxas_of="as built")
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    tpl = sd.templates_to_device(sd.device_templates(), dev)
    score = torch.from_numpy(sd.score_lanes()).to(dev)
    summary = []
    timelines = {}
    inputs_by_label = inputs(dev)
    for label, (text, sbool) in inputs_by_label.items():
        want = sd.scales_records_plain(text, sbool, tpl).int()
        fns = {n: call(lib, text, sbool, tpl) for n, lib in libs.items()}
        for name, fn in fns.items():
            if "ablation" in name or name.startswith(("chain", "timeline")):
                continue
            got = fn().int()
            torch.cuda.synchronize()
            off = int((got[:, ~score] != want[:, ~score]).sum())
            err = int((got[:, score] - want[:, score]).abs().max())
            if off or err > 1:
                raise RuntimeError(f"{name} != plain at {label}: {off} lanes differ, score lanes by {err}")
        if label not in VARIANT_INPUTS:
            fns = {n: fn for n, fn in fns.items() if n in ("against", "as built")}
        if TIMELINE in fns:
            tl = timeline(fns.pop(TIMELINE), text)
            clock = torch.cuda.get_device_properties(dev).clock_rate / 1e3  # MHz, the rated clock
            worst = {part: max(tl[b][r][part] for b in tl for r in tl[b]) for part in tl[0][0]}
            print(f"{label}: timeline, cycles per phase, the slowest block of any frame (us at {clock:.0f} MHz): "
                  + ", ".join(f"{part} {c} ({c / clock:.2f})" for part, c in worst.items()), flush=True)
            timelines[label] = {"worst": worst, "frames": tl}
        fns = {n: fn for n, fn in fns.items() if not n.startswith("chain")}
        order = (["against"] if "against" in fns else []) + ["as built"]
        order = order + order[::-1] + [n for n in fns if n not in order]
        times = {n: [] for n in fns}
        launches, host = {}, {}
        for name in order:
            prof = cs.device_profile(fns[name], n=50)
            times[name].append(prof["us"])
            launches[name] = prof["launches"]
        for name in ("against", "as built"):
            if name in fns:
                host[name] = host_us(fns[name])
        row = {"input": label, "batch": text.shape[0], "device_us": times, "launches_per_call": launches,
               "host_us": host, "card": card}
        summary.append(row)
        print(f"{label}: device us per call: "
              + "; ".join(f"{n} " + " / ".join(f"{t:.2f}" for t in ts) + f" ({launches[n]:.0f} launches"
                          + (f", host {host[n]:.1f} us)" if n in host else ")") for n, ts in times.items()),
              flush=True)
    text, sbool = inputs_by_label["verify 411x493"]
    chain = chain_floor(text, sbool, tpl, cs.device_profile, libs)
    print("chain floor at verify 411x493: " + " + ".join(
        f"{k} x {step} {chain['latency_us'][step]:.3f}" for step, k in CHAIN_STEPS.items())
        + f" = {chain['floor_us']:.2f} us beside the kernel's {chain['kernel_us']:.2f} us", flush=True)
    full = {"inputs": summary, "phases": PHASES, "chain": chain, "timelines": timelines}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(full))
    print(json.dumps({**full, "timelines": {label: t["worst"] for label, t in timelines.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
