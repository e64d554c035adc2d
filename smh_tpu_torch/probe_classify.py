"""Device time of the classify and fused mask kernels, variant by variant
and against another build of the same entry points, on the card.

    python -m smh_tpu_torch.probe_classify [--against DIR]

Run from the root of a checkout (the inputs come from chip_smoke.py). Builds
csrc/classify_luma.cu and csrc/fused_mask.cu as they are, with their shape
constants changed and with parts switched off (VARIANTS), and with
--against the same two sources from DIR/smh_tpu_torch/csrc (an unpacked
archive of another commit whose C entry points take the batch strides,
as these do), each build into its own library under
smh_tpu_torch/build/probe-*, one nvcc per build, all started together.
Every build but the ablations must give the plain twins' bytes on every
input. Then, in
turns (against, the builds, the builds again, against), each build's
device time per call (torch.profiler, the kernel's own row) on uniform
random planes and on the verify frame's map ROI at the two map shapes of
1080p and 4K, in the main path's layout, beside the share of pixels past
the classify's max-byte mask. Prints one line per (shape, input) and a
JSON summary last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib

import numpy as np
import torch

from . import _build, _probe
from .ops import kernels as K

SOURCES = ("classify_luma.cu", "fused_mask.cu")
# {variant: {file: [(text, replacement), ...]}}; each build holds both kernels.
_CL, _FM = "classify_luma.cu", "fused_mask.cu"
_HD = "classify.cuh"
_COPY = "  smh::load_tables(tab, tables);  // first: its latency hides under the plane loads'\n"
_TABLES_ONLY = {
    _CL: [("  uint32_t rgb[PX];", "  if (n > 0) return;\n  uint32_t rgb[PX];")],
    _FM: [("  const uint32_t marked = smh::marker_bits<ITEMS + 1>(",
           "  if (H > 0) return;\n  const uint32_t marked = smh::marker_bits<ITEMS + 1>(")],
}
_IN_PLACE_TAIL = """  uint32_t bits = 0;
  if (total > 32) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      bits |= (((pass >> k) & 1u) & (uint32_t)marker_past_mask(rgb[k] & 0xff, (rgb[k] >> 8) & 0xff, rgb[k] >> 16, t))
              << k;  // no branch: the pixels' divisions interleave
    return bits;
  }
  int pos[N];  // this lane's pixels' places in the list
  int at = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    pos[k] = at + __popc(bal[k] & below);
    if ((pass >> k) & 1u) scratch[pos[k]] = rgb[k];
    at += __popc(bal[k]);
  }
  __syncwarp();
  bool v = false;
  if (lane < total) {
    const uint32_t c = scratch[lane];
    v = marker_past_mask(c & 0xff, (c >> 8) & 0xff, c >> 16, t);
  }
  const uint32_t verdict = __ballot_sync(full, v);  // bit j: list entry j is a marker
#pragma unroll
  for (int k = 0; k < N; ++k)
    if ((pass >> k) & 1u) bits |= ((verdict >> pos[k]) & 1u) << k;
"""
_ROUNDS_TAIL = """  uint32_t bits = 0;
  int pos[N];
  int at = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    pos[k] = at + __popc(bal[k] & below);
    if ((pass >> k) & 1u) scratch[pos[k]] = rgb[k];
    at += __popc(bal[k]);
  }
  __syncwarp();
  uint32_t* verdict = scratch + 32 * N;
  for (int j0 = 0; j0 < total; j0 += 32) {
    bool v = false;
    if (j0 + lane < total) {
      const uint32_t c = scratch[j0 + lane];
      v = marker_past_mask(c & 0xff, (c >> 8) & 0xff, c >> 16, t);
    }
    const uint32_t word = __ballot_sync(full, v);
    if (lane == 0) verdict[j0 >> 5] = word;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < N; ++k)
    if ((pass >> k) & 1u) bits |= ((verdict[pos[k] >> 5] >> (pos[k] & 31)) & 1u) << k;
"""
VARIANTS = {
    "as built": {},
    "lane per pixel": {_HD: [("  if (total > 32) {", "  if (total > 0) {")]},
    "classify 8 blocks a SM": {_CL: [("__launch_bounds__(THREADS, 6)", "__launch_bounds__(THREADS, 8)")]},
    "fused 6 blocks a SM": {_FM: [("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 6)")]},
    "divisions with __fdiv_rn": {_HD: [
        ("div_rn(__fmul_rn(100.0f, delta), mx8 > 0 ? mx : 1.0f)", "__fdiv_rn(__fmul_rn(100.0f, delta), mx8 > 0 ? mx : 1.0f)"),
        ("div_rn(num, mx8 != mn8 ? delta : 1.0f)", "__fdiv_rn(num, mx8 != mn8 ? delta : 1.0f)")]},
    "in place with a branch per pixel": {_HD: [(
        "      bits |= (((pass >> k) & 1u) & (uint32_t)marker_past_mask(rgb[k] & 0xff, (rgb[k] >> 8) & 0xff, rgb[k] >> 16, t))\n"
        "              << k;",
        "      if ((pass >> k) & 1u) bits |= (uint32_t)marker_past_mask(rgb[k] & 0xff, (rgb[k] >> 8) & 0xff, rgb[k] >> 16, t)"
        " << k;")]},
    "tables in global memory": {
        _CL: [("  __shared__ smh::ClassifyTables tab;", "  const smh::ClassifyTables& tab = *tables;"),
              (_COPY, ""), ("  __syncthreads();  // the tables\n", "")],
        _FM: [("  __shared__ smh::ClassifyTables tab;", "  const smh::ClassifyTables& tab = *tables;"),
              (_COPY, ""), ("  __syncthreads();  // the tables\n", "")]},
    "classify PX=16": {_CL: [("constexpr int PX = 4;", "constexpr int PX = 16;")]},
    "fused 32x128": {_FM: [("constexpr int TH = 16;", "constexpr int TH = 32;")]},
    "mx and mn by fmaxf / fminf, not table reads": {_HD: [(
        "  const float mx = t.unit[mx8];\n  const float delta = __fsub_rn(mx, t.unit[mn8]);",
        "  const float mx = fmaxf(r, fmaxf(g, b));\n  const float delta = __fsub_rn(mx, fminf(r, fminf(g, b)));")]},
    "compaction in rounds, never in place": {
        _CL: [("  __shared__ uint32_t scratch[THREADS / 32][32];", "  __shared__ uint32_t scratch[THREADS / 32][33 * PX];")],
        _FM: [("  __shared__ uint32_t scratch[WARPS][32];", "  __shared__ uint32_t scratch[WARPS][33 * (ITEMS + 1)];")],
        _HD: [(_IN_PLACE_TAIL, _ROUNDS_TAIL)]},
    "classify PX=8": {_CL: [("constexpr int PX = 4;", "constexpr int PX = 8;")]},
    "fused 12 warps": {_FM: [("constexpr int THREADS = 256;", "constexpr int THREADS = 384;")]},
    "fused 16x64, 4 warps": {_FM: [("constexpr int WPR = 4;", "constexpr int WPR = 2;"),
                                   ("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")]},
    # Ablations (wrong bytes, time only): no work past the max-byte mask;
    # nothing after the tables (the launch, the tables' copy into shared
    # memory, the barrier); an empty kernel of the same grid.
    "ablation: no work past the mask": {
        _HD: [("  if (!__any_sync(full, pass != 0)) return 0;", "  if (__any_sync(full, pass != 0) || true) return 0;")]},
    "ablation: tables only": _TABLES_ONLY,
    "ablation: fused, no dilate or store": {_FM: [("  if (tid >= TH * WPR) return;",
                                                   "  if (tid >= TH * WPR || H > 0) return;")]},
    "ablation: tables copy only": {
        _CL: [(_COPY, _COPY + "  if (n > 0) {\n    __syncthreads();\n    return;\n  }\n")],
        _FM: [(_COPY, _COPY + "  if (H > 0) {\n    __syncthreads();\n    return;\n  }\n")]},
    "ablation: pixel loads only": {
        _CL: [("  __syncthreads();  // the tables\n",
               "  if (n > 0) {\n    if ((rw[0] ^ gw[0] ^ bw[0]) == 0x12345678u) marker[0] = 1;\n    return;\n  }\n"
               "  __syncthreads();  // the tables\n")],
        _FM: [("  __syncthreads();  // the tables\n",
               "  if (H > 0) {\n    uint32_t acc = 0;\n    for (int i = 0; i <= ITEMS; ++i) acc ^= rgb[i];\n"
               "    if (acc == 0x12345678u) bits[0] = 1;\n    return;\n  }\n  __syncthreads();  // the tables\n")]},
    "ablation: empty": {
        _CL: [("  __shared__ uint32_t scratch[THREADS / 32][32];\n", "  __shared__ uint32_t scratch[THREADS / 32][32];\n  if (n > 0) return;\n")],
        _FM: [("  __shared__ uint32_t scratch[WARPS][32];\n", "  __shared__ uint32_t scratch[WARPS][32];\n  if (H > 0) return;\n")]},
}


def patched(csrc: pathlib.Path, patches: dict) -> dict:
    """{file name: text} of the two sources and the shared header."""
    return _probe.patched(csrc, (*SOURCES, _HD), patches)


def build(builds: dict) -> dict:
    """{build: {file name: text}} -> {build: ctypes library}."""
    return _probe.build(builds, SOURCES)


def calls(lib, r8, g8, b8) -> dict:
    """{kernel: zero-argument launch} of one library on (r, g, b) planes,
    into outputs allocated here; each returns its outputs."""
    h, w = r8.shape
    marker, luma = torch.empty_like(r8), torch.empty_like(r8)
    bits = torch.empty((h, (w + 7) // 8), dtype=torch.uint8, device=r8.device)
    params = ctypes.addressof(K._CLASSIFY_PARAMS)
    tables = None
    if hasattr(lib, "smh_classify_tables"):  # this build classifies from tables on the device
        tables = torch.empty(lib.smh_classify_tables_bytes(), dtype=torch.uint8, device=r8.device)
        _build.check(lib.smh_classify_tables(tables.data_ptr(), params, torch.cuda.current_stream().cuda_stream),
                     "smh_classify_tables")
        params = tables.data_ptr()

    def classify(_tables=tables):  # the closures keep the tables alive
        code = lib.smh_classify_luma(r8.data_ptr(), g8.data_ptr(), b8.data_ptr(), marker.data_ptr(),
                                     luma.data_ptr(), r8.numel(), 1, r8.numel(), r8.numel(), params,
                                     torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_classify_luma")
        return marker, luma

    def fused(_tables=tables):
        code = lib.smh_fused_mask(r8.data_ptr(), g8.data_ptr(), b8.data_ptr(), bits.data_ptr(), h, w, 1,
                                  r8.numel(), bits.numel(), params, torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_fused_mask")
        return (bits,)

    return {"classify_luma": classify, "fused_mask": fused}


def device_us(fn, kernel: str, n: int = 50) -> float:
    """The kernel's own profiler row, us per call, over n calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    return sum(e.self_device_time_total for e in rows) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=pathlib.Path, help="a checkout whose smh_tpu_torch/csrc to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_classify needs a CUDA device")
    import chip_smoke as cs
    from . import consts as C

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    builds = {name: patched(_build.CSRC, p) for name, p in VARIANTS.items()}
    if args.against:
        builds = {"against": patched(args.against / "smh_tpu_torch" / "csrc", {}), **builds}
    libs = build(builds)
    order = list(libs)
    order = order + order[::-1] if args.against is None else ["against", *order[1:], *order[1:], "against"]
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    summary = []
    for w, h in ((1920, 1080), (3840, 2160)):
        gm = C.map_geometry(w, h)
        for input_name, rgb in cs.map_inputs(rng, w, h).items():
            p = cs.flat_planes(rgb, dev)
            want = {"classify_luma": K.classify_luma_planes_plain(*p), "fused_mask": (K.fused_mask_bits_plain(*p),)}
            share = cs.mask_share(rgb)
            per = {name: calls(lib, *p) for name, lib in libs.items()}
            for name, fns in per.items():
                if name.startswith("ablation"):
                    continue
                for kernel, fn in fns.items():
                    got = fn()
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, want[kernel])):
                        raise RuntimeError(f"{name} {kernel} != plain at {gm.map_h}x{gm.map_w} {input_name}")
            times = {k: {name: [] for name in libs} for k in ("classify_luma", "fused_mask")}
            for name in order:
                for kernel, fn in per[name].items():
                    times[kernel][name].append(device_us(fn, kernel.split("_")[0]))
            for kernel, by in times.items():
                row = {"kernel": kernel, "shape": f"{gm.map_h}x{gm.map_w}", "input": input_name,
                       "mask_share": share, "device_us": by, "card": card}
                summary.append(row)
                print(f"{kernel} {gm.map_h}x{gm.map_w} {input_name} ({100 * share:.2f} % past the mask), "
                      "device us per call in turns: "
                      + "; ".join(f"{n} " + " / ".join(f"{t:.2f}" for t in ts) for n, ts in by.items()),
                      flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
