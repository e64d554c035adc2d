"""Device time of the ray march kernel, variant by variant and against
another build of the same entry point, on the card.

    python -m smh_tpu_torch.probe_ray_march [--against DIR]

Run from the root of a checkout (the masks come from chip_smoke.py). Builds
csrc/ray_march.cu as it is and patched (VARIANTS: other designs and
constants; ablations, which switch parts off; checks, which swap one
ordering or memory operation of the reduction for another), and with
--against the same source from DIR/smh_tpu_torch/csrc (an unpacked archive
of another commit), each into its own library under
smh_tpu_torch/build/probe-*, one nvcc per build, all started together.
Every build but the ablations and the checks must give the plain twin's
ends, winners and lengths bit for bit on every input; for a check the
probe prints which outputs differ, and on how many seeds.

Inputs: chip_smoke.py's line masks at the map shapes of 1080p and 4K, B = 1,
8 and 16 seeds (half on drawn lines, the rest background), max_len None and
the mask's diagonal. In turns (against, as built, as built, against) on
every input, and the variants, ablations and checks on B = 8: device us per
call (torch.profiler, the call's CUDA rows), CUDA launches per call, and
host us per call to enqueue. Prints one line per input and a JSON summary
last.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from . import _build, _probe

SOURCE = "ray_march.cu"
_LC = "constexpr int LANE_CHUNKS = 1;"
_WW = "constexpr int WARP_WORDS = 4;"
_THREAD_ONLY = ("    if (item >= total) break;\n", "    if (item >= 0) break;\n")
_BIT_PLANE = ("  return __ldg(mask + (int64_t)cy * W + cx);\n",
              "  const int stride = (W + 7) >> 3;  // MSB first, rows padded to bytes\n"
              "  return ((__ldg(mask + (int64_t)cy * stride + (cx >> 3)) >> (7 - (cx & 7))) & 1u) ? 255u : 0u;\n")
_LANE_WORD = ("      lane_word<0, WORD>(mask, H, W, r, k0, white, inb, black);\n"
              "      const uint32_t live = word_live(inb, valid, out);\n"
              "      kind = word_event(white, live, out, valid, word_runs(~white & live, window), window, carry, j);\n")
# The steps past the word's first half taken as white and in the plane: an
# event (or the bound) in the first half stands; else the rest is loaded.
_HALF_FIRST = ("      lane_word<0, WORD / 2>(mask, H, W, r, k0, white, inb, black);\n"
               "      const uint32_t up = FULL << (WORD / 2);\n"
               "      int c2 = carry;\n"
               "      const uint32_t half = word_live(inb | up, valid, out);\n"
               "      kind = word_event(white | up, half, out, valid, word_runs(~(white | up) & half, window), window, c2, j);\n"
               "      if (kind == EV_NONE || (kind == EV_ALIVE ? valid > WORD / 2 : j >= WORD / 2)) {\n"
               "        lane_word<WORD / 2, WORD>(mask, H, W, r, k0, white, inb, black);\n"
               "        const uint32_t live = word_live(inb, valid, out);\n"
               "        kind = word_event(white, live, out, valid, word_runs(~white & live, window), window, carry, j);\n"
               "      }\n")
_COUNTER = ("  for (;;) {\n    int next = 0;\n    if (lane == 0) next = atomicAdd(head, 1);\n"
            "    const int item = __shfl_sync(FULL, next, 0);\n")
_HEAD = "  int* head = cluster.map_shared_rank(&q_head, 0);\n"
_PREFETCH = ("        vn[w] = sample(mask, H, W, r, k0 + (WARP_WORDS + w) * WORD + lane, inn[w]);\n",
             "          v[w] = vn[w];\n          in[w] = inn[w];\n")
_KEY_STORE = "  if (threadIdx.x == 0) *cluster.map_shared_rank(s_keys + rank, 0) = s_key;\n"
_KEYS_MAX = "    for (int r = 0; r < CLUSTER; ++r) best = max_key(best, s_keys[r]);\n"
# {variant: [(text, replacement), ...]} on ray_march.cu.
VARIANTS = {
    "as built": [],
    "a thread a lane throughout": [(_LC, "constexpr int LANE_CHUNKS = 1 << 20;")],
    "a warp a ray throughout": [(_LC, "constexpr int LANE_CHUNKS = 0;")],
    "a warp a ray throughout, 1 word a round": [(_LC, "constexpr int LANE_CHUNKS = 0;"),
                                                (_WW, "constexpr int WARP_WORDS = 1;")],
    "threads take 2 words": [(_LC, "constexpr int LANE_CHUNKS = 2;")],
    "warps take 1 word a round": [(_WW, "constexpr int WARP_WORDS = 1;")],
    "warps take 2 words a round": [(_WW, "constexpr int WARP_WORDS = 2;")],
    "warps take 8 words a round": [(_WW, "constexpr int WARP_WORDS = 8;")],
    "bit plane": [_BIT_PLANE],
    "survivors stay in their block": [
        ("  if (lane < CLUSTER) count = *cluster.map_shared_rank(&q_count, lane);\n",
         "  if (lane < CLUSTER) count = lane == rank ? q_count : 0;\n"),
        (_HEAD, "  int* head = &q_head;\n")],
    "no prefetch of the next warp round": [(_PREFETCH[0], "        vn[w] = 0u, inn[w] = false;\n"),
                                           (_PREFETCH[1], "          v[w] = sample(mask, H, W, r, k0 + w * WORD + lane, in[w]);\n")],
    "threads test 16 steps before the rest": [(_LANE_WORD, _HALF_FIRST)],
    "survivors round robin, no counter": [
        (_HEAD, ""), (_COUNTER, "  for (int item = rank * (blockDim.x >> 5) + (threadIdx.x >> 5);; item += CLUSTER * (blockDim.x >> 5)) {\n")],
    # Checks: the same function by another ordering or memory operation.
    "check: block keys by a 64-bit atomicMax into block 0": [
        (_KEY_STORE, "  if (threadIdx.x == 0 && rank != 0) atomicMax(cluster.map_shared_rank(&s_key, 0), s_key);\n"),
        (_KEYS_MAX, "    best = s_key;\n")],
    "check: the same atomicMax, its old value kept": [
        (_KEY_STORE, "  if (threadIdx.x == 0 && rank != 0) s_keys[rank] = atomicMax(cluster.map_shared_rank(&s_key, 0), s_key);\n"),
        (_KEYS_MAX, "    best = s_key;\n")],
    "check: the same atomicMax, one block at a time": [
        (_KEY_STORE, "  for (int turn = 1; turn < CLUSTER; ++turn) {\n"
                     "    if (threadIdx.x == 0 && rank == turn) atomicMax(cluster.map_shared_rank(&s_key, 0), s_key);\n"
                     "    cluster.sync();\n"
                     "  }\n"),
        (_KEYS_MAX, "    best = s_key;\n")],
    "check: every block's key by that atomicMax into a word no block updates locally": [
        ("    s_key = 0ull;\n", "    s_key = 0ull;\n    s_keys[0] = 0ull;\n"),
        (_KEY_STORE, "  if (threadIdx.x == 0) atomicMax(cluster.map_shared_rank(s_keys, 0), s_key);\n"),
        (_KEYS_MAX, "    best = s_keys[0];\n")],
    "check: block keys by a 64-bit atomicCAS loop into block 0": [
        (_KEY_STORE, "  if (threadIdx.x == 0 && rank != 0) {\n"
                     "    unsigned long long* dst = cluster.map_shared_rank(&s_key, 0);\n"
                     "    for (unsigned long long seen = 0ull; seen < s_key;) {\n"
                     "      const unsigned long long prev = atomicCAS(dst, seen, s_key);\n"
                     "      if (prev == seen) break;\n"
                     "      seen = prev;\n"
                     "    }\n"
                     "  }\n"),
        (_KEYS_MAX, "    best = s_key;\n")],
    "check: block keys by atom.shared::cluster.max.u64": [
        (_KEY_STORE, "  if (threadIdx.x == 0 && rank != 0) {\n"
                     "    uint32_t at;\n"
                     "    unsigned long long old;\n"
                     "    asm volatile(\"mapa.shared::cluster.u32 %0, %1, %2;\" : \"=r\"(at) : \"r\"((uint32_t)__cvta_generic_to_shared(&s_key)), \"r\"(0));\n"
                     "    asm volatile(\"atom.shared::cluster.max.u64 %0, [%1], %2;\" : \"=l\"(old) : \"r\"(at), \"l\"(s_key) : \"memory\");\n"
                     "  }\n"),
        (_KEYS_MAX, "    best = s_key;\n")],
    "check: the winner's end by a plain load": [("__ldcg(ex_row + a)", "ex_row[a]"), ("__ldcg(ey_row + a)", "ey_row[a]")],
    # Ablations (best_* unwritten or nothing computed; time only).
    "ablation: no reduction": [("  // -- the seed's best", "  if (H > 0) {\n    cluster.sync();\n    return;\n  }\n  // -- the seed's best")],
    "ablation: the thread phase only": [_THREAD_ONLY],
    "ablation: barriers only": [_THREAD_ONLY, ("a < a1; a += blockDim.x) {", "a < a1 && H < 0; a += blockDim.x) {")],
    "ablation: empty": [("  const int b = blockIdx.y;\n", "  if (H > 0) return;\n  const int b = blockIdx.y;\n")],
}


def patched(csrc: pathlib.Path, patches: list) -> dict:
    """{SOURCE: text} with the patches applied."""
    return _probe.patched(csrc, (SOURCE,), {SOURCE: patches})


def call(lib, plane, h, w, pts, mg, k_total, cos_t, sin_t):
    """A zero-argument launch of one library's entry into outputs allocated
    here; returns (end_x, end_y, best_x, best_y, best_len)."""
    bsz, n = pts.shape[0], cos_t.numel()
    end_x = torch.empty((bsz, n), dtype=torch.float32, device=pts.device)
    end_y = torch.empty_like(end_x)
    best = torch.empty((3, bsz), dtype=torch.float32, device=pts.device)

    def fn():
        code = lib.smh_ray_march(plane.data_ptr(), h, w, pts.data_ptr(), bsz, cos_t.data_ptr(), sin_t.data_ptr(), n,
                                 mg, k_total, end_x.data_ptr(), end_y.data_ptr(), best[0].data_ptr(),
                                 best[1].data_ptr(), best[2].data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_ray_march")
        return end_x, end_y, best[0], best[1], best[2]

    return fn


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


def inputs(dev: torch.device):
    """{label: (u8 mask, bit plane, seeds f32 [B, 2], max_len)} over the
    map shapes of 1080p and 4K."""
    import chip_smoke as cs
    from . import consts as C

    rng = np.random.default_rng(2)
    out = {}
    for w, h in ((1920, 1080), (3840, 2160)):
        gm = C.map_geometry(w, h)
        mask = cs.line_mask(gm.map_h, gm.map_w, cs.ray_march_lines(w, h))
        bits = torch.from_numpy(np.packbits(mask == 255, axis=1)).to(dev)  # MSB first, rows padded
        mask_t = torch.from_numpy(mask).to(dev)
        diag = float(np.hypot(*mask.shape)) + 1.0
        for b in (1, 8, 16):
            pts = torch.from_numpy(cs.ray_march_seeds(rng, mask, b, edge=False)).to(dev)
            for max_len in (None, diag):
                label = f"{gm.map_h}x{gm.map_w} B={b} max_len={'None' if max_len is None else 'diag'}"
                out[label] = (mask_t, bits, pts, max_len)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=pathlib.Path, help="a checkout whose smh_tpu_torch/csrc to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_ray_march needs a CUDA device")
    import chip_smoke as cs
    from . import consts as C
    from .ops import lsd as L

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    builds = {name: patched(_build.CSRC, p) for name, p in VARIANTS.items()}
    if args.against:
        builds = {"against": patched(args.against / "smh_tpu_torch" / "csrc", []), **builds}
    t0 = time.perf_counter()
    libs = _probe.build(builds, (SOURCE,), ptxas_of="as built")
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    cos_t, sin_t = L.theta_tables(dev)
    mg = int(C.LSD_MAX_GAP)
    summary = []
    parts = ("end_x", "end_y", "best_x", "best_y", "best_len")
    checks = {n: {} for n in libs if n.startswith("check")}
    for label, (mask_t, bits, pts, max_len) in inputs(dev).items():
        h, w = mask_t.shape
        k_total = L.step_bound(h, w, mg, max_len)
        ex, ey = L.march_plain(mask_t, pts, mg, k_total, cos_t, sin_t)
        want = (ex, ey, *L.finalize_plain(pts, ex, ey))
        fns = {n: call(lib, bits if n == "bit plane" else mask_t, h, w, pts, mg, k_total, cos_t, sin_t)
               for n, lib in libs.items()}
        for name, fn in fns.items():
            if name.startswith("ablation"):
                continue
            # A check may race: 10 calls, and per output the most elements
            # (lanes or seeds) that differed in one call.
            worst = {}
            for _ in range(10 if name in checks else 1):
                got = fn()
                torch.cuda.synchronize()
                for part, g, w_ in zip(parts, got, want):
                    worst[part] = max(worst.get(part, 0), int((g != w_).sum()))
            if name in checks:
                checks[name][label] = worst
            elif any(worst.values()):
                raise RuntimeError(f"{name} != plain at {label}: elements that differ {worst}")
        if "B=8" not in label:
            fns = {n: fn for n, fn in fns.items() if n in ("against", "as built")}
        order = (["against"] if "against" in fns else []) + [n for n in fns if n != "against"]
        order = order + order[::-1]
        times = {n: [] for n in fns}
        launches, host = {}, {}
        for name in order:
            prof = cs.device_profile(fns[name], n=50)
            us, per_call = prof["us"], prof["launches"]
            times[name].append(us)
            launches[name] = per_call
        for name, fn in fns.items():
            host[name] = host_us(fn)
        longest = float(want[4].max().sqrt())
        row = {"input": label, "k_total": k_total, "longest_ray_px": longest, "device_us": times,
               "launches_per_call": launches, "host_us": host, "card": card}
        summary.append(row)
        print(f"{label} k_total={k_total} longest ray {longest:.1f} px; device us per call in turns: "
              + "; ".join(f"{n} " + " / ".join(f"{t:.2f}" for t in ts) + f" ({launches[n]:.0f} launches, host "
                          f"{host[n]:.1f} us)" for n, ts in times.items()), flush=True)
    for name, by in checks.items():
        bad = {label: {k: v for k, v in worst.items() if v} for label, worst in by.items() if any(worst.values())}
        print(f"{name}: " + ("bit-equal to plain on every input, 10 calls each" if not bad else
                             f"differs from plain (most elements in one of 10 calls): {bad}"), flush=True)
    print(json.dumps({"inputs": summary, "checks": checks}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
