"""Kernel 7's device time on the card, its variants and its chain floor;
with --against, beside another tree's kernel, in turns.

Builds csrc/mask_words.cu as it is, with variants that keep its outputs
(1024-word tiles: ROUNDS 2, or blocks of 256 threads; a tile from an
atomic counter, not the block's index, with the bytes staged once the
counter answers or the index's tile's staged while it runs; the
look-back polling 64 ns apart;
a relaxed ticket, with no release or acquire order: the cost of the
order), with parts switched off (an empty kernel of the
same grid; the word writes; the look-back), with longer chains (CHAIN: 32
more block barriers, 32 more dependent global atomics), a pointer chase
for one dependent load and a clock64 timeline of every block (TIMELINE),
and with --against DIR, DIR/smh_tpu_torch/csrc/mask_words.cu (another
commit's kernel: its entry may take no scratch, as its first design's did), each into
its own library under smh_tpu_torch/build/probe-*. Each build that keeps
its outputs is held to the plain twin over two calls (the second shows
that the scratch came back clean), then every build's device time per call
(chip_smoke.device_profile: every CUDA row of the call) and CUDA launches
per call are printed in turns (against, as built and the TOP_VARIANTS,
then the same in reverse; then the other variants) on sparse masks (a marker line's share of non-zero words)
and a dense one at the 1080p and 4K map shapes (822 x 986 and 1644 x
1972), at the sparse ladder's starting budget and at the top rung it can
reach at that shape (top_rung: 8192 and 32768), and on B = 8 sparse
masks at 822 x 986 at 1024 and at BatchPipeline's 2048 ("as built", the
other tree and the TOP_VARIANTS in turns at each; the other variants at
1024 only). Then the chain floor (chain_floor): the
launch, CHAIN_STEPS of each dependent step, beside the kernel. Run from
the root of a checkout (the chase and the profiler come from
probe_scales_read and chip_smoke.py). Needs a CUDA device and nvcc:

    python -m smh_tpu_torch.probe_mask_words [--against DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from . import _build, _probe
from .ops import kernels as K
from .probe_scales_read import CHASE, load_latency_us
from .probe_scales_read import VARIANTS as _SCALES_VARIANTS
from .vision.cuda_backend import _SP_RUNG_DEFAULT, _SPARSE_BUDGETS

SOURCE = _build.CSRC / "mask_words.cu"
START = _SPARSE_BUDGETS[_SP_RUNG_DEFAULT]  # the sparse ladder's starting rung, 1024 words
BATCH_BUDGET = 2048  # vision/batch.py: BatchPipeline's budget, min(2048, mask bytes / 16)


def top_rung(h: int, w: int) -> int:
    """The highest rung of the sparse ladder at an h x w mask
    (CudaBackend._sparse_budget keeps budget * 8 below the mask's bytes)."""
    return max(b for b in _SPARSE_BUDGETS if b * 8 < h * ((w + 7) // 8))


_TILE = "  const int t = blockIdx.x;\n"
_EMPTY = (_TILE, "  if (H > 0) return;  // probe\n" + _TILE)
_BEFORE_WRITE = "  int32_t* idx = out + META;\n"
_AFTER_TICKET = "  if (!s.last) return;\n"
# variant: (patches, keeps the outputs)
VARIANTS = {
    "as built": ((), True),
    "1024-word tiles": ((("constexpr int ROUNDS = 4;", "constexpr int ROUNDS = 2;"),), True),
    "1024-word tiles of 256 threads": ((("constexpr int THREADS = 512;", "constexpr int THREADS = 256;"),), True),
    "a tile from an atomic counter": ((
        (_TILE, "  __shared__ int probe_tile;\n  if (tid == 0) probe_tile = (int)atomicAdd(sc + 1, 1u);  // probe\n"
                "  __syncthreads();\n  const int t = probe_tile;\n"),
        ("  if (tid == 0) sc[0] = 0u;", "  if (tid < 2) sc[tid] = 0u;  // probe")), True),
    "the counter's tile, the index's staged under its round trip": ((
        (_TILE, "  __shared__ int probe_tile;\n  if (tid == 0) probe_tile = (int)atomicAdd(sc + 1, 1u);  // probe\n"
                "  stage(s.bytes, bits, blockIdx.x * tile_rows, min(tile_rows, H - (int)blockIdx.x * tile_rows), bpr, tid);\n"
                "  __syncthreads();\n  const int t = probe_tile;\n"),
        ("  const int lead = stage(s.bytes, bits, row0, rows, bpr, tid);  // the tile's bytes into shared memory\n"
         "  __syncthreads();\n",
         "  const int lead = t == (int)blockIdx.x ? (int)(reinterpret_cast<uintptr_t>(bits + (int64_t)row0 * bpr) & 15)\n"
         "                                        : stage(s.bytes, bits, row0, rows, bpr, tid);  // probe\n"
         "  __syncthreads();\n"),
        ("  if (tid == 0) sc[0] = 0u;", "  if (tid < 2) sc[tid] = 0u;  // probe")), True),
    "ablation: empty": ((_EMPTY,), False),
    "ablation: no word writes": ((("  if (base < budget) {\n", "  if (base < 0) {  // probe\n"),), False),
    "look-back polls 64 ns apart": ((("        if (__any_sync(FULL, lane <= stop && flag == 0u)) continue;",
                                      "        if (__any_sync(FULL, lane <= stop && flag == 0u)) {  // probe\n"
                                      "          __nanosleep(64);\n          continue;\n        }"),), True),
    "ablation: no look-back": ((("      while (true) {\n        const int q = pred - lane;",
                                 "      while (t < 0) {  // probe\n        const int q = pred - lane;"),), False),
    "relaxed ticket": ((("atom.acq_rel.gpu.global.add.u32", "atom.relaxed.gpu.global.add.u32"),), True),
    "release ticket": ((("atom.acq_rel.gpu.global.add.u32", "atom.release.gpu.global.add.u32"),), True),
    "release ticket, acquire fence in the last block": ((
        ("atom.acq_rel.gpu.global.add.u32", "atom.release.gpu.global.add.u32"),
        ("  if (tid == 0) s.last = ticket == (unsigned)tiles - 1u;\n",
         "  if (tid == 0) s.last = ticket == (unsigned)tiles - 1u;\n"
         "  if (tid == 0 && ticket == (unsigned)tiles - 1u) asm volatile(\"fence.acq_rel.gpu;\" ::: \"memory\");  // probe\n")),
        True),
}
# The variants also timed at the top rung, where the empty slots are most.
TOP_VARIANTS = ("relaxed ticket", "a tile from an atomic counter")
# Timing variants that lengthen the chain by N more of one dependent step:
# (time - as built) / N is that step's latency on the card.
CHAIN = {
    "chain: 32 more block barriers": (32, "block barrier", (
        (_BEFORE_WRITE, "  for (int i = 0; i < 32; ++i) __syncthreads();  // probe\n" + _BEFORE_WRITE),)),
    "chain: 32 more dependent atomics": (32, "global atomic", (
        (_AFTER_TICKET, _AFTER_TICKET + "  if (tid == 0) {  // probe\n    uint32_t v = 0u;\n"
                        "    for (int i = 0; i < 32; ++i) v = atomicAdd(sc + 2 + (v >> 31), 0u);\n"
                        "    if (v == 1u) out[0] = 0;\n  }\n"),)),
}
VARIANTS.update({name: (patches, False) for name, (_n, _step, patches) in CHAIN.items()})
VARIANTS[CHASE] = (tuple(_SCALES_VARIANTS[CHASE]), False)
# A timing variant: thread 0 (lane 0 of warp 0 inside the scan) of every
# block stamps clock64() where each step ends, into 16 u64s a block past the
# frames' scratch (TIMELINE_WORDS u32s a tile); its %smid and %globaltimer
# at its start and end. The stamps: 0 start, 1 the tile known, 2 bytes in
# shared memory, 3 words and ballots, 4 count published, 5 look-back done,
# 6 base known to the block, 7 writes and ticket, 8 end (9: the last block's
# bbox and reset); 13 %smid, 14 and 15 %globaltimer (ns) at 0 and 8.
TIMELINE = "timeline: cycles per step per block"
TIMELINE_WORDS = 32
TIMELINE_STEPS = {"bytes": (1, 2), "words": (2, 3), "scan and publish": (3, 4),
                  "look-back": (4, 5), "base to the block": (5, 6), "writes and ticket": (6, 7),
                  "ticket to the end": (7, 8)}
_STAMP = "  if (tid == 0) probe_tl[{k}] = clock64();  // probe\n"
VARIANTS[TIMELINE] = ((
    (_TILE,
     "  const long long probe_c0 = clock64();  // probe\n  unsigned long long probe_g0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(probe_g0));\n" + _TILE),
    (_TILE,
     _TILE + "  unsigned long long* probe_tl = reinterpret_cast<unsigned long long*>(\n"
     "      scratch + ((gridDim.y * (HEAD + STATE * tiles) + 1) & ~1)) + (frame * tiles + t) * 16;  // probe\n"
     "  if (tid == 0) {  // probe\n    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    probe_tl[0] = probe_c0;\n    probe_tl[1] = clock64();\n    probe_tl[13] = sm;\n"
     "    probe_tl[14] = probe_g0;\n  }\n"),
    ("  // the tile's bytes into shared memory\n  __syncthreads();\n",
     "  // the tile's bytes into shared memory\n  __syncthreads();\n" + _STAMP.format(k=2)),
    ("    s.box[warp][3] = x1;\n  }\n  __syncthreads();\n",
     "    s.box[warp][3] = x1;\n  }\n  __syncthreads();\n" + _STAMP.format(k=3)),
    ("    if (lane == 0 && !last_tile) put_state(mine, (t == 0 ? PREFIX : AGGREGATE) | (uint32_t)total, by, bx);\n",
     "    if (lane == 0 && !last_tile) put_state(mine, (t == 0 ? PREFIX : AGGREGATE) | (uint32_t)total, by, bx);\n"
     "    if (lane == 0) probe_tl[4] = clock64();  // probe\n"),
    ("    if (lane == 0) {\n      s.exclusive = exclusive;",
     "    if (lane == 0) probe_tl[5] = clock64();  // probe\n    if (lane == 0) {\n      s.exclusive = exclusive;"),
    ("  __syncthreads();\n  const int base = s.exclusive;\n",
     "  __syncthreads();\n" + _STAMP.format(k=6) + "  const int base = s.exclusive;\n"),
    ("  if (tid == 0) s.last = ticket == (unsigned)tiles - 1u;\n  __syncthreads();\n",
     "  if (tid == 0) s.last = ticket == (unsigned)tiles - 1u;\n  __syncthreads();\n" + _STAMP.format(k=7)
     + "  if (tid == 0) {  // probe\n    probe_tl[8] = clock64();\n"
       "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(probe_tl[15]));\n  }\n"),
    ("  for (int q = tid; q < STATE * tiles; q += THREADS) state[q] = 0u;\n}",
     "  for (int q = tid; q < STATE * tiles; q += THREADS) state[q] = 0u;\n" + _STAMP.format(k=9) + "}"),
), False)
# The steps of one frame's chain that the design cannot overlap: the launch
# (the empty kernel), the tile's loads and the nearest tile's state read by
# the look-back (a dependent load each), the ticket (the one global atomic
# a block takes), and the block's three barriers (the bytes, the counts,
# the base).
CHAIN_STEPS = {"launch": 1, "global atomic": 1, "dependent load": 2, "block barrier": 3}


def build_variants(against: pathlib.Path | None = None) -> dict:
    """{variant: ctypes library}; one nvcc per variant, all started
    together; "against" is DIR's kernel."""
    builds = {name: _probe.patched(_build.CSRC, (SOURCE.name,), {SOURCE.name: list(p)})
              for name, (p, _) in VARIANTS.items()}
    if against is not None:
        builds["against"] = {SOURCE.name: (against / "smh_tpu_torch" / "csrc" / SOURCE.name).read_text()}
    libs = _probe.build(builds, (SOURCE.name,), ptxas_of="as built")
    if against is not None and "void* scratch" not in builds["against"][SOURCE.name]:
        fn = libs["against"].smh_mask_words  # the entry before the scratch: (bits, stride, H, W, B, budget, out, stream)
        fn.argtypes = [t for i, t in enumerate(_build._SIGNATURES["smh_mask_words"]) if i not in (6, 7)]
    return libs


def launcher(lib, bits: torch.Tensor, w: int, budget: int):
    """A call of lib's smh_mask_words on bits, as kernels.mask_bbox_sparse
    makes it (with a scratch of the probe's own where the entry takes one),
    and its output."""
    bsz = bits.shape[0] if bits.dim() == 3 else 1
    out = torch.empty((*bits.shape[:-2], K.MASK_META + 2 * budget), dtype=torch.int32, device=bits.device)
    stride = K._frame_stride((bits,))
    fn = lib.smh_mask_words
    tiles = K.mask_tiles(bits.shape[-2], w)
    # room for every variant's tiles (1024-word tiles: twice as many) and the timeline's stamps
    scratch = torch.zeros(bsz * (K.MASK_SCRATCH_HEAD + 2 * K.MASK_STATE_WORDS * tiles + TIMELINE_WORDS * tiles) + 2,
                          dtype=torch.int32, device=bits.device)
    takes_scratch = len(fn.argtypes) == len(_build._SIGNATURES["smh_mask_words"])

    def call():
        extra = (scratch.data_ptr(), scratch.numel()) if takes_scratch else ()  # the closure keeps the scratch alive
        code = fn(bits.data_ptr(), stride, bits.shape[-2], w, bsz, budget, *extra, out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_mask_words")

    call.scratch = scratch
    return call, out


def timeline(lib, bits: torch.Tensor, w: int) -> dict:
    """One call of the timeline build: {step: (median, max) cycles over the
    blocks}, the last block's finish, and the blocks' start skew and span
    (ns, %globaltimer)."""
    call, _ = launcher(lib, bits, w, START)
    call()
    torch.cuda.synchronize()
    bsz = bits.shape[0] if bits.dim() == 3 else 1
    tiles = K.mask_tiles(bits.shape[-2], w)
    base = (bsz * (K.MASK_SCRATCH_HEAD + K.MASK_STATE_WORDS * tiles) + 1) & ~1
    tl = call.scratch[base : base + 32 * bsz * tiles].view(torch.int64).reshape(bsz * tiles, 16).cpu()
    steps = {name: (tl[:, b] - tl[:, a]).tolist() for name, (a, b) in TIMELINE_STEPS.items()}
    last = [int(r[9] - r[8]) for r in tl if r[9] > 0]
    return {"cycles": {name: (sorted(v)[len(v) // 2], max(v)) for name, v in steps.items()},
            "last block's bbox and reset": last, "sms": len(set(tl[:, 13].tolist())),
            "start skew ns": int(tl[:, 14].max() - tl[:, 14].min()), "span ns": int(tl[:, 15].max() - tl[:, 14].min())}


def chain_floor(libs: dict, bits: torch.Tensor, w: int, profile) -> dict:
    """The chain floor on this mask at START: each step of CHAIN_STEPS
    timed on the card (profile: chip_smoke.device_profile) and counted.
    libs: {variant: library} holding "as built", "ablation: empty", the CHAIN variants and
    the chase."""
    us = {n: profile(launcher(libs[n], bits, w, START)[0], n=50)["us"]
          for n in ("as built", "ablation: empty", *CHAIN)}
    latency = {"launch": us["ablation: empty"], "dependent load": load_latency_us(libs[CHASE], profile, bits.device)}
    for name, (n, step, _patches) in CHAIN.items():
        latency[step] = (us[name] - us["as built"]) / n
    floor = sum(k * latency[step] for step, k in CHAIN_STEPS.items())
    return {"kernel_us": us["as built"], "latency_us": latency, "steps": CHAIN_STEPS, "floor_us": floor}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=pathlib.Path, help="a tree whose kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_mask_words needs a CUDA device")
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs = build_variants(args.against)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    summary, chain = [], None
    cases = [(1, 822, 986, 0.0005), (1, 822, 986, 0.5), (1, 1644, 1972, 0.0005), (1, 1644, 1972, 0.5),
             (8, 822, 986, 0.0005)]
    for bsz, h, w, density in cases:
        bits = torch.from_numpy(np.packbits(rng.random((bsz, h, w)) < density, axis=-1)).to(dev)
        bits = bits if bsz > 1 else bits[0]
        for budget in (START, BATCH_BUDGET if bsz > 1 else top_rung(h, w)):
            want = K.mask_bbox_sparse_plain(bits, w, budget)
            nz = int(want.reshape(-1, want.shape[-1])[0, 6])
            label = f"B={bsz} {h}x{w} density {density} (nz {nz}) budget {budget}"
            calls = {}
            for name, lib in libs.items():
                if name == CHASE or (name == TIMELINE and budget != START):
                    continue
                call, out = launcher(lib, bits, w, budget)
                if name == "against" or VARIANTS[name][1]:
                    for rep in range(2):
                        call()
                        if not torch.equal(out, want):
                            raise SystemExit(f"{name} != plain at {label}, call {rep}")
                calls[name] = call
            if TIMELINE in calls:
                print(f"{label}: timeline {json.dumps(timeline(libs[TIMELINE], bits, w))}", flush=True)
                del calls[TIMELINE]
            order = (["against"] if "against" in calls else []) + ["as built", *TOP_VARIANTS]
            order = order + order[::-1]
            if budget == START:  # the other variants at the starting rung
                order += [n for n in calls if n not in order and not n.startswith("chain")]
            times = {n: [] for n in order}
            launches = {}
            for name in order:
                prof = cs.device_profile(calls[name], n=50)
                times[name].append(prof["us"])
                launches[name] = prof["launches"]
            print(f"{label}: device us per call: " + "; ".join(
                f"{n} " + " / ".join(f"{t:.2f}" for t in ts) + f" ({launches[n]:.0f} launches)"
                for n, ts in times.items()), flush=True)
            summary.append({"input": label, "device_us": times, "launches_per_call": launches, "card": card})
        if bsz == 1 and h == 822 and density < 0.01:
            chain = chain_floor(libs, bits, w, cs.device_profile)
            print(f"chain floor at {h}x{w} density {density}: " + " + ".join(
                f"{k} x {step} {chain['latency_us'][step]:.3f}" for step, k in CHAIN_STEPS.items())
                + f" = {chain['floor_us']:.2f} us beside the kernel's {chain['kernel_us']:.2f} us", flush=True)
    print(json.dumps({"inputs": summary, "chain": chain}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
