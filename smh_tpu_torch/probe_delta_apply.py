"""Where kernel 8's device time goes, on the card, and its chain floor;
with --against, beside another tree's kernel, in turns.

Builds csrc/delta_apply.cu as it is; with variants that keep its outputs
(64 samples a bound search step, two a lane, so a bucket of 2048 takes two
dependent loads, not three; each thread's binary search remembering
whether the value it last kept was its chunk, so no load checks it; both);
with a timeline (thread 0 of every
block stamps clock64() at the start, after its warp's bound search, after
the bounds' barrier and after its frame-by-frame chain; printed as the
median and the slowest block of each phase, in cycles); with parts switched
off (the bound searches, so no update is found; the data loads, so an
update writes its entry's number; everything: an empty kernel of the same
grid); and with a longer chain (32 more block barriers). With --against
DIR (another commit's tree, e.g. an unpacked `git archive` of the parent)
it also builds DIR/smh_tpu_torch/csrc/delta_apply.cu, and that source with
the same timeline where it still holds the stamped points. Each build goes
into its own library under smh_tpu_torch/build/probe-*. It prints each
build's device time per call (chip_smoke.device_profile: every CUDA row of
the call) in turns (this, against, against, this; then the variants) and
the timelines, on: the 1080p and 4K frames' buffers with 2000 changed
chunks in a bucket of 2048 (chip_smoke's timed upload), a chain of 8 such
frames at 1080p, and at 4K the same 2000 chunks padded to the ladder's top
bucket, 131,072 (one tile holds 129,072 repeats), beside an unpadded
upload of them (a bucket of 2000). The builds that keep the outputs are
held to the plain twin first. Then the chain floor at 1080p
(chain_floor): the launch, each dependent load (a pointer chase) and each
block barrier of the chain, beside the kernel. Run from the root of a
checkout (the chase comes from probe_scales_read, the profiler from
chip_smoke.py). Needs a CUDA device and nvcc:

    python -m smh_tpu_torch.probe_delta_apply [--against DIR]
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

SOURCE = _build.CSRC / "delta_apply.cu"
_SEARCH = ("const int b = warp_lower_bound(idx + (int64_t)(k >> 1) * bucket, 0, bucket, (k & 1) ? c_hi : c_lo, lane);",
           "const int b = 0 * c_hi;  // probe")
_DATA = ("if (j >= lo && __ldg(t + j) == c) v = __ldg(data + ((int64_t)f * bucket + j) * ppc + part);",
         "if (j >= lo && __ldg(t + j) == c) v = make_uint4((unsigned)j, 0u, 0u, 0u);  // probe")
_EMPTY = ("  const int64_t p0 = (int64_t)blockIdx.x * THREADS;\n",
          "  if (pieces > 0) return;  // probe\n  const int64_t p0 = (int64_t)blockIdx.x * THREADS;\n")
_BEFORE_CHAIN = "  if (!in) return;\n"
# A timeline (_probe.timeline_patches): thread 0 of every block stamps the
# start, the end of its warp's bound search, the bounds' barrier and the
# end of its frame-by-frame chain. The --against tree's kernel, where its
# source still holds these points, gets the same timeline.
TIMELINE = "timeline"
TIMELINE_PHASES = ("bound searches", "bounds barrier", "frame-by-frame chain")
_STAMPS = (("  const int64_t p0 = (int64_t)blockIdx.x * THREADS;\n", 0, "0"),
           ("    if (lane == 0) bounds[k] = b;", 1, "b"),
           ("  if (!in) return;\n", 2, "0"),
           ("  }\n}\n\n}  // namespace", 3, "v.x"))
# 64 samples a search step (two a lane): a bucket of 2048 in two dependent
# loads, not three.
_SAMPLES64 = (("""  while (hi - lo > 32) {
    const int n = hi - lo;
    const int pos = lo + (int)(((int64_t)lane * n) >> 5);
    const unsigned m = __popc(__ballot_sync(FULL, __ldg(t + pos) < key));  // samples 0 .. m - 1 lie below key
    const int nlo = m == 0 ? lo : lo + (int)(((int64_t)(m - 1) * n) >> 5) + 1;
    hi = m == 32 ? hi : lo + (int)(((int64_t)m * n) >> 5);
    lo = nlo;
  }
  return lo + __popc(__ballot_sync(FULL, lane < hi - lo && __ldg(t + lo + lane) < key));""",
               """  while (hi - lo > 64) {  // probe: 64 samples a step
    const int n = hi - lo;
    const int a0 = __ldg(t + lo + (int)(((int64_t)(2 * lane) * n) >> 6));
    const int a1 = __ldg(t + lo + (int)(((int64_t)(2 * lane + 1) * n) >> 6));
    const unsigned m = __popc(__ballot_sync(FULL, a0 < key)) + __popc(__ballot_sync(FULL, a1 < key));
    const int nlo = m == 0 ? lo : lo + (int)(((int64_t)(m - 1) * n) >> 6) + 1;
    hi = m == 64 ? hi : lo + (int)(((int64_t)m * n) >> 6);
    lo = nlo;
  }
  const int b0 = lane < hi - lo ? __ldg(t + lo + lane) : INT32_MAX;
  const int b1 = lane + 32 < hi - lo ? __ldg(t + lo + lane + 32) : INT32_MAX;
  return lo + __popc(__ballot_sync(FULL, b0 < key)) + __popc(__ballot_sync(FULL, b1 < key));"""),)
# Each thread's search keeps whether the value it last kept was its chunk,
# so no load checks the entry it found.
_HIT = (("""      const int j = upper_bound(t, lo, hi, c) - 1;  // the last entry <= c
      if (j >= lo && __ldg(t + j) == c) v = __ldg(data + ((int64_t)f * bucket + j) * ppc + part);""",
         """      int l = lo, h = hi;  // probe: the hit kept
      bool hit = false;
      while (l < h) {
        const int mid = (l + h) >> 1, val = __ldg(t + mid);
        if (val <= c) {
          l = mid + 1;
          hit = val == c;
        } else {
          h = mid;
        }
      }
      if (hit) v = __ldg(data + ((int64_t)f * bucket + l - 1) * ppc + part);"""),)
# variant: (patches, keeps the outputs)
VARIANTS = {
    "as built": ((), True),
    TIMELINE: (tuple(_probe.timeline_patches("#include <stdint.h>\n", _STAMPS)), True),
    "64 samples a step": (_SAMPLES64, True),
    "no check load": (_HIT, True),
    "64 samples a step, no check load": (_SAMPLES64 + _HIT, True),
    "ablation: no search": ((_SEARCH,), False),
    "ablation: no data loads": ((_DATA,), False),
    "ablation: empty": ((_EMPTY,), False),
}
# Timing variants that lengthen the chain by N more of one dependent step:
# (time - as built) / N is that step's latency on the card.
CHAIN = {
    "chain: 32 more block barriers": (32, "block barrier", (
        (_BEFORE_CHAIN, "  for (int i = 0; i < 32; ++i) __syncthreads();  // probe\n" + _BEFORE_CHAIN),)),
}
VARIANTS.update({name: (patches, False) for name, (_n, _step, patches) in CHAIN.items()})
VARIANTS[CHASE] = (tuple(_SCALES_VARIANTS[CHASE]), False)
# The steps of a tile's chain for one frame with a bucket of 2048 that the
# design cannot overlap: the launch (the empty kernel), the load round trips
# (the bound search's three, 2048 -> 64 -> 2 -> the answer, the first with
# the resident's piece; the chunk's binary search in the run, ~2 steps of a
# few entries, and the load that checks it; the data), and one block
# barrier (the bounds).
CHAIN_STEPS = {"launch": 1, "dependent load": 7, "block barrier": 1}


def build_variants(against: pathlib.Path | None = None) -> dict:
    """{variant: ctypes library}; one nvcc per variant, all started
    together; "against" is DIR's kernel."""
    builds = {name: _probe.patched(_build.CSRC, (SOURCE.name,), {SOURCE.name: list(p)}) for name, (p, _) in
              VARIANTS.items()}
    if against is not None:
        text = (against / "smh_tpu_torch" / "csrc" / SOURCE.name).read_text()
        builds["against"] = {SOURCE.name: text}
        patches = _probe.timeline_patches("#include <stdint.h>\n", _STAMPS)
        if all(text.count(old) == 1 for old, _new in patches):
            for old, new in patches:
                text = text.replace(old, new)
            builds["against timeline"] = {SOURCE.name: text}
    return _probe.build(builds, (SOURCE.name,), ptxas_of="as built")


def launcher(lib, resident: torch.Tensor, buf: torch.Tensor, bucket: int, chunk: int):
    """A call of lib's smh_delta_apply, as kernels.delta_apply makes it,
    and the rows it writes."""
    bsz = K._delta_frames(buf, bucket, chunk)
    out = torch.empty((bsz, resident.numel()), dtype=torch.uint8, device=resident.device)

    def call():
        code = lib.smh_delta_apply(resident.data_ptr(), resident.numel(), buf.data_ptr(), bucket, chunk, bsz,
                                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_delta_apply")

    return call, out


def cases(dev: torch.device) -> dict:
    """{label: (resident, upload, bucket)}: chip_smoke's timed uploads (2000
    changed chunks a frame in a bucket of 2048) at the 1080p and 4K frames'
    buffers and a chain of 8 at 1080p, and at 4K the same 2000 chunks
    padded to the ladder's top bucket and unpadded."""
    import chip_smoke as cs

    from .vision import cuda_backend as cb

    rng = np.random.default_rng(0)
    sub = cb._DELTA_SUB
    changed, bucket = cs.DELTA_TIMED
    out = {}
    for w, h in cs.LIVE_SIZES:
        padded = cs.frame_bytes(w, h)
        n_sub = padded // sub
        resident = torch.from_numpy(rng.integers(0, 256, padded, dtype=np.uint8)).to(dev)
        chunks = np.sort(rng.choice(n_sub, size=changed, replace=False))
        data = rng.integers(0, 256, (changed, sub), dtype=np.uint8)
        idx, dat = cs.padded_table(chunks, data, bucket)
        out[f"{h}p, bucket {bucket}"] = (resident, torch.from_numpy(cs.delta_upload([idx], [dat])).to(dev), bucket)
        if h == 1080:
            chain = cs.delta_chain(rng, n_sub, cs.BATCH, bucket, changed)
            out[f"B={cs.BATCH} at 1080p, bucket {bucket}"] = (resident, torch.from_numpy(chain).to(dev), bucket)
        else:
            top = max(b for b in cb._DELTA_BUCKETS if b < n_sub * cb._DELTA_MAX_FRACTION)
            idx, dat = cs.padded_table(chunks, data, top)
            out[f"{h}p, padded to the top bucket {top}"] = (
                resident, torch.from_numpy(cs.delta_upload([idx], [dat])).to(dev), top)
            out[f"{h}p, unpadded ({changed})"] = (
                resident, torch.from_numpy(cs.delta_upload([chunks.astype(np.int32)], [data])).to(dev), changed)
    return out


def chain_floor(libs: dict, resident: torch.Tensor, buf: torch.Tensor, bucket: int, profile) -> dict:
    """The chain floor on this upload: each step of CHAIN_STEPS timed on the
    card (profile: chip_smoke.device_profile) and counted. libs: {variant:
    library} holding "as built", "ablation: empty", the CHAIN variants and
    the chase."""
    from .vision import cuda_backend as cb

    def us(name):
        return profile(launcher(libs[name], resident, buf, bucket, cb._DELTA_SUB)[0], n=50)["us"]

    times = {n: us(n) for n in ("as built", "ablation: empty", *CHAIN)}
    latency = {"launch": times["ablation: empty"],
               "dependent load": load_latency_us(libs[CHASE], profile, resident.device)}
    for name, (n, step, _patches) in CHAIN.items():
        latency[step] = (times[name] - times["as built"]) / n
    floor = sum(k * latency[step] for step, k in CHAIN_STEPS.items())
    return {"kernel_us": times["as built"], "latency_us": latency, "steps": CHAIN_STEPS, "floor_us": floor}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=pathlib.Path, help="a tree whose kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_delta_apply needs a CUDA device")
    import chip_smoke as cs

    from .vision import cuda_backend as cb

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs = build_variants(args.against)
    dev = torch.device("cuda")
    sub = cb._DELTA_SUB
    summary, chain = {}, None
    for label, (resident, buf, bucket) in cases(dev).items():
        want = K.delta_apply_plain(resident, buf, bucket, sub)
        calls = {}
        for name, lib in libs.items():
            if name == CHASE:
                continue
            call, out = launcher(lib, resident, buf, bucket, sub)
            if name.startswith("against") or VARIANTS[name][1]:
                call()
                if not torch.equal(out, want):
                    raise SystemExit(f"{name} != plain at {label}")
            calls[name] = call
        order = ["as built"] + (["against"] if "against" in calls else [])
        order = order + order[::-1] + [n for n in calls if n not in order and not n.startswith(("chain", "against"))]
        times = {n: [] for n in order}
        for name in order:
            times[name].append(cs.device_profile(calls[name], n=50)["us"])
        print(f"{label}: device us per call: " + "; ".join(
            f"{n} " + " / ".join(f"{t:.2f}" for t in ts) for n, ts in times.items()), flush=True)
        stamps = _probe.timeline_of(libs[TIMELINE], calls[TIMELINE], len(_STAMPS), dev)
        line = _probe.timeline_summary(stamps, TIMELINE_PHASES)
        print(f"{label}: timeline of {stamps.shape[0]} blocks, cycles [median, max] over the blocks: "
              + json.dumps(line), flush=True)
        summary[label] = {"us": times, "timeline": line}
        if "against timeline" in calls:
            stamps = _probe.timeline_of(libs["against timeline"], calls["against timeline"], len(_STAMPS), dev)
            line = _probe.timeline_summary(stamps, TIMELINE_PHASES)
            print(f"{label}: against's timeline of {stamps.shape[0]} blocks, cycles [median, max] over the blocks: "
                  + json.dumps(line), flush=True)
            summary[label]["against timeline"] = line
        if chain is None:
            chain = chain_floor(libs, resident, buf, bucket, cs.device_profile)
            print(f"chain floor at {label}: " + " + ".join(
                f"{k} x {step} {chain['latency_us'][step]:.3f}" for step, k in CHAIN_STEPS.items())
                + f" = {chain['floor_us']:.2f} us beside the kernel's {chain['kernel_us']:.2f} us", flush=True)
    print("probe_delta_apply: " + json.dumps({"card": card, "us": summary, "chain": chain}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
