"""Where kernel 11's device time goes, on the card, and its chain floor;
with --against, beside another tree's kernel and wrapper, in turns.

Builds csrc/ocr_band.cu as it is; with a timeline of each mode (thread 0 of
every block stamps clock64(): banded at the start, after its strip read,
after the cluster's rows have met, after the join of the blocks' rows and
after the copy; unbanded at the start, after its first load and at the
end; printed as the median and the slowest block of each phase, in
cycles); with designs that keep its outputs (DESIGNS[...]["variants"]: a
cluster of 8, blocks of 256 or 1024 threads, the strip by a bulk copy into
shared memory, a late first cluster arrive, the copy by five 32-bit loads
a chunk, the rows through a second cluster barrier, the copy on the first
blocks); with parts switched off (the strip read, so no text is found; the
copy; everything: an empty kernel of the same grid and cluster); and with a
longer chain (32 more cluster barriers, 32 more block barriers). The
patches come from the design the source holds (DESIGNS: this one and the
one before it), so a tree of either design gets its timeline and ablations. With
--against DIR (another commit's tree, e.g. an unpacked `git archive` of
the parent) it also builds DIR/smh_tpu_torch/csrc/ocr_band.cu and its
design's timelines and ablations. Each build goes into its own library
under smh_tpu_torch/build/probe-*. It prints each build's device time per
call (chip_smoke.device_profile: every CUDA row of the call) in turns
(this, against, against, this; then, on ALL_BUILDS, the variants and
ablations) on kernel 6's outputs over chip_smoke.frame_for's verify frame:
the 411x493 and 822x986 quadrants with gray and binary bands of 51 / 102
rows and the half rung (205 / 411), and the unbanded keep bits of B = 1, 3
and 8 411x493 quadrants cut from one buffer. The builds that keep the
outputs are held to the plain twin first. Then the chain floor of the
as-built design on the 1080p gray band (chain_floor), and each tree's
wrapper call (CUDA events over 50 calls, as chip_smoke's "wrapper ms") in
child processes in turns (this, against, against, this). Run from the root
of a checkout; needs a CUDA device and nvcc:

    python -m smh_tpu_torch.probe_ocr_band [--against DIR]
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

SOURCE = _build.CSRC / "ocr_band.cu"
ANCHOR = "#include <stdint.h>\n"
BANDED_PHASES = ("strip read", "cluster barrier", "join", "copy")
UNBANDED_PHASES = ("first load", "rest")

_CLUSTER = "constexpr int CLUSTER = 16;"
_ARRIVE = 'asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");'
_PUSH = """      if (lane < CLUSTER) {  // an asynchronous store of the pair into block `lane`, which counts its bytes
        const int a = first == INT_MAX ? h : first / w, b = last < 0 ? -1 : last / w;
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 [%0], {%1, %2}, [%3];" ::"r"(
                         in_block(smem(&s_rows[rank]), lane)),
                     "r"(a), "r"(b), "r"(in_block(full, lane))
                     : "memory");
      }
    }
    wait_phase0(full);  // every block's rows are in this block's shared memory
"""
_THREADS = "constexpr int THREADS = 512;"
_LOADS = """    const uint32_t full = smem(&s_full);
    if (tid == 0) {  // s_full expects CLUSTER pairs of rows, before any block can send one
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(full) : "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(full), "r"(CLUSTER * 8) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();           // s_full is set up before any thread waits on it
    cluster_arrive_relaxed();  // this block has started (waited on before the first remote store)
    int first = INT_MAX, last = -1;
    const uint4* p = reinterpret_cast<const uint4*>(at);
    for (int c = tid; c < chunks; c += 2 * THREADS) {  // two loads in flight a thread
      const uint4 v0 = __ldg(p + c);
      const uint4 v1 = c + THREADS < chunks ? __ldg(p + c + THREADS) : make_uint4(0u, 0u, 0u, 0u);
      fold(v0, off + 16 * c, lo, hi, first, last);
      if (c + THREADS < chunks) fold(v1, off + 16 * (c + THREADS), lo, hi, first, last);
    }
"""
_BULK = """    __shared__ uint64_t s_got;  // probe: completes once the strip has landed in s_strip
    extern __shared__ __align__(128) uint4 s_strip[];
    const uint32_t full = smem(&s_full), got = smem(&s_got);
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(full) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(got) : "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(full), "r"(CLUSTER * 8) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(got), "r"(16 * chunks) : "memory");
      if (chunks > 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                smem(s_strip)),
            "l"(at), "r"(16 * chunks), "r"(got)
            : "memory");
    }
    __syncthreads();
    cluster_arrive_relaxed();
    int first = INT_MAX, last = -1;
    wait_phase0(got);
    for (int c = tid; c < chunks; c += THREADS) fold(s_strip[c], off + 16 * c, lo, hi, first, last);
"""
# This design: a cluster of 16 blocks of 512 threads a frame whose blocks
# send their rows to every block by st.async stores that an mbarrier
# counts, 16 bytes a thread.
_PUSHED = {
    "banded": (("    // 1. The first and last text byte of this block's strip", 0, "0"),
               ("    // 2. The block's rows, pushed into every block's shared memory.\n", 1,
                "(unsigned)first ^ (unsigned)last"),
               ("    // 3. The frame's rows and the band's start", 2, "0"),
               ("    // 4. The band, in one index space", 3, "b0"),
               ("  }\n}\n\n}  // namespace", 4, "0")),
    "unbanded": (("    // The keep mask of the whole quadrant: a thread 16 pixels of a row.\n", 0, "0"),
                 ("  if (w - x < 16) m &= (1u << (w - x)) - 1u;\n", 1, "m"),
                 ("  } else {\n    __shared__ int s_lo[WARPS], s_hi[WARPS];", 2, "0")),
    "ablations": {
        "no strip read": (("    const int chunks = lo < hi ? (hi - off + 15) >> 4 : 0;",
                           "    const int chunks = 0 * (hi - off);  // probe"),),
        "no copy": (("    for (int i = rank * share + tid; i < end; i += THREADS) {",
                     "    for (int i = rank * share + tid; i < 0 * end; i += THREADS) {  // probe"),),
        "empty": (("  const int tid = threadIdx.x;\n", "  if (h > 0) return;  // probe\n  const int tid = threadIdx.x;\n"),),
    },
    "chain": {
        "cluster barrier": ("    // 3. The frame's rows and the band's start",
                            "    for (int i = 0; i < 32; ++i) {  // probe\n      " + _ARRIVE + "\n"
                            "      cluster_wait_acquire();\n    }\n"),
        "block barrier": ("    // 3. The frame's rows and the band's start",
                          "    for (int i = 0; i < 32; ++i) __syncthreads();  // probe\n"),
    },
    # designs that keep the outputs, timed beside it
    "variants": {
        "a cluster of 8": ((_CLUSTER, "constexpr int CLUSTER = 8;"),),
        "1024 threads a block": ((_THREADS, "constexpr int THREADS = 1024;"),),
        "256 threads a block": ((_THREADS, "constexpr int THREADS = 256;"),),
        # the strip by one bulk copy (cp.async.bulk) into shared memory that
        # an mbarrier counts, scanned there, not by 16-byte loads
        "the strip by a bulk copy": ((_LOADS, _BULK), ("  cfg.dynamicSmemBytes = 0;",
                                                         "  cfg.dynamicSmemBytes = (size_t)((h + CLUSTER - 1) / CLUSTER * w + 46) / 16 * 16;"
                                                         "  // probe\n  if (cudaFuncSetAttribute(ocr_band_kernel<true>, "
                                                         "cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024) != cudaSuccess) "
                                                         "return -1;")),
        # the first phase of the cluster barrier arrived on after the strip
        # read, not at the start
        "a late first arrive": (("    cluster_arrive_relaxed();  // this block has started", "    //"),
                                ("    cluster_wait_acquire();  // every block of the cluster has started",
                                 "    cluster_arrive_relaxed();\n    cluster_wait_acquire();")),
        # the copy's 16 bytes a thread from five aligned 32-bit loads (as the
        # keep bits take theirs), not from two aligned 16-byte loads
        "the copy by five 32-bit loads a chunk": (("  const uint4 v = load16_wide(s + off, s, s + n);",
                                                    "  const uint4 v = load16(s + off, s, s + n);  // probe"),),
        # the rows pushed by plain distributed shared memory stores and made
        # visible by a second cluster barrier, not by asynchronous stores
        # that an mbarrier in each block counts
        "the rows through a cluster barrier": (
            (_PUSH, "      if (lane < CLUSTER)\n        *cluster.map_shared_rank(&s_rows[rank], lane) =\n"
                    "            make_int2(first == INT_MAX ? h : first / w, last < 0 ? -1 : last / w);\n    }\n"
                    "    " + _ARRIVE + "\n    cluster_wait_acquire();\n"),),
        # the copy's items over the cluster's threads in turn, so the first
        # blocks take them all where there are few
        "the copy on the first blocks": (
            ("    for (int i = rank * share + tid; i < end; i += THREADS) {",
             "    for (int i = rank * THREADS + tid; i < items + 0 * end; i += CLUSTER * THREADS) {"),),
    },
    # launch; the strip's loads and the band's; the cluster barrier (the
    # first phase overlaps the strip read); the block barrier before it
    "steps": {"launch": 1, "dependent load": 2, "cluster barrier": 1, "block barrier": 1},
}
# The design before it: a cluster of 8 blocks of 1024 threads a frame that pulls
# the blocks' rows through distributed shared memory, a byte a thread.
_PULLED = {
    "banded": (("    // 1. The text rows of this block's strip", 0, "0"),
               ("    ylo = __reduce_min_sync(FULL, ylo);\n", 1, "ylo ^ yhi"),
               ("    // 2. The frame's rows from every block's", 2, "0"),
               ("    const int b0 = s_b0;\n", 3, "s_b0"),
               ("    cluster_wait_acquire();  // every block has read", 4, "0")),
    "unbanded": (("    // The keep mask of the whole quadrant.\n", 0, "0"),
                 ("    }\n  } else {\n", 1, "0"),
                 ("  } else {\n    __shared__ int s_lo", 2, "0")),
    "ablations": {
        "no strip read": (("      for (int c = tid; c < chunks; c += THREADS) {",
                           "      for (int c = tid; c < 0 * chunks; c += THREADS) {  // probe"),),
        "no copy": (("    for (int i = gt; i < nb; i += T)", "    for (int i = gt; i < 0 * nb; i += T)"),
                    ("      for (int it = rank * WARPS + warp; it < items;",
                     "      for (int it = rank * WARPS + warp; it < 0 * items;"),
                    ("      for (int i = gt; i < ng; i += T)", "      for (int i = gt; i < 0 * ng; i += T)")),
        "empty": (("  const int tid = threadIdx.x;\n", "  if (h > 0) return;  // probe\n  const int tid = threadIdx.x;\n"),),
    },
    "chain": {
        "cluster barrier": ("    cluster.sync();  // every block's rows",
                            "    for (int i = 0; i < 32; ++i) cluster.sync();  // probe\n"),
        "block barrier": ("    cluster.sync();  // every block's rows",
                          "    for (int i = 0; i < 32; ++i) __syncthreads();  // probe\n"),
    },
    # launch; the strip's loads, the remote reads and the copy's loads; the
    # cluster barrier; the block barriers before and after the join
    "steps": {"launch": 1, "dependent load": 3, "cluster barrier": 1, "block barrier": 2},
}
DESIGNS = {"rows pushed, 16 bytes a thread": _PUSHED, "rows pulled, a byte a thread": _PULLED}
CHAIN_MORE = 32  # the chain variants' extra steps
# The cases every build is timed on (the others: this build and DIR's).
ALL_BUILDS = ("411x493 gray band 51", "411x493 binary band 51", "822x986 gray band 102", "822x986 binary band 102",
              "822x986 binary band 411", "B=8 unbanded 411x493")


def design_of(text: str) -> str | None:
    """The design (a key of DESIGNS) whose every patch applies to `text`."""
    for name, d in DESIGNS.items():
        olds = [old for old, _k, _dep in (*d["banded"], *d["unbanded"])]
        olds += [old for patches in d["ablations"].values() for old, _new in patches]
        olds += [old for old, _new in d["chain"].values()]
        olds += [old for patches in d.get("variants", {}).values() for old, _new in patches]
        if all(text.count(old) == 1 for old in olds):
            return name
    return None


def _patched(text: str, patches) -> str:
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"probe patch does not apply to {SOURCE.name}: {old!r}")
        text = text.replace(old, new)
    return text


def variants_of(text: str, prefix: str = "") -> dict:
    """{build name: (source text, keeps the outputs)}: the source as it is,
    its design's timelines, ablations and chain variants (prefixed)."""
    out = {f"{prefix}as built": (text, True)}
    name = design_of(text)
    if name is None:
        return out
    d = DESIGNS[name]
    for mode in ("banded", "unbanded"):
        out[f"{prefix}timeline {mode}"] = (_patched(text, _probe.timeline_patches(ANCHOR, d[mode])), True)
    for var, patches in d.get("variants", {}).items():
        out[f"{prefix}variant: {var}"] = (_patched(text, patches), True)
    for abl, patches in d["ablations"].items():
        out[f"{prefix}ablation: {abl}"] = (_patched(text, patches), False)
    for step, (old, new) in d["chain"].items():
        out[f"{prefix}chain: {CHAIN_MORE} more {step}s"] = (_patched(text, ((old, new + old),)), False)
    return out


def build_variants(against: pathlib.Path | None = None) -> tuple:
    """({build name: ctypes library}, {build name: keeps the outputs}, the
    designs); one nvcc per build, all started together; DIR's builds are
    named "against ..."."""
    text = SOURCE.read_text()
    builds = variants_of(text)
    designs = {"this": design_of(text)}
    builds[CHASE] = (_probe.patched(_build.CSRC, (SOURCE.name,), {SOURCE.name: list(_SCALES_VARIANTS[CHASE])})[
        SOURCE.name], False)
    if against is not None:
        other = (against / "smh_tpu_torch" / "csrc" / SOURCE.name).read_text()
        builds.update(variants_of(other, "against "))
        designs["against"] = design_of(other)
    libs = _probe.build({n: {SOURCE.name: t} for n, (t, _k) in builds.items()}, (SOURCE.name,),
                        ptxas_of="as built")
    return libs, {n: k for n, (_t, k) in builds.items()}, designs


def launcher(lib, args: tuple, inline: str, band):
    """A call of lib's smh_ocr_band as kernels.ocr_band makes it, and the
    bytes of its output row that the sections fill."""
    text, sbits, ocr = args
    lead, (h, w) = tuple(text.shape[:-2]), tuple(text.shape[-2:])
    bsz = text.shape[0] if text.dim() == 3 else 1
    batched = text.dim() == 3 and bsz > 1
    bpr = (w + 7) // 8
    if band is None:
        row = used = h * bpr
        planes = (None, 0, None, 0)
    else:
        used = K.BAND_META + band * (bpr + (bpr if inline == "binary" else w))
        row = -(-used // 4) * 4
        planes = (sbits.data_ptr(), sbits.stride(0) if batched else 0, ocr.data_ptr(), ocr.stride(0) if batched else 0)
    out = torch.empty((*lead, row), dtype=torch.uint8, device=text.device)

    def call():
        code = lib.smh_ocr_band(text.data_ptr(), text.stride(0) if batched else h * w, *planes, h, w, band or 0,
                                int(inline == "binary"), bsz, out.data_ptr(), row,
                                torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_ocr_band")

    return call, out[..., :used]


def cases(dev: torch.device) -> dict:
    """{label: ((text, scales bits, ocr_img), inline, band)}: kernel 6's
    outputs over the verify frame's quadrant at 1080p and 4K with gray and
    binary bands of 1/8 and 1/2 of its rows, and the unbanded keep bits of
    B = 1, 3 and 8 411x493 quadrants from one buffer (as chip_smoke's
    ocr_band phase makes them)."""
    import chip_smoke as cs

    from . import testing

    out = {}
    for w, h in cs.LIVE_SIZES:
        o = K.brq_preprocess(*cs.map_brq(cs.frame_for(w, h), dev))
        qh, qw = o["text"].shape
        args = (o["text"], o["scales_bits"], o["ocr_img"])
        for band in (qh // 8, qh // 2):
            for inline in ("gray", "binary"):
                out[f"{qh}x{qw} {inline} band {band}"] = (args, inline, band)
    rng = np.random.default_rng(31)
    h, w = 822, 986
    for bsz in cs.BATCH_SIZES:
        rows = torch.zeros((bsz, 3 * h * w + 37), dtype=torch.uint8, device=dev)
        for i in range(bsz):
            rgb = testing.text_rgb(rng, h, w, 0.01 * (i + 1))
            rows[i, : 3 * h * w] = torch.from_numpy(np.moveaxis(rgb[..., ::-1], -1, 0).reshape(-1)).to(dev)
        planes = rows[:, : 3 * h * w].view(bsz, 3, h, w)
        b8, g8, r8 = planes[:, 0], planes[:, 1], planes[:, 2]
        luma = K.classify_luma_planes(r8, g8, b8)[1]
        o = K.brq_preprocess(*(p[:, h // 2 :, w // 2 :] for p in (r8, g8, b8, luma)))
        out[f"B={bsz} unbanded {h // 2}x{w // 2}"] = ((o["text"], o["scales_bits"], o["ocr_img"]), "binary", None)
    return out


def chain_floor(libs: dict, designs: dict, case: tuple, profile) -> dict:
    """The as-built design's chain floor on one case: each step of its
    "steps" timed on the card (profile: chip_smoke.device_profile) and
    counted: the launch (the empty kernel), a dependent load (the pointer
    chase), and each barrier ((chain variant - as built) / CHAIN_MORE)."""
    d = DESIGNS[designs["this"]]

    def us(name):
        return profile(launcher(libs[name], *case)[0], n=50)["us"]

    base = us("as built")
    latency = {"launch": us("ablation: empty"),
               "dependent load": load_latency_us(libs[CHASE], profile, case[0][0].device)}
    for step in d["chain"]:
        latency[step] = (us(f"chain: {CHAIN_MORE} more {step}s") - base) / CHAIN_MORE
    floor = sum(k * latency[step] for step, k in d["steps"].items())
    return {"kernel_us": base, "latency_us": latency, "steps": d["steps"], "floor_us": floor}


# Each tree's wrapper call, timed in a child whose working directory is the
# tree: CUDA events over 50 calls (chip_smoke.cuda_ms) on the verify
# frame's quadrants and the unbanded B=8 quadrants.
CALLS_CHILD = r"""
import json
import numpy as np, torch
import chip_smoke as cs
from smh_tpu_torch import testing
from smh_tpu_torch.ops import kernels as K
dev = torch.device("cuda:0")
out = {}
for w, h in cs.LIVE_SIZES:
    o = K.brq_preprocess(*cs.map_brq(cs.frame_for(w, h), dev))
    qh, qw = o["text"].shape
    args = (o["text"], o["scales_bits"], o["ocr_img"])
    for inline in ("gray", "binary"):
        out[f"{qh}x{qw} {inline} band {qh // 8}"] = cs.cuda_ms(lambda: K.ocr_band(*args, inline, qh // 8))
rng = np.random.default_rng(31)
h, w = 822, 986
rgb = np.stack([testing.text_rgb(rng, h // 2, w // 2, 0.01 * (i + 1)) for i in range(8)])
q = torch.from_numpy(np.ascontiguousarray(np.moveaxis(rgb, -1, 1))).to(dev)
o = K.brq_preprocess(q[:, 0], q[:, 1], q[:, 2], K.classify_luma_planes(q[:, 0], q[:, 1], q[:, 2])[1])
out[f"B=8 unbanded {h // 2}x{w // 2}"] = cs.cuda_ms(lambda: K.ocr_band(o["text"], o["scales_bits"], o["ocr_img"],
                                                                       "binary"))
print("CALLS " + json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=pathlib.Path, help="a tree whose kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_ocr_band needs a CUDA device")
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs, keeps, designs = build_variants(args.against)
    print(f"designs: {designs}", flush=True)
    dev = torch.device("cuda")
    summary, chain = {}, None
    for label, (tensors, inline, band) in cases(dev).items():
        want = torch.cat([s.reshape(*s.shape[:-1], -1) for s in K.ocr_band_plain(*tensors, inline, band)[
            0 if band is not None else 1 :]], dim=-1)
        calls = {}
        for name, lib in libs.items():
            if name == CHASE:
                continue
            call, out = launcher(lib, tensors, inline, band)
            if keeps[name]:
                call()
                if not torch.equal(out, want):
                    raise SystemExit(f"{name} != plain at {label}")
            calls[name] = call
        order = ["as built"] + (["against as built"] if "against as built" in calls else [])
        order = order + order[::-1]
        if label in ALL_BUILDS:
            order += [n for n in calls if n not in order and "timeline" not in n and "chain" not in n]
        times = {n: [] for n in order}
        for name in order:
            times[name].append(cs.device_profile(calls[name], n=50)["us"])
        print(f"{label}: device us per call: " + "; ".join(
            f"{n} " + " / ".join(f"{t:.2f}" for t in ts) for n, ts in times.items()), flush=True)
        summary[label] = {"us": times}
        mode = "unbanded" if band is None else "banded"
        for who in ("", "against "):
            name = f"{who}timeline {mode}"
            if name not in calls:
                continue
            d = DESIGNS[designs["against" if who else "this"]]
            stamps = _probe.timeline_of(libs[name], calls[name], len(d[mode]), dev)
            line = _probe.timeline_summary(stamps, BANDED_PHASES if band is not None else UNBANDED_PHASES)
            print(f"{label}: {who}timeline of {stamps.shape[0]} blocks, cycles [median, max] over the blocks: "
                  + json.dumps(line), flush=True)
            summary[label][f"{who}timeline"] = line
        if chain is None and designs["this"] is not None and band is not None and inline == "gray":
            chain = chain_floor(libs, designs, (tensors, inline, band), cs.device_profile)
            print(f"chain floor at {label}: " + " + ".join(
                f"{k} x {step} {chain['latency_us'][step]:.3f}" for step, k in chain["steps"].items())
                + f" = {chain['floor_us']:.2f} us beside the kernel's {chain['kernel_us']:.2f} us", flush=True)
    here = pathlib.Path(__file__).resolve().parent.parent
    trees = {"this": here, **({"against": args.against.resolve()} if args.against is not None else {})}
    wrapper = _probe.children_in_turns(trees, CALLS_CHILD, "CALLS ")
    for name, runs in wrapper.items():
        print(f"wrapper ms per call, {name}: " + "; ".join(
            f"{k} " + ", ".join(f"{r[k]:.4f}" for r in runs) for k in runs[0]), flush=True)
    print("probe_ocr_band: " + json.dumps({"card": card, "designs": designs, "us": summary, "chain": chain,
                                           "wrapper_ms": wrapper}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
