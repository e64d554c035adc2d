"""Where kernel 10's device time goes, on the card, and its chain floor;
with --against, beside another tree's kernel and wrapper, in turns.

Builds csrc/window_crop.cu as it is; with a timeline (thread 0 of every
block stamps clock64() at the start, after its first load, the bbox, after
the bits' loads and before its store; printed as the median and the
slowest block of each phase, in cycles); with designs that keep its
outputs (DESIGNS[...]["variants"]: blocks of 64, 128 or 512 threads, 16
output bytes a thread); and with parts switched off (the bbox load, so the
origin is no load away; the bits' loads; everything: an empty kernel of
the same grid). The patches come from the design the source holds
(DESIGNS: this one and the one before it), so a tree of either design gets its
timeline and ablations. With --against DIR (another commit's tree, e.g.
an unpacked `git archive` of the parent) it also builds
DIR/smh_tpu_torch/csrc/window_crop.cu and its design's timeline and
ablations. Each build goes into its own library under
smh_tpu_torch/build/probe-*. It prints each build's device time per call
(chip_smoke.device_profile: every CUDA row of the call) in turns (this,
against, against, this; then the variants and ablations, but at B = 1 and
3) on the half-size windows (411x493 of 822x986, 822x986 of 1644x1972) of
chip_smoke.frame_for's verify frame's dilated marker mask at its bbox
(kernels 3 and 7 on the card), and on B = 1, 3 and 8 random 822x986 masks
cut from one buffer, an origin each (as chip_smoke's window_crop phase
makes them). The builds that keep the outputs are held to the plain twin
first. Then the chain floor at 1080p (the launch and two dependent loads),
and each tree's wrapper call (CUDA events over 50 calls, as chip_smoke's
"wrapper ms") in child processes in turns (this, against, against, this).
Run from the root of a checkout; needs a CUDA device and nvcc:

    python -m smh_tpu_torch.probe_window_crop [--against DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from . import _build, _probe
from .ops import kernels as K
from .ops import pipeline as opp
from .probe_scales_read import CHASE, load_latency_us
from .probe_scales_read import VARIANTS as _SCALES_VARIANTS

SOURCE = _build.CSRC / "window_crop.cu"
ANCHOR = "#include <stdint.h>\n"
MARGIN = int(opp.LSD_CROP_MARGIN)

_THREADS = "constexpr int THREADS = 256;"
# This design: a thread an aligned 32-bit word of an output row, from the
# two aligned 32-bit source words under it.
_WORDS = {
    "stamps": (("  const int64_t f = blockIdx.y;\n", 0, "0"),
               ("  const int cy0 = min(max(y0 - margin, 0), H - crop_h);\n", 1, "y0 ^ x0"),
               ("  const int s = 8 * (int)(sp & 3) + (cx0 & 7);  // <= 31", 2, "e[0] ^ e[WORDS]"),
               ("  if (c >= 0 && c + BYTES <= cbpr) {\n", 3, "o[0]")),
    "phases": ("bbox load", "bits loads", "shift and pad"),
    "who": "threadIdx.x + threadIdx.y == 0",  # thread 0 of a block of rows
    "ablations": {
        "no bbox load": (("  const int y0 = __ldg(words + 0);\n  const int x0 = __ldg(words + 2);\n",
                          "  const int y0 = (int)f, x0 = 0;  // probe\n"),),
        "no bits loads": (("  for (int i = 0; i <= WORDS; ++i) e[i] = word_in(a + 4 * i, row, row + bpr);",
                           "  for (int i = 0; i <= WORDS; ++i) e[i] = (uint32_t)(a + i);  // probe"),),
        "empty": (("  const int64_t f = blockIdx.y;\n", "  if (H > 0) return;  // probe\n  const int64_t f = blockIdx.y;\n"),),
    },
    # designs that keep the outputs, timed beside it
    "variants": {
        "blocks of 64": ((_THREADS, "constexpr int THREADS = 64;"),),
        "blocks of 128": ((_THREADS, "constexpr int THREADS = 128;"),),
        "blocks of 512": ((_THREADS, "constexpr int THREADS = 512;"),),
        # 16 bytes a thread (four words), one 16-byte store where the unit
        # lies inside the row
        "16 bytes a thread, blocks of 64": ((_THREADS, "constexpr int THREADS = 64;"),
                                            ("constexpr int BYTES = 4;", "constexpr int BYTES = 16;")),
        "16 bytes a thread": (("constexpr int BYTES = 4;", "constexpr int BYTES = 16;"),),
    },
}
# The design before it: a thread an output byte from two byte loads.
_BYTES = {
    "stamps": (("  const int64_t f = blockIdx.y;\n", 0, "0"),
               ("  const int cy0 = min(max(y0 - margin, 0), H - crop_h);\n", 1, "y0 ^ x0"),
               ("  out[4 * META + k] = (uint8_t)o;\n", 2, "o")),
    "phases": ("bbox load", "bits and store"),
    "ablations": {
        "no bbox load": (("  const int y0 = __ldg(words + 0);\n  const int x0 = __ldg(words + 2);\n",
                          "  const int y0 = (int)f, x0 = 0;  // probe\n"),),
        "no bits loads": (("  uint32_t v = (uint32_t)__ldg(row + sb) << 8;\n  if (s != 0 && sb + 1 < bpr) v |= "
                           "__ldg(row + sb + 1);\n", "  uint32_t v = (uint32_t)sb << 8 | (row == bits);  // probe\n"),),
        "empty": (("  const int64_t f = blockIdx.y;\n", "  if (H > 0) return;  // probe\n  const int64_t f = blockIdx.y;\n"),),
    },
}
DESIGNS = {"a word a thread": _WORDS, "a byte a thread": _BYTES}
# The chain every design keeps: the launch, the bbox's load, then the bits'.
CHAIN_STEPS = {"launch": 1, "dependent load": 2}


def design_of(text: str) -> str | None:
    """The design (a key of DESIGNS) whose every patch applies to `text`."""
    for name, d in DESIGNS.items():
        olds = [old for old, _k, _dep in d["stamps"]]
        olds += [old for patches in (*d["ablations"].values(), *d.get("variants", {}).values()) for old, _new in patches]
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
    its design's timeline and ablations (prefixed)."""
    out = {f"{prefix}as built": (text, True)}
    name = design_of(text)
    if name is None:
        return out
    d = DESIGNS[name]
    out[f"{prefix}timeline"] = (_patched(text, _probe.timeline_patches(ANCHOR, d["stamps"], d.get("who",
                                                                                             "threadIdx.x == 0"))), True)
    for var, patches in d.get("variants", {}).items():
        out[f"{prefix}variant: {var}"] = (_patched(text, patches), True)
    for abl, patches in d["ablations"].items():
        out[f"{prefix}ablation: {abl}"] = (_patched(text, patches), False)
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


def launcher(lib, bits: torch.Tensor, words: torch.Tensor, w: int, crop_h: int, crop_w: int):
    """A call of lib's smh_window_crop as kernels.window_crop makes it, and
    the bytes of its output row that the meta and the window fill."""
    lead = tuple(bits.shape[:-2])
    h = bits.shape[-2]
    bsz = bits.shape[0] if bits.dim() == 3 else 1
    stride = bits.stride(0) if bits.dim() == 3 and bsz > 1 else h * bits.shape[-1]
    used = K.WINDOW_META + crop_h * ((crop_w + 7) // 8)
    row = -(-used // 4) * 4
    out = torch.empty((*lead, row), dtype=torch.uint8, device=bits.device)

    def call():
        code = lib.smh_window_crop(bits.data_ptr(), stride, h, w, words.data_ptr(), words.stride(0) if lead else 0,
                                   crop_h, crop_w, MARGIN, bsz, out.data_ptr(), row,
                                   torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_window_crop")

    return call, out[..., :used]


def cases(dev: torch.device) -> dict:
    """{label: (bits, words, w, crop_h, crop_w)}: the verify frame's mask at
    1080p and 4K with its half-size window, and B = 1, 3 and 8 random
    822x986 masks from one buffer with the half-size window."""
    import chip_smoke as cs

    from . import consts as C

    out = {}
    for w, h in cs.LIVE_SIZES:
        gm = C.map_geometry(w, h)
        planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
            cs.frame_for(w, h)[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w, :3], -1, 0))).to(dev)
        bits = K.fused_mask_bits(planes[2], planes[1], planes[0])
        words = K.mask_bbox_sparse(bits, gm.map_w, 0)
        out[f"{gm.map_h // 2}x{gm.map_w // 2} of {gm.map_h}x{gm.map_w}"] = (
            bits, words, gm.map_w, gm.map_h // 2, gm.map_w // 2)
    rng = np.random.default_rng(29)
    h, w = 822, 986
    bpr = (w + 7) // 8
    for bsz in cs.BATCH_SIZES:
        rows = torch.zeros((bsz, h * bpr + 5), dtype=torch.uint8, device=dev)
        for i in range(bsz):
            m = np.zeros((h, w), bool)
            if i != 1:
                y, x = 30 + 37 * i, 17 + 53 * i
                m[y : y + 200, x : x + 300] = rng.random((200, 300)) < 0.01
            rows[i, : h * bpr] = torch.from_numpy(np.packbits(m, axis=1).reshape(-1)).to(dev)
        bits = rows[:, : h * bpr].view(bsz, h, bpr)
        out[f"B={bsz} {h // 2}x{w // 2} of {h}x{w}"] = (bits, K.mask_bbox_sparse(bits, w, 0), w, h // 2, w // 2)
    return out


def chain_floor(libs: dict, case: tuple, profile) -> dict:
    """The chain floor on one case: the launch (the empty kernel) and two
    dependent loads (the pointer chase), timed on the card (profile:
    chip_smoke.device_profile), beside the kernel."""
    def us(name):
        return profile(launcher(libs[name], *case)[0], n=50)["us"]

    latency = {"launch": us("ablation: empty"),
               "dependent load": load_latency_us(libs[CHASE], profile, case[0].device)}
    floor = sum(k * latency[step] for step, k in CHAIN_STEPS.items())
    return {"kernel_us": us("as built"), "latency_us": latency, "steps": CHAIN_STEPS, "floor_us": floor}


# Each tree's wrapper call, timed in a child whose working directory is the
# tree: CUDA events over 50 calls (chip_smoke.cuda_ms) on the verify
# frame's half-size windows and on B=8 random masks.
CALLS_CHILD = r"""
import json
import numpy as np, torch
import chip_smoke as cs
from smh_tpu_torch import consts as C
from smh_tpu_torch.ops import kernels as K
from smh_tpu_torch.ops import pipeline as opp
dev = torch.device("cuda:0")
margin = int(opp.LSD_CROP_MARGIN)
out = {}
for w, h in cs.LIVE_SIZES:
    gm = C.map_geometry(w, h)
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        cs.frame_for(w, h)[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w, :3], -1, 0))).to(dev)
    bits = K.fused_mask_bits(planes[2], planes[1], planes[0])
    words = K.mask_bbox_sparse(bits, gm.map_w, 0)
    out[f"{gm.map_h // 2}x{gm.map_w // 2} of {gm.map_h}x{gm.map_w}"] = cs.cuda_ms(
        lambda: K.window_crop(bits, words, gm.map_w, gm.map_h // 2, gm.map_w // 2, margin))
rng = np.random.default_rng(29)
h, w = 822, 986
m = rng.random((8, h, w)) < 0.001
bits = torch.from_numpy(np.packbits(m, axis=-1)).to(dev)
words = K.mask_bbox_sparse(bits, w, 0)
out[f"B=8 {h // 2}x{w // 2} of {h}x{w}"] = cs.cuda_ms(lambda: K.window_crop(bits, words, w, h // 2, w // 2, margin))
print("CALLS " + json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=pathlib.Path, help="a tree whose kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_window_crop needs a CUDA device")
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs, keeps, designs = build_variants(args.against)
    print(f"designs: {designs}", flush=True)
    dev = torch.device("cuda")
    summary, chain = {}, None
    for label, case in cases(dev).items():
        want = torch.cat(K.window_crop_plain(*case, MARGIN), dim=-1)
        calls = {}
        for name, lib in libs.items():
            if name == CHASE:
                continue
            call, out = launcher(lib, *case)
            if keeps[name]:
                call()
                if not torch.equal(out, want):
                    raise SystemExit(f"{name} != plain at {label}")
            calls[name] = call
        order = ["as built"] + (["against as built"] if "against as built" in calls else [])
        order = order + order[::-1]
        if not label.startswith(("B=1 ", "B=3 ")):
            order += [n for n in calls if n not in order and "timeline" not in n]
        times = {n: [] for n in order}
        for name in order:
            times[name].append(cs.device_profile(calls[name], n=50)["us"])
        print(f"{label}: device us per call: " + "; ".join(
            f"{n} " + " / ".join(f"{t:.2f}" for t in ts) for n, ts in times.items()), flush=True)
        summary[label] = {"us": times}
        for who in ("", "against "):
            name = f"{who}timeline"
            if name not in calls:
                continue
            d = DESIGNS[designs["against" if who else "this"]]
            stamps = _probe.timeline_of(libs[name], calls[name], len(d["stamps"]), dev)
            line = _probe.timeline_summary(stamps, d["phases"])
            print(f"{label}: {who}timeline of {stamps.shape[0]} blocks, cycles [median, max] over the blocks: "
                  + json.dumps(line), flush=True)
            summary[label][f"{who}timeline"] = line
        if chain is None and designs["this"] is not None:
            chain = chain_floor(libs, case, cs.device_profile)
            print(f"chain floor at {label}: " + " + ".join(
                f"{k} x {step} {chain['latency_us'][step]:.3f}" for step, k in CHAIN_STEPS.items())
                + f" = {chain['floor_us']:.2f} us beside the kernel's {chain['kernel_us']:.2f} us", flush=True)
    here = pathlib.Path(__file__).resolve().parent.parent
    trees = {"this": here, **({"against": args.against.resolve()} if args.against is not None else {})}
    wrapper = _probe.children_in_turns(trees, CALLS_CHILD, "CALLS ")
    for name, runs in wrapper.items():
        print(f"wrapper ms per call, {name}: " + "; ".join(
            f"{k} " + ", ".join(f"{r[k]:.4f}" for r in runs) for k in runs[0]), flush=True)
    print("probe_window_crop: " + json.dumps({"card": card, "designs": designs, "us": summary, "chain": chain,
                                              "wrapper_ms": wrapper}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
