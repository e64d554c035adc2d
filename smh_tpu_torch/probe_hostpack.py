"""Where kernel 9's device time goes, on the card, and what its block
counts cost; with --against, beside another tree's kernel, in turns.

Builds csrc/hostpack.cu as it is, with its blocks a launch changed (2 or
8 an SM in place of 4) or the 16-byte chunks a thread loads at once (2 or
4 in place of 1), with a timeline (thread 0 of every block stamps clock64()
at the start, after the ui loop, the button's, the sections', the block's
barrier and its slot atomic; printed as the median and the slowest block
of each phase, in cycles), and with parts of it switched off (the
sections' copy; the button; the ui plane's loads; the slots' atomics;
everything: an empty kernel of the same grid), and with --against DIR,
DIR/smh_tpu_torch/csrc/hostpack.cu, each into its own library under
smh_tpu_torch/build/probe-*, and prints each build's device time per call
(chip_smoke.device_profile: every CUDA row of the call) in turns (against,
as built, as built, against; then the variants), on the main path's table (the tail's inputs recorded
from the fused pass of chip_smoke.frame_for's frame, smhocr's device read
and the sparse words) at 1080p and 4K, and of a batch of 8 at 1080p. The
builds that keep the outputs are held to the plain twin first, over two
calls (the second shows that the scratch came back clean); the ablations
only time. Run from the root of a checkout; needs a CUDA device and nvcc:

    python -m smh_tpu_torch.probe_hostpack [--against DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from . import _build, _probe, consts as C
from .ops import kernels as K
from .ops import pipeline as opp
from .ops import scales_device as sd

SOURCE = _build.CSRC / "hostpack.cu"
_BLOCKS = "constexpr int BLOCKS_PER_SM = 4;"
_CHUNKS = "constexpr int CHUNKS_AT_ONCE = 1;"
_SECTIONS = ("  for (int64_t t = gt; t < sec.bytes; t += gn) {", "  for (int64_t t = gt; t < 0 * sec.bytes; t += gn) {")
_BUTTON = ("btn_stride, btn_px, r, g, b, tol};", "btn_stride, 0, r, g, b, tol};  // probe")
_UI = (("    for (int j0 = gt; j0 < first[NP];", "    for (int j0 = gt; j0 < 0 * first[NP];"),
       ("    const int quads = ui.h * qpr;\n", "    const int quads = 0 * qpr;  // probe\n"))
_ATOMICS = ("  __syncthreads();\n  if (tid < SLOTS) {", "  __syncthreads();\n  if (ui.h > 0) return;  // probe\n"
            "  if (tid < SLOTS) {")
_EMPTY = ("  const int64_t f = blockIdx.y;\n", "  if (ui.h > 0) return;  // probe\n  const int64_t f = blockIdx.y;\n")
# A timeline (_probe.timeline_patches): thread 0 of every block stamps the
# start, the end of the ui loop, of the button's, of the sections', the
# block's barrier and its slot atomic's return.
TIMELINE = "timeline"
TIMELINE_PHASES = ("ui", "button", "sections", "reduce and barrier", "slot atomic")
_STAMPS = (("  const int gt = blockIdx.x * THREADS + tid;  // this thread among the frame's\n", 0, "0"),
           ("  // The red gate's count.\n", 1, "sum ^ wsum"),
           ("  // The sections' bytes, one index space", 2, "red"),
           ("  sum = __reduce_add_sync(FULL, sum);\n", 3, "0"),
           ("  if (tid < SLOTS) {  // slot tid", 4, "0"),
           ("    if ((old >> COUNT_SHIFT) == gridDim.x - 1) {", 5, "(unsigned)old"))
# variant: (patches, keeps the outputs)
VARIANTS = {
    "as built": ((), True),
    TIMELINE: (tuple(_probe.timeline_patches("#include <stdint.h>\n", _STAMPS)), True),
    "2 blocks an SM": (((_BLOCKS, _BLOCKS.replace("4;", "2;")),), True),
    "8 blocks an SM": (((_BLOCKS, _BLOCKS.replace("4;", "8;")),), True),
    "2 chunks at once": (((_CHUNKS, _CHUNKS.replace("1;", "2;")),), True),
    "4 chunks at once": (((_CHUNKS, _CHUNKS.replace("1;", "4;")),), True),
    "ablation: no sections": ((_SECTIONS,), False),
    "ablation: no button": ((_BUTTON,), False),
    "ablation: no ui loads": (_UI, False),
    "ablation: no slot atomics": ((_ATOMICS,), False),
    "ablation: only the launch, the reduction and the atomics": ((_SECTIONS, _BUTTON, *_UI), False),
    "ablation: empty": ((_EMPTY,), False),
}


def build_variants(against: pathlib.Path | None = None) -> dict:
    """{variant: ctypes library}; one nvcc per variant, all started
    together; "against" is DIR's kernel."""
    builds = {name: _probe.patched(_build.CSRC, (SOURCE.name,), {SOURCE.name: list(p)}) for name, (p, _) in
              VARIANTS.items()}
    if against is not None:
        builds["against"] = {SOURCE.name: (against / "smh_tpu_torch" / "csrc" / SOURCE.name).read_text()}
    return _probe.build(builds, (SOURCE.name,), ptxas_of="as built")


def launcher(lib, tail: tuple):
    """A call of lib's smh_hostpack on a recorded tail (ui planes, button,
    sections), as kernels.hostpack_tail makes it, and its output."""
    ui, btn, sections = tail
    args, out, keep = K.hostpack_args(ui, btn, sections, own_table=True)

    def call():
        _build.check(lib.smh_hostpack(*args), "smh_hostpack")
        return keep  # the closure keeps the table and the scratch alive

    return call, out


def main_path_tails(dev: torch.device) -> dict:
    """{label: (ui planes, button, sections)}: the tail of the main path's
    pass (smhocr's device read, the sparse words at budget 1024) on
    chip_smoke.frame_for's frame at 1080p and 4K, and of the batched pass
    over 8 of chip_smoke.batch_rows' frames at 1080p."""
    import chip_smoke as cs

    from .vision import cuda_backend as cb

    templates = sd.templates_to_device(sd.device_templates(), dev)
    rng = np.random.default_rng(0)
    tails = {}
    for w, h in cs.LIVE_SIZES:
        gm = C.map_geometry(w, h)
        frame = cs.frame_for(w, h)
        mr = frame[gm.map_y : gm.map_y + gm.map_h, gm.map_x : gm.map_x + gm.map_w]
        br = frame[gm.btn_y : gm.btn_y + gm.btn_h, gm.btn_x : gm.btn_x + gm.btn_w]
        flat = torch.from_numpy(cb._pack_rois_bgr(mr, br, cb._DELTA_CHUNK)).to(dev)
        geo = dict(map_h=gm.map_h, map_w=gm.map_w, btn_h=gm.btn_h, btn_w=gm.btn_w, grayscale=True,
                   scales_inline="device", sparse_budget=cs.MASK_BUDGET, templates=templates)
        with cs.recorded_tails() as seen:
            opp.analyze_packed_flat(flat, **geo)
        tails[f"{gm.map_h}x{gm.map_w}"] = seen[0]
        if h == 1080:
            rows = torch.from_numpy(cs.batch_rows(rng, 8, w, h)[0]).to(dev)
            with cs.recorded_tails() as seen:
                opp.analyze_batch_packed_flat(rows, **geo)
            tails[f"B=8 {gm.map_h}x{gm.map_w}"] = seen[0]
    return tails


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=pathlib.Path, help="a tree whose kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_hostpack needs a CUDA device")
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs = build_variants(args.against)
    dev = torch.device("cuda")
    summary = {}
    for label, tail in main_path_tails(dev).items():
        want = K.hostpack_tail_plain(*tail)
        calls = {}
        for name, lib in libs.items():
            call, out = launcher(lib, tail)
            if name == "against" or VARIANTS[name][1]:
                for rep in range(2):
                    call()
                    if not torch.equal(out, want):
                        raise SystemExit(f"{name} != plain at {label}, call {rep}")
            calls[name] = call
        order = (["against"] if "against" in calls else []) + ["as built"]
        order = order + order[::-1] + [n for n in calls if n not in order]
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
    print("probe_hostpack: " + json.dumps({"card": card, "us": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
