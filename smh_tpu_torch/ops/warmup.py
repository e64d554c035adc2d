"""Warmup of every static shape the transport ladders reach, before the
first frame.

The port's counterpart of smh_tpu/ops/warmup.py. The JAX package compiles
its jit buckets here; on a CUDA device the first frame of each shape pays
other first-use costs instead: the nvcc build of csrc/ when build/<hash>/ is
cold (_build.load()), the launch that builds the classify tables, the
native host module's build, the templates' copy and the caching allocator's
growth for each shape. `warmup` drives a CudaBackend through the same rungs
as smh_tpu's: the sparse word budgets around the default and the probation
window rung (the window diagonal under SMH_SPARSE=0), the two band rungs,
the delta buckets of 100 and 1000 chunks, checksum-only scales and the
quiet pass off, then leaves the rung state virgin.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from .. import consts as C, testing
from ..vision import cuda_backend as cb
from ..vision.cuda_backend import CudaBackend

log = logging.getLogger(__name__)

COMMON_RESOLUTIONS = ((1920, 1080), (2560, 1440), (3840, 2160))


def warmup(resolutions=None, grayscale: bool = True, device="cuda") -> None:
    """Run the fused pass through every rung for each resolution
    (COMMON_RESOLUTIONS by default) on `device` ("cuda", "cuda:N" or "cpu";
    a CUDA device that is absent raises)."""
    for w, h in resolutions or COMMON_RESOLUTIONS:
        t0 = time.time()
        be = CudaBackend(device)
        # Default engines (smhocr) take the device scales read; the binary
        # band transport stays warm as the SMH_DEVICE_SCALES=0 / overflow
        # fallback.
        be.scales_binary_ok = True
        be.scales_image_derived = True
        be.scales_device_ok = True
        a = be._adapt
        frame = testing.make_frame(w, h, marker_lines=[((50, 50), (200, 120))])
        be.load_frame(frame)
        out = be.crop_to_map(grayscale)
        if out is not None:
            be.find_marker_lines(C.LSD_MAX_GAP)
        # Mask-transport shapes. Sparse mode (the default): each word-budget
        # rung is its own shape; warm the default rung and its escalation
        # neighbourhood. Window mode (SMH_SPARSE=0): the 2-D ladder's
        # matched-rung diagonal.
        if cb._sparse_mode():
            for rung in range(
                max(0, cb._SP_RUNG_DEFAULT - 1),
                min(len(cb._SPARSE_BUDGETS), cb._SP_RUNG_DEFAULT + 3),
            ):
                a.sp_rung = rung
                a.sp_streak = 0
                be.dispatch(grayscale)
                be.crop_to_map(grayscale)
                a.sp_rung = rung  # undo the consume-side shrink bookkeeping
            a.sp_rung = cb._SP_RUNG_DEFAULT
            # The probation shape: after repeated sparse misses (dense
            # content) the backend steps aside to the window ladder at its
            # starting rung.
            a.sp_probation = 1
            be.dispatch(grayscale)
            be.crop_to_map(grayscale)
            # A live session starts with VIRGIN hysteresis: the warm frames
            # above advanced the shrink and miss streaks on synthetic
            # content.
            a.sp_probation = 0
            a.sp_miss_streak = 0
            a.sp_streak = 0
            a.sp_rung = cb._SP_RUNG_DEFAULT
        elif a.ladder_h is not None:
            for rung in range(len(a.ladder_h)):
                a.rung_h = a.rung_w = rung
                be.dispatch(grayscale)
                be.crop_to_map(grayscale)
            a.rung_h = a.rung_w = cb._RUNG_HALF
            a.shrink_streak = 0
        # Band rungs (binary transport): the two a fallback session starts
        # in, the default (1/2) and the full height. The frames above kept
        # one scales checksum, which dropped the images from the pack:
        # bring them back.
        be.scales_device_ok = False
        a.scales_inline = True
        a.scales_stable = 0
        ladder_len = len(cb._dim_ladder(be.geom.brq_h))
        for band_rung in {min(cb._RUNG_HALF, ladder_len - 1), ladder_len - 1}:
            a.band_rung = band_rung
            be.dispatch(grayscale)
            be.crop_to_map(grayscale)
        a.band_rung = cb._RUNG_HALF
        a.band_streak = 0
        a.band_probation = 0
        be.scales_device_ok = True
        # Delta-transport buckets a live session typically visits (a marker
        # drag is a few hundred chunks).
        if be._delta_active(be._pending_host.size if be._pending_host is not None else 0):
            g = be.geom
            for n_touch in (100, 1000):
                f2 = frame.copy()
                span = min(g.map_w - 60, (n_touch * cb._DELTA_SUB) // 9)
                f2[g.map_y + 40 : g.map_y + 43, g.map_x + 50 : g.map_x + 50 + span, :3] = np.uint8(200)
                be.load_frame(f2)
                be.crop_to_map(grayscale)
                be.load_frame(frame)
                be.crop_to_map(grayscale)
                frame = f2  # alternate so each load really diffs
        # The scales transport the live loop flips to: checksum-only
        # ("none", after a few stable frames; device engines never drop to
        # it, so warm it with the device read off).
        be.scales_device_ok = False
        a.scales_inline = False
        be.dispatch(grayscale)
        be.crop_to_map(grayscale)
        a.scales_inline = True
        be.scales_device_ok = True
        # Minimap cadence (the rect dropped from the pack).
        be.quiet_enabled = False
        be.dispatch(grayscale)
        be.crop_to_map(grayscale)
        be.quiet_enabled = True
        # Leave the whole rung state virgin: the frames since the resets
        # above advanced the consume-side streaks and window rungs again.
        be._adapt = cb._AdaptState()
        log.info("warmup %dx%d on %s: %.1fs", w, h, be.device, time.time() - t0)
