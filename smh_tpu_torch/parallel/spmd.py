"""Mesh-sharded batch pass: the port's counterpart of smh_tpu/parallel/spmd.py.

A batch of frames is laid out over a 2-D grid of devices:

  * axis "dp": frames across devices (data parallelism),
  * axis "sp": each frame's map rows across devices (spatial partitioning).

smh_tpu writes this as one jitted function with sharding annotations, and
XLA's partitioner inserts the halo exchanges at the "sp" seams. Here one
Python process drives the devices of a `Mesh` (its entries may repeat a
device): each (dp, sp) block of map rows is uploaded with the HALO rows its
stencils read across a seam, runs kernels 1 and 3 (and kernel 6 on its
rows of the bottom-right quadrant) once for the block's frames on its
device, and has the halos cropped off; the blocks of a dp row
are joined on the row's sp-0 device (the reshard smh_tpu's full_step does
before its march), where the checksums are taken over whole planes. The
march runs each dp row's frames on that device in ONE launch of kernel 4
over a batch of masks, one per frame.

Outputs are per dp row: {key: [dp row 0's tensor, ...]}, each on its row's
sp-0 device, the frames of a row in order; `gather` joins them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import consts as C
from .. import resolve_device
from ..ops import kernels
from ..ops import lsd as ops_lsd
from ..ops import pipeline as opp

# Rows of context a block reads past each of its seams: 1 for kernel 3's L1
# dilate and for the 8-neighbour quiet SAD, OCR_PREPROCESS_DILATE_RADIUS
# for kernel 6's box dilate on the quadrant.
HALO = max(1, int(C.OCR_PREPROCESS_DILATE_RADIUS))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A [dp][sp] grid of torch devices; `shape` reads as JAX's mesh.shape."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    def row_devices(self) -> list:
        """The sp-0 device of each dp row: where the row's outputs land."""
        return [row[0] for row in self.devices]


def make_mesh(devices=None, sp: int = 1) -> Mesh:
    """A ("dp", "sp") mesh of `devices` (torch devices or their names; a
    device may repeat), sp consecutive entries to a dp row. None: every
    visible CUDA device, and RuntimeError when there is none."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible (name the devices, e.g. ['cpu'] * 8)")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    if sp < 1 or not devices or len(devices) % sp:
        raise ValueError(f"{len(devices)} devices do not split into rows of sp={sp}")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh of one device type, not {sorted({d.type for d in devices})}")
    return Mesh(tuple(tuple(devices[i : i + sp]) for i in range(0, len(devices), sp)))


def row_splits(n_rows: int, sp: int) -> list:
    """(r0, r1) of each of sp row shards of n_rows, as even as possible."""
    if n_rows < sp:
        raise ValueError(f"{n_rows} map rows do not split over sp={sp}")
    return [(s * n_rows // sp, (s + 1) * n_rows // sp) for s in range(sp)]


def gather(out, device):
    """Join per-dp-row outputs on `device`: a dict of row lists -> a dict of
    tensors, a row list -> one tensor, frames in batch order."""
    if isinstance(out, dict):
        return {k: gather(v, device) for k, v in out.items()}
    return torch.cat([t.to(device) for t in out])


def _host_frames(frames) -> np.ndarray:
    if isinstance(frames, torch.Tensor):
        frames = frames.cpu().numpy()
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 4:
        raise ValueError(f"expected u8 [B, H, W, 4] BGRA frames, got {frames.dtype} {frames.shape}")
    return frames


def _analyze_block(frames: np.ndarray, r0: int, r1: int, g, dev: torch.device, grayscale: bool) -> dict:
    """The fused pass over map rows r0 .. r1 of frames [b, H, W, 4] on dev,
    uploaded with HALO rows past each seam and cropped back to r0 .. r1.
    The bottom-right quadrant's outputs cover its rows among r0 .. r1."""
    lo, hi = max(0, r0 - HALO), min(g.map_h, r1 + HALO)
    roi = frames[:, g.map_y + lo : g.map_y + hi, g.map_x : g.map_x + g.map_w, :3]
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(roi, -1, 0))).to(dev)
    b8, g8, r8 = planes[0], planes[1], planes[2]  # [b, rows, map_w] each, contiguous
    _, luma = kernels.classify_luma_planes(r8, g8, b8)
    a, c = r0 - lo, r1 - lo  # the block's own rows
    bits = kernels.fused_mask_bits(r8, g8, b8)[:, a:c]
    out = {
        "ui": (luma if grayscale else torch.stack([r8, g8, b8], dim=-1))[:, a:c],
        "lsd_bool": opp.unpack_bits_bool(bits, g.map_w),
        "lsd_bits": bits,
        "quiet_bool": opp._edgy_quiet_planes(b8, g8, r8)[:, a:c],
    }
    # The quadrant in map coordinates: rows brq_h .. 2 brq_h, of which this
    # block holds q0 .. q1; the OCR dilate reads HALO quadrant rows past them.
    brq_h, brq_w = g.map_h // 2, g.map_w // 2
    q0, q1 = max(r0, brq_h), min(r1, 2 * brq_h)
    if q0 < q1:
        h0, h1 = max(brq_h, q0 - HALO), min(2 * brq_h, q1 + HALO)

        def quad(p):
            return p[:, h0 - lo : h1 - lo, brq_w : 2 * brq_w]

        pre = kernels.brq_preprocess(quad(r8), quad(g8), quad(b8), quad(luma), row0=h0 - brq_h, total_h=brq_h)
        mine = slice(q0 - h0, q1 - h0)
        out["ocr_img"] = pre["ocr_img"][:, mine]
        out["scales_bool"] = pre["sbool"][:, mine].view(torch.bool)
        out["scales_bits"] = pre["scales_bits"][:, mine]
    else:  # no quadrant row in this block
        out["ocr_img"] = luma[:, :0, brq_w : 2 * brq_w]
        out["scales_bool"] = out["ocr_img"] != 0
        out["scales_bits"] = out["ocr_img"][..., : (brq_w + 7) // 8]
    return out


def analyze_batch(frames, mesh: Mesh, grayscale: bool = True) -> dict:
    """The fused pass over a batch of whole frames, u8 [B, H, W, 4] BGRA on
    the host (numpy or a CPU tensor), sharded (dp = frames, sp = map rows;
    B % dp == 0, any split of the rows). Returns smh_tpu's `_analyze_batch`
    keys -- ui, ui_check, lsd_bool, lsd_mask, lsd_bits, scales_bits,
    scales_bool, ocr_img, quiet_bool, red_ratio -- as lists of one tensor
    per dp row on the row's sp-0 device; frame by frame they equal
    ops/pipeline.py::analyze_frame's."""
    frames = _host_frames(frames)
    b, h, w, _ = frames.shape
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if b % dp:
        raise ValueError(f"a batch of {b} frames does not split over dp={dp}")
    g = C.map_geometry(w, h)
    splits = row_splits(g.map_h, sp)
    per = b // dp
    out: dict = {}
    for d, row in enumerate(mesh.devices):
        mine = frames[d * per : (d + 1) * per]
        home = row[0]
        blocks = [_analyze_block(mine, r0, r1, g, dev, grayscale) for (r0, r1), dev in zip(splits, row)]
        joined = {k: torch.cat([blk[k].to(home) for blk in blocks], dim=1) for k in blocks[0]}
        ui = joined["ui"]
        joined["lsd_mask"] = opp.mask_u8(joined["lsd_bool"])
        btn = mine[:, g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w, :3]
        # The red gate and the ui checksum by kernel 9 with no section: the
        # 12 bytes of a hostpack's head.
        head = kernels.hostpack_tail(
            (ui,) if grayscale else (ui[..., 0], ui[..., 1], ui[..., 2]),
            torch.from_numpy(np.ascontiguousarray(btn)).to(home),
        )
        joined["red_ratio"] = head[:, :4].view(torch.float32).reshape(-1)
        joined["ui_check"] = head[:, 4:].view(torch.int32).to(torch.int64) & opp.U32_MASK
        for k, v in joined.items():
            out.setdefault(k, []).append(v)
    return out


def _rows_of(x, mesh: Mesh, dtype) -> list:
    """x split over the dp rows onto their sp-0 devices: a list of one
    tensor per row is taken as it is (moved to the row's device), else
    x [B, ...] (numpy or a tensor) is cut into dp equal slices."""
    homes = mesh.row_devices()
    if isinstance(x, (list, tuple)):
        if len(x) != len(homes):
            raise ValueError(f"{len(x)} row tensors for dp={len(homes)}")
        return [t.to(dev) for t, dev in zip(x, homes)]
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    t = t.to(dtype)
    if t.shape[0] % len(homes):
        raise ValueError(f"a batch of {t.shape[0]} does not split over dp={len(homes)}")
    per = t.shape[0] // len(homes)
    return [t[d * per : (d + 1) * per].to(dev) for d, dev in enumerate(homes)]


def _march_rows(masks, pts, mesh: Mesh, max_gap: int) -> list:
    """ops/lsd.py::ray_march's outputs for each dp row: its masks, one per
    seed, marched to the fixed depth _max_k in one call (one launch)."""
    out = []
    for m, p in zip(_rows_of(masks, mesh, torch.uint8), _rows_of(pts, mesh, torch.float32)):
        mh, mw = m.shape[-2:]
        cos_t, sin_t = ops_lsd.theta_tables(m.device)
        out.append(ops_lsd.ray_march(m, p, int(max_gap), ops_lsd._max_k(mh, mw), cos_t, sin_t))
    return out


def march_batch(masks, pts, mesh: Mesh, max_gap: int = C.LSD_MAX_GAP):
    """Batched longest-line march, one seed per frame: masks u8 [B, mh, mw]
    (or analyze_batch's per-row "lsd_mask" lists), pts f32 [B, 2]. Returns
    (ends [N, 2], lengths [N]) per frame as lists of one tensor per dp row
    ([B / dp, N, 2], [B / dp, N]); the counterpart of smh_tpu's vmapped
    lsd._march."""
    ends, lengths = [], []
    for (ex, ey, *_), p in zip(_march_rows(masks, pts, mesh, max_gap), _rows_of(pts, mesh, torch.float32)):
        ends.append(torch.stack([ex, ey], dim=-1))
        lx = p[:, 0:1] - ex  # finalize_plain's lengths, as _march returns them
        ly = p[:, 1:2] - ey
        lengths.append(lx * lx + ly * ly)
    return ends, lengths


def full_step(frames, pts, mesh: Mesh) -> dict:
    """One complete sharded step: analyze_batch over (dp, sp), the march of
    each frame's lsd_mask from its seed over dp, and each frame's winner
    (ties to the last angle, as smh_tpu's full_step and lsd._finalize
    decide; kernel 4's best outputs). Returns red_ratio, ui, best_end
    [B / dp, 2] and best_length_sqr [B / dp] per dp row."""
    outs = analyze_batch(frames, mesh)
    rows = _march_rows(outs["lsd_mask"], pts, mesh, C.LSD_MAX_GAP)
    return {
        "red_ratio": outs["red_ratio"],
        "ui": outs["ui"],
        "best_end": [torch.stack([bx, by], dim=-1) for _, _, bx, by, _ in rows],
        "best_length_sqr": [bl for *_, bl in rows],
    }
