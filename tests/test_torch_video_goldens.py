"""Video goldens through the port: BatchPipeline(device="cpu") (the kernels'
plain versions) streams testing.make_video_frames' 24 frames at B=8, and
every frame's detections equal tests/goldens/video_1080p.json (smh_tpu's
oracle, regenerated by tools/gen_goldens_extra.py), with the rule of
tests/test_video_goldens.py: sleeping flags and line counts equal, each
line's ends within 1.5 px. After the seeding batch every batch rides the
delta chain."""

import json
import math
import pathlib

import torch

from smh_tpu_torch import testing
from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
from smh_tpu_torch.vision.batch import BatchPipeline

torch.set_num_threads(1)

GOLDEN = json.loads((pathlib.Path(__file__).parent / "goldens" / "video_1080p.json").read_text())


def test_batch_delta_chain_matches_video_goldens():
    w, h, n = GOLDEN["w"], GOLDEN["h"], GOLDEN["n"]
    frames = testing.make_video_frames(w, h, n)
    batch = 8
    bp = BatchPipeline(w, h, batch=batch, ocr_engine=SmhOcrEngine(), device="cpu")
    results = []
    try:
        for rs in bp.stream(frames[s : s + batch] for s in range(0, n, batch)):
            results.extend(rs)
        stats = dict(bp.stats)
    finally:
        bp.close()

    assert len(results) == n
    mismatches = []
    for i, (res, golden) in enumerate(zip(results, GOLDEN["frames"])):
        if res.sleeping != golden["sleeping"]:
            mismatches.append((i, "sleeping diverged"))
            continue
        if golden["sleeping"]:
            continue
        expected = golden["lines"]
        if len(res.markers) != len(expected):
            mismatches.append((i, f"{len(res.markers)} lines != {len(expected)}"))
            continue
        for l, e in zip(res.markers, expected):
            if (
                math.hypot(l.p0.x - e[0], l.p0.y - e[1]) > 1.5
                or math.hypot(l.p1.x - e[2], l.p1.y - e[3]) > 1.5
            ):
                mismatches.append((i, f"line off: {l} vs {e}"))
                break
    assert not mismatches, mismatches
    assert stats["delta_batches"] == n // batch - 1 and stats["full_batches"] == 1, stats
