"""The line search on the card as a deployment of the port, on the CPU: the
`lsd_engine` setting through the delegate, the command line and the web
API; VisionState with lsd_engine="cuda" (the host seed scan over the ray
march's plain twin, through the same wrapper as on a card) on frames of the
benchmark's `markers` traffic against the benchmark's plain reference and
the native engine; the engine's spans, counters and copied bytes; and the
benchmark's readers of them on hand-built runs.

The frames are 1920x1080: the traffic is drawn in 1080p units, and at
1280x720 its lines leave the 657x548 map."""

import json
import time

import pytest
import torch

from smh_tpu_torch import app as tapp
from smh_tpu_torch import testing
from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
from smh_tpu_torch.ops import lsd as tlsd
from smh_tpu_torch.settings import Settings
from smh_tpu_torch.squadex.capture import Frame, StaticSource
from smh_tpu_torch.utils import timeshares as T
from smh_tpu_torch.vision import cuda_backend as cb
from smh_tpu_torch.vision.pipeline import BackendDelegate, VisionState
from smhbench import compare, harness
from smhbench import reference as R
from smhbench import traffic as TR
from test_torch_reference import port_native  # noqa: F401  (module-scoped fixture)

torch.set_num_threads(1)

W, H = 1920, 1080
SEED = 2718281828
FRAMES = (0, 5, 11)
ENGINES = ("cuda", "native")
NEW_READERS = ["lsd_scan_ms.live", "lsd_march_wait_ms.live", "lsd_marches_per_update.live",
               "lsd_seeds_per_update.live", "ray_march_us_per_update.live", "ray_march_roofline.live"]

pytestmark = pytest.mark.usefixtures("port_native")


def _settings(engine=None) -> Settings:
    s = Settings(path=None)
    s.set("hardware_acceleration", True, save=False)
    if engine:
        s.set("lsd_engine", engine, save=False)
    return s


# -- the setting -------------------------------------------------------------------


def test_delegate_follows_the_setting_across_a_backend_cycle():
    s = _settings()
    d = BackendDelegate(s, "cpu")
    be = d.current()
    assert be.name == "cuda" and be.lsd_engine == "native"
    view = be.snapshot_job()
    s.set("lsd_engine", "cuda", save=False)
    assert d.current() is be and be.lsd_engine == "cuda"
    assert view.lsd_engine == "native"  # a frame already submitted keeps its engine
    s.set("hardware_acceleration", False, save=False)
    assert d.current().name == "numpy"
    s.set("hardware_acceleration", True, save=False)
    again = d.current()
    assert again is not be and again.name == "cuda" and again.lsd_engine == "cuda"
    s.set("lsd_engine", "native", save=False)
    assert d.current() is again and again.lsd_engine == "native"


def test_the_setting_is_checked_saved_and_loaded(tmp_path):
    path = tmp_path / "settings.json"
    s = Settings(path=str(path))
    assert s.lsd_engine() == "native"
    s.set("lsd_engine", "cuda")
    assert json.loads(path.read_text())["lsd_engine"] == "cuda"
    assert Settings(path=str(path)).lsd_engine() == "cuda"
    with pytest.raises(ValueError):
        s.set("lsd_engine", "tpu")
    path.write_text(json.dumps({"lsd_engine": "tpu", "grayscale_map": False}))
    loaded = Settings(path=str(path))
    assert loaded.lsd_engine() == "native" and loaded.grayscale_map() is False


def test_the_flag_sets_the_setting_for_the_run(tmp_path):
    path = tmp_path / "settings.json"
    path.write_text(json.dumps({"lsd_engine": "native"}))
    parse = tapp.build_parser().parse_args
    assert tapp.load_settings(parse(["--lsd-engine", "cuda", "--settings", str(path)])).lsd_engine() == "cuda"
    assert json.loads(path.read_text())["lsd_engine"] == "native"  # the file is not rewritten
    assert tapp.load_settings(parse(["--settings", str(path)])).lsd_engine() == "native"
    assert parse(["--synthetic"]).lsd_engine is None
    with pytest.raises(SystemExit):
        parse(["--lsd-engine", "tpu"])


def test_the_web_api_reads_and_sets_the_engine():
    app = tapp.App(StaticSource(testing.make_frame(640, 480), dpi=96), settings=_settings(), device="cpu",
                   serve=False, ocr_engine=SmhOcrEngine())
    try:
        assert app._api("/api/settings", {})[1]["lsd_engine"] == "native"
        code, body = app._api("/api/settings/set", {"key": "lsd_engine", "value": "cuda"})
        assert code == 200 and body["lsd_engine"] == "cuda" and app.state.delegate.current().lsd_engine == "cuda"
        code, _ = app._api("/api/settings/set", {"key": "lsd_engine", "value": "gpu"})
        assert code == 400 and app.settings.lsd_engine() == "cuda"
    finally:
        app.state.close()


# -- the engine on the markers traffic --------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    """Three frames of the markers cycle through VisionState's submit and
    consume halves, once per engine, and the plain reference's answers:
    {"refs": [Answer], engine: {"served", "stats", "records", "batches"}},
    "batches" the seeds of each march batch."""
    tr = TR.load("markers")
    sc = TR.scene(tr, W, H, SEED)
    frames = [TR.frame(tr, sc, i) for i in FRAMES]
    out = {"refs": [R.run(f, 96, True)[0] for f in frames]}
    march_seeds = cb.ops_lsd.march_seeds
    for engine in ENGINES:
        batches = []

        def spy(mask, pts, *a, **k):
            batches.append(len(pts))
            return march_seeds(mask, pts, *a, **k)

        state = VisionState(settings=_settings(engine), ocr_engine=SmhOcrEngine(), device="cpu")
        cb.ops_lsd.march_seeds = spy
        before = time.perf_counter()
        try:
            served = []
            for f in frames:
                fr = Frame(f, 96)
                res = state.process(fr, None, state.submit(fr))
                served.append(harness.answer_of(res.markers, res.meters_to_px_ratio, res.minimap_bounds, False))
            stats = dict(state.delegate.backend.stats)
        finally:
            cb.ops_lsd.march_seeds = march_seeds
            state.close()
        recs = [r for r in T.RING.records(before) if r.start >= before]
        out[engine] = {"served": served, "stats": stats, "records": recs, "batches": batches}
    return out


def test_the_reference_finds_four_lines_on_each_frame(runs):
    assert [len(a.markers) for a in runs["refs"]] == [4] * len(FRAMES)


@pytest.mark.parametrize("engine", ENGINES)
def test_each_engine_serves_the_references_answers(runs, engine):
    lim = compare.limits("cudalsd-4k.markers")
    far = 1e9
    for got, want in zip(runs[engine]["served"], runs["refs"], strict=True):
        assert compare.marker_gap(got, want, far) <= lim["marker_gap_px"]
        assert compare.ratio_gap(got, want) <= lim["ratio_gap"]
        assert compare.minimap_gap(got, want, far) <= lim["minimap_gap_px"]


def test_the_cuda_engine_serves_the_native_engines_lines(runs):
    for a, b in zip(runs["cuda"]["served"], runs["native"]["served"], strict=True):
        assert compare.marker_gap(a, b, 1e9) <= 0.5


def test_the_engine_records_its_spans_and_counts_its_marches(runs):
    cuda, native = runs["cuda"], runs["native"]
    by_id = {r.id: r for r in cuda["records"]}
    scans = [r for r in cuda["records"] if r.name == "lsd.scan"]
    marches = [r for r in cuda["records"] if r.name == "lsd.march"]
    waits = [r for r in cuda["records"] if r.name == "lsd.march_wait"]
    assert len(scans) == len(FRAMES)
    assert all(r.kind == T.WORK and by_id[r.parent].name == "vision.find_marker_lines" for r in scans)
    n = len(cuda["batches"])
    assert len(marches) == len(waits) == cuda["stats"]["lsd_marches"] == n >= 4 * len(FRAMES)
    assert all(r.kind == T.WORK and by_id[r.parent].name == "lsd.scan" for r in marches)
    assert all(r.kind == T.WAIT and by_id[r.parent].name == "lsd.scan" for r in waits)
    assert cuda["stats"]["lsd_seeds_marched"] == sum(cuda["batches"])
    assert not any(r.name.startswith("lsd.") for r in native["records"])
    assert native["stats"]["lsd_marches"] == native["stats"]["lsd_seeds_marched"] == 0


def test_the_marches_copies_are_counted(runs):
    """The seeds' upload (f32 [bucket, 2]) in h2d_bytes and the winners'
    copy (f32 [3, bucket]) in d2h_bytes: the two engines' counts differ by
    exactly these (the same frames, transports and fetches otherwise)."""
    buckets = [tlsd._bucket(n) for n in runs["cuda"]["batches"]]
    cuda, native = runs["cuda"]["stats"], runs["native"]["stats"]
    assert cuda["h2d_bytes"] - native["h2d_bytes"] == sum(8 * b for b in buckets)
    assert cuda["d2h_bytes"] - native["d2h_bytes"] == sum(12 * b for b in buckets)


# -- the benchmark's readers ----------------------------------------------------------


def _rec(i, name, kind, parent, start, end):
    return (i, name, kind, 1, parent, 7, start, end, None)


RECS = [
    _rec(1, "lsd.scan", T.WORK, None, 10.10, 10.120),
    _rec(2, "lsd.march", T.WORK, 1, 10.101, 10.102),
    _rec(3, "lsd.march_wait", T.WAIT, 1, 10.102, 10.104),
    _rec(4, "lsd.march", T.WORK, 1, 10.110, 10.111),
    _rec(5, "lsd.march_wait", T.WAIT, 1, 10.111, 10.112),
    _rec(6, "lsd.scan", T.WORK, None, 11.00, 11.010),
    _rec(7, "lsd.march", T.WORK, 6, 11.001, 11.002),
    _rec(8, "lsd.march_wait", T.WAIT, 6, 11.002, 11.003),
    _rec(9, "lsd.scan", T.WORK, None, 9.00, 9.5),  # before the window
]
SLICE = {"lo": 10.0, "hi": 10.2, "rows": [
    ("hostpack_kernel", 10.05, 10.05 + 4e-6, "kernel"), ("ray_march_kernel", 10.1025, 10.1025 + 20e-6, "kernel"),
    ("ray_march_kernel", 10.1105, 10.1105 + 30e-6, "kernel"), ("hostpack_kernel", 10.15, 10.15 + 4e-6, "kernel"),
    ("Memcpy DtoH (Device -> Pinned)", 10.103, 10.103 + 2e-6, "copy")]}
STATS = {"frames": 4, "lsd_marches": 10, "lsd_seeds_marched": 70}


def _run(recs, monkeypatch, **kw):
    ring = T.Ring()
    for r in recs:
        ring.append(r)
    monkeypatch.setattr(T, "RING", ring)
    base = dict(cfg={}, t0=10.0, t1=12.0, paused_s=0.0, updates=[], spans=[], counters={"stats": dict(STATS)},
                slices=[SLICE], shapes={})
    base.update(kw)
    return harness.Run(**base)


def test_the_readers_of_the_engine(monkeypatch):
    from smhbench import march

    run = _run(RECS, monkeypatch)
    read = {name: harness.reader(name)(run) for name in NEW_READERS}
    assert read["lsd_scan_ms.live"] == pytest.approx(((20 - 1 - 2 - 1 - 1) + (10 - 1 - 1)) / 2)
    assert read["lsd_march_wait_ms.live"] == pytest.approx((2 + 1 + 1) / 2)
    assert read["lsd_marches_per_update.live"] == pytest.approx(2.5)
    assert read["lsd_seeds_per_update.live"] == pytest.approx(17.5)
    assert read["ray_march_us_per_update.live"] == pytest.approx(50.0 / 2)  # two passes in the slice
    least = 2 * 7 * march.OPS_PER_SEED / march.OPS_PER_S  # two launches of 7 seeds each
    assert read["ray_march_roofline.live"] == pytest.approx(100 * least / 50e-6)
    assert 0 < read["ray_march_roofline.live"] < 100
    assert march.OPS_PER_SEED == 10 * tlsd.N_ANGLES * (tlsd.C.LSD_MAX_GAP + 2)


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_reader_finds_nothing_on_a_program_without_the_engine(name, monkeypatch):
    """The native engine (no lsd spans, no ray_march rows, the counters 0)
    reads None or 0; the parent's program (no ring, no lsd counters) reads
    None; neither raises."""
    bare = {"frames": 4, "h2d_bytes": 1}
    quiet = [{**SLICE, "rows": SLICE["rows"][:1]}]
    native = [r for r in RECS if not r[1].startswith("lsd.")] + [
        _rec(20, "vision.find_marker_lines", T.WORK, None, 10.5, 10.6)]
    run = _run(native, monkeypatch, counters={"stats": {**bare, "lsd_marches": 0, "lsd_seeds_marched": 0}},
               slices=quiet)
    assert harness.reader(name)(run) in (None, 0.0)
    run = _run(RECS, monkeypatch, counters={"stats": bare}, slices=quiet)
    monkeypatch.delattr(T, "RING")
    assert harness.reader(name)(run) is None
