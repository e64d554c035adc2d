"""The port's own host half against the JAX package's on the CPU.

Every module that smh_tpu_torch copied from smh_tpu parses to the same AST
as its original once imports are normalised, apart from a short named list
of intended differences per module; the copied data files are byte-equal.
Then the copies behave as the originals on seeded inputs: the native module
(bytes), the numpy oracle (markers, ratio, minimap), the OCR reader, the web
protocol's encodings, the frame maker and the App. Values cross the package
boundary as plain tuples: the two packages' dataclasses never compare equal."""

import ast
import dataclasses
import pathlib
import time

import numpy as np
import pytest
import torch

from smh_tpu import app as japp
from smh_tpu import native as jnative
from smh_tpu import testing as jtesting
from smh_tpu.geometry import Rect as JRect
from smh_tpu.ocr.smhocr import SmhOcrEngine as JSmhOcrEngine
from smh_tpu.settings import Settings as JSettings
from smh_tpu.squadex.capture import Frame as JFrame
from smh_tpu.squadex.heightmaps import Heightmap as JHeightmap
from smh_tpu.vision import pipeline as jpipeline
from smh_tpu.vision.reference import ReferenceBackend as JReferenceBackend
from smh_tpu.web import protocol as jprotocol
from smh_tpu_torch import app as tapp
from smh_tpu_torch import native as tnative
from smh_tpu_torch import testing
from smh_tpu_torch.geometry import Rect
from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
from smh_tpu_torch.settings import Settings
from smh_tpu_torch.squadex.capture import Frame
from smh_tpu_torch.squadex.heightmaps import Heightmap
from smh_tpu_torch.utils.plot import plot_line
from smh_tpu_torch.vision import pipeline as tpipeline
from smh_tpu_torch.vision.reference import ReferenceBackend
from smh_tpu_torch.web import protocol
from test_torch_reference import _reference_native  # noqa: F401  (module-scoped autouse fixture)

torch.set_num_threads(1)


ROOT = pathlib.Path(__file__).resolve().parent.parent
JPKG, TPKG = ROOT / "smh_tpu", ROOT / "smh_tpu_torch"

# Each copied module -> the top-level entries (names, "Class.method", import
# statements) that differ from the original on purpose.
COPIES = {
    "consts.py": set(),
    "geometry.py": set(),
    # The lsd_engine setting: the CUDA backend's line search, "native" or "cuda".
    "settings.py": {"__doc__", "_DEFAULTS", "LSD_ENGINES", "Settings.load", "Settings.set", "Settings.lsd_engine"},
    "utils/__init__.py": set(),
    # The span recorder: every timeshare is also a record of a bounded ring
    # (spans, frame ids, SMH_TRACE, the Chrome trace writer).
    "utils/timeshares.py": {
        "__doc__", "import collections", "import contextlib", "import itertools", "import json", "import os",
        "import threading", "ENABLED", "CAPACITY", "(WORK, WAIT, QUEUE)", "Record", "(_START, _END)", "Ring",
        "Ring.__doc__", "Ring.__init__", "Ring.append", "Ring.records", "RING", "_ids", "_frames",
        "_local", "new_frame", "_stack", "span", "span.__doc__",
        "span: __slots__ = ('name', 'kind', 'frame', 'cpu', 'start', 'end', '_id', '_parent', '_cpu0', '_shares', "
        "'_stage')",
        "span.__init__", "span.__enter__", "span.__exit__", "span.seconds", "add", "_STAGE_SPANS", "timeshare",
        "write_chrome_trace",
    },
    "utils/plot.py": set(),
    "utils/ringlog.py": set(),
    # Builds into smh_tpu_torch/build/native-<hash>/ under a temporary name
    # renamed into place, one process at a time under a file lock, and keeps
    # the compiler's message; the batch delta path's roll in row bands
    # (smhroll.cpp, built into the same library) and its wrappers.
    "native/__init__.py": {
        "__doc__", "_SO", "_BUILD_ROOT", "_FLAGS", "build_error", "lib_path", "_build", "load",
        "import fcntl", "import hashlib", "import os", "import shutil",
        "_ROLL_SRC", "roll_band_cap", "_ptrs", "roll_frames", "roll_band", "roll_merge",
    },
    "vision/pixmath.py": set(),
    "vision/lsd.py": set(),
    "vision/reference.py": set(),
    "vision/find_minimap.py": set(),
    "vision/mpx_ratio.py": set(),
    "vision/inspect.py": set(),
    # The delegate picks CudaBackend on an explicit device; no TPU fallback.
    # The submit and consume halves, the branches and the loop's waits are
    # spans under the frame's id.
    "vision/pipeline.py": {
        "__doc__", "make_backend", "BackendDelegate.__doc__", "BackendDelegate.__init__",
        "BackendDelegate.current", "BackendDelegate.mark_tpu_failed", "VisionState.__init__",
        "VisionState.process", "from .. import resolve_device", "from .cuda_backend import CudaBackend",
        "from ..utils.timeshares import Timeshares, timeshare",
        "from ..utils.timeshares import WAIT, Timeshares, add, new_frame, span, timeshare", "_frame_id",
        "VisionState.submit", "VisionState._process", "VisionLoop._next_frame", "VisionLoop._step",
        "VisionLoop._run_threaded", "VisionLoop._run",
    },
    "ocr/__init__.py": set(),
    "ocr/engine.py": set(),
    "ocr/fake.py": set(),
    "ocr/smhocr.py": {"FONT_DIR", "FONTS", "_FONTS", "import pathlib"},  # the bundled fonts
    "ocr/tesseract.py": set(),
    "squadex/__init__.py": set(),
    # A frame's id (given at the take), the grab's span and the mailbox's record.
    "squadex/capture.py": {
        "import time", "from ..utils.timeshares import QUEUE, add, new_frame, span",
        "Frame: seq: Optional[int] = dataclasses.field(default=None, compare=False)", "CaptureThread.__init__",
        "CaptureThread.fresh_frame", "CaptureThread._run",
    },
    "squadex/heightmaps.py": set(),
    "squadex/solutions.py": {"__doc__"},  # cites the reference's sources without a machine path
    "squadex/milliradians.py": {"__doc__"},
    "web/__init__.py": set(),
    "web/protocol.py": set(),
    "web/server.py": set(),
    "heightmaps/__init__.py": set(),
    "heightmaps/ripper.py": set(),
    "heightmaps/browser.py": set(),
    "heightmaps/stub_ripper.py": {"__doc__"},  # run as smh_tpu_torch.heightmaps.stub_ripper
    "ocr/tessdata_gen.py": {"__doc__"},
    # Builds into smh_tpu_torch/build/smhtess-<hash>/ under a temporary name
    # renamed into place, as native/__init__.py builds smhnative.
    "native/tessmock.py": {"__doc__", "_SO", "_BUILD_ROOT", "_FLAGS", "lib_path", "import hashlib", "import os"},
    "vision/backend.py": {"__doc__"},  # implemented by CudaBackend
    # --device to the child and its VisionState; a CUDA init and an 8-byte
    # round trip as the device attach; no compile cache; spawned as
    # -m smh_tpu_torch.worker; the socket in the temporary directory; a
    # reset from a child that exited with frames unread is its EOF.
    "worker.py": {
        "__doc__", "_serve", "main", "WorkerClient.__init__", "WorkerClient._spawn", "WorkerClient._supervise",
        "import tempfile",
    },
    # Scale texts rendered from the bundled fonts; the screen sizes the
    # port is held at, with a frame for each; the edge cases of the scales
    # read kernel, of the quadrant preprocess kernel, of the mask words
    # kernel, of the window crop kernel and of the OCR band kernel.
    "testing.py": {
        "__doc__", "fonts_present", "make_frame", "render_text_mask", "from .ocr.smhocr import FONTS",
        "RESOLUTIONS", "resolution_frame", "scales_read_cases", "text_rgb", "brq_preprocess_cases",
        "mask_bits_cases", "window_crop_cases", "ocr_band_cases",
    },
    # --device (the App, its worker and --warmup run on it), no compile cache;
    # --trace-out writes the span recorder's ring at exit; --lsd-engine and
    # /api/settings' lsd_engine.
    "app.py": {
        "__doc__", "App.__init__", "App._run_worker_feeder", "App._api", "build_parser", "load_settings", "main",
        "from .settings import Settings", "from .settings import LSD_ENGINES, Settings",
    },
}
DATA_FILES = ["consts.toml", "native/smhnative.cpp", "native/smhtess.cpp", "web/www/index.html"]
# The port's own modules: the device half and the package's entry points.
PORT_ONLY = {
    "__init__.py", "_build.py", "_probe.py", "probe_classify.py", "probe_quiet_walk.py", "probe_ray_march.py",
    "probe_scales_read.py", "probe_brq_preprocess.py", "probe_mask_words.py", "probe_pass.py", "probe_hostpack.py",
    "probe_delta_apply.py", "probe_window_crop.py", "probe_ocr_band.py",
    "ops/__init__.py", "ops/hsv.py", "ops/kernels.py", "ops/lsd.py",
    "ops/pipeline.py", "ops/scales_device.py", "ops/warmup.py", "vision/__init__.py", "vision/batch.py",
    "vision/cuda_backend.py", "parallel/__init__.py", "parallel/dryrun.py", "parallel/spmd.py",
    # The operator entry points: copies of the repo's tools/*.py (scripts
    # outside smh_tpu), held to them by value in tests/test_torch_tools.py.
    "tools/__init__.py", "tools/analyze_video.py", "tools/compare_backends.py", "tools/render_detections.py",
    "tools/soak_corpus.py", "tools/soak_worker.py", "tools/probe_cold_start.py",
}


def _entries(path: pathlib.Path, pkg: str) -> dict:
    """{entry: normalised AST dump} of a module's top level, with each class
    split into its header and its members and the package's own name
    replaced in imports."""
    out = {}

    def add(key, node):
        out[key] = ast.dump(node).replace(f"'{pkg}.", "'PKG.").replace(f"'{pkg}'", "'PKG'")

    def is_doc(node):
        return isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)

    for i, node in enumerate(ast.parse(path.read_text()).body):
        if i == 0 and is_doc(node):
            add("__doc__", node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            add(ast.unparse(node).replace(pkg, "PKG"), node)
        elif isinstance(node, ast.ClassDef):
            add(node.name, ast.ClassDef(name=node.name, bases=node.bases, keywords=node.keywords, body=[],
                                        decorator_list=node.decorator_list, type_params=[]))
            for j, sub in enumerate(node.body):
                if j == 0 and is_doc(sub):
                    add(f"{node.name}.__doc__", sub)
                elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add(f"{node.name}.{sub.name}", sub)
                else:
                    add(f"{node.name}: {ast.unparse(sub)}", sub)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add(node.name, node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            add(" ".join(ast.unparse(t) for t in targets), node)
        else:
            add(ast.unparse(node), node)
    return out


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_matches_its_original_ast(rel):
    """The copy equals the original entry by entry, except the intended
    differences, each of which really differs (a stale list fails too)."""
    orig = _entries(JPKG / rel, "smh_tpu")
    copy = _entries(TPKG / rel, "smh_tpu_torch")
    differing = {k for k in set(orig) | set(copy) if orig.get(k) != copy.get(k)}
    assert differing == COPIES[rel], sorted(differing ^ COPIES[rel])


@pytest.mark.parametrize("rel", DATA_FILES)
def test_data_file_is_byte_equal(rel):
    assert (TPKG / rel).read_bytes() == (JPKG / rel).read_bytes()


def test_every_port_module_is_a_listed_copy_or_the_ports_own():
    mods = {str(p.relative_to(TPKG)) for p in TPKG.rglob("*.py") if "build" not in p.relative_to(TPKG).parts}
    assert mods == set(COPIES) | PORT_ONLY, sorted(mods ^ (set(COPIES) | PORT_ONLY))


# -- the native module ---------------------------------------------------------------


@pytest.fixture(scope="module")
def natives():
    assert tnative.available(), tnative.build_error
    assert jnative.available()
    return tnative, jnative


def _rois(rng, h=120, w=200):
    """Strided BGRA map and button views of one seeded frame."""
    frame = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    return frame[10 : h - 30, 20 : w - 40], frame[h - 25 : h - 5, w - 35 : w - 5]


def _packed_size(map_roi, btn_roi):
    n = (map_roi.shape[0] * map_roi.shape[1] + btn_roi.shape[0] * btn_roi.shape[1]) * 3
    return (n + 31) // 32 * 32


@pytest.mark.parametrize("seed", range(3))
def test_native_pack_diff_bytes_equal(natives, seed):
    """pack_diff (pack-only and against a mirror with sparse changes) and
    pack_diff_roll: packed bytes, counts and changed indices."""
    rng = np.random.default_rng(seed)
    map_roi, btn_roi = _rois(rng)
    size = _packed_size(map_roi, btn_roi)
    base = np.zeros(size, np.uint8)
    tnative.pack_diff(map_roi, btn_roi, base, None, None, None)
    prev = base.copy()  # the previous frame's bytes: the same frame with sparse changes
    prev[rng.integers(0, size, 40)] ^= 0x5A
    results = []
    for mod in natives:
        packed = np.zeros(size, np.uint8)
        assert mod.pack_diff(map_roi, btn_roi, packed, None, None, None) == -1
        out, mirror = np.zeros(size, np.uint8), prev.copy()
        dirty, idx = np.zeros(size // 32, np.uint8), np.zeros(size // 32, np.int32)
        n = mod.pack_diff(map_roi, btn_roi, out, mirror, dirty, idx)
        roll, idx_roll = prev.copy(), np.zeros(size // 32, np.int32)
        n_roll = mod.pack_diff_roll(map_roi, btn_roi, roll, np.zeros(size // 32, np.uint8), idx_roll)
        results.append((packed.tobytes(), out.tobytes(), mirror.tobytes(), n, idx[:n].tobytes(),
                        roll.tobytes(), n_roll, idx_roll[:n_roll].tobytes()))
    assert results[0] == results[1]
    assert results[0][3] > 0 and results[0][0] == base.tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_native_diff_and_gather_bytes_equal(natives, seed):
    rng = np.random.default_rng(10 + seed)
    a = rng.integers(0, 256, 32 * 500, dtype=np.uint8)
    b = a.copy()
    b[rng.integers(0, a.size, 25)] += 1
    results = []
    for mod in natives:
        idx = np.zeros(a.size // 32, np.int32)
        n = mod.diff_subchunks(a, b, idx)
        bucket = 32
        out = np.zeros(bucket * 4 + bucket * 32, np.uint8)
        mod.gather_subchunks(b, idx, n, bucket, out)
        results.append((n, idx[:n].tobytes(), out.tobytes()))
    assert results[0] == results[1]
    assert 0 < results[0][0] <= 25


def _line_mask(rng, h=180, w=260):
    mask = np.zeros((h, w), np.uint8)
    for _ in range(4):
        x0, x1 = rng.integers(5, w - 5, 2)
        y0, y1 = rng.integers(5, h - 5, 2)
        plot_line(mask, int(x0), int(y0), int(x1), int(y1), 255)
    mask[rng.integers(0, h, 30), rng.integers(0, w, 30)] = 255  # specks
    return mask


def _lines(lines):
    return [(l.p0.x, l.p0.y, l.p1.x, l.p1.y) for l in lines]


@pytest.mark.parametrize("seed", range(3))
def test_native_find_lines_equal(natives, seed):
    """find_lines on a full mask and on a windowed crop of it, and the
    single-seed march: the same lines, float for float."""
    from smh_tpu.geometry import Point as JPoint
    from smh_tpu_torch.geometry import Point

    mask = _line_mask(np.random.default_rng(20 + seed))
    ys, xs = np.nonzero(mask)
    y0, x0 = int(ys.min()), int(xs.min())
    crop = mask[y0 : ys.max() + 1, x0 : xs.max() + 1]
    got, want = (
        [_lines(mod.find_lines(mask, 15)), _lines(mod.find_lines(crop, 15, full_shape=mask.shape, offset=(x0, y0)))]
        for mod in natives
    )
    assert got == want and got[0] == got[1] and got[0]
    (tl, tlen), (jl, jlen) = (
        tnative.find_longest_line(mask, Point(float(xs[0]), float(ys[0])), 15.0),
        jnative.find_longest_line(mask, JPoint(float(xs[0]), float(ys[0])), 15.0),
    )
    assert _lines([tl]) == _lines([jl]) and tlen == jlen


# -- the numpy oracle, the OCR reader and the frame maker ------------------------------

FRAMES = {
    "720p": dict(w=1280, h=720, marker_lines=[((100, 100), (420, 300))], scale_texts=[("300m", (60, 170))],
                 scale_bars=[(60, 200, 120, 1)]),
    "1080p_two_lines": dict(w=1920, h=1080, marker_lines=[((120, 150), (700, 520)), ((300, 700), (900, 640))],
                            scale_texts=[("900m", (60, 170))], scale_bars=[(60, 200, 118, 1)]),
    "no_button": dict(w=960, h=540, with_button=False),
}


def _make(pkg_testing, name):
    kw = dict(FRAMES[name])
    return pkg_testing.make_frame(kw.pop("w"), kw.pop("h"), **kw)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_make_frame_equals_the_originals(name):
    """The port's frames (fonts bundled) are smh_tpu's (system fonts)."""
    np.testing.assert_array_equal(_make(testing, name), _make(jtesting, name))


def _stages(be, frame):
    be.load_frame(frame)
    cropped = be.crop_to_map(grayscale=True)
    if cropped is None:
        return None
    be.isolate_map_markers()
    be.mask_marker_lines()
    return cropped[1], be.ocr_preprocess(), _lines(be.find_marker_lines(15))


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_reference_backend_stages_equal(name):
    frame = _make(testing, name)
    got, want = _stages(ReferenceBackend(), frame), _stages(JReferenceBackend(), frame)
    if want is None:
        assert got is None
        return
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])


def _result(res):
    if res is None:
        return None
    mm = res.minimap_bounds
    return (_lines(res.markers), res.meters_to_px_ratio, None if mm is None else dataclasses.astuple(mm))


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_oracle_vision_state_matches(name):
    """VisionState on the numpy oracle with smhocr: markers, ratio, minimap."""
    frame = _make(testing, name)
    port_s, ref_s = Settings(path=None), JSettings(path=None)
    for s in (port_s, ref_s):
        s.set("hardware_acceleration", False, save=False)
    port = tpipeline.VisionState(settings=port_s, ocr_engine=SmhOcrEngine(), device="cpu")
    ref = jpipeline.VisionState(settings=ref_s, ocr_engine=JSmhOcrEngine())
    try:
        assert port.delegate.current().name == ref.delegate.current().name == "numpy"
        got, want = _result(port.process(Frame(frame, 96))), _result(ref.process(JFrame(frame, 96)))
    finally:
        port.close()
        ref.close()
    assert got == want
    if name != "no_button":
        assert got[0] and got[1] is not None and got[2] is not None


@pytest.mark.parametrize("label", ["300m", "900m", "1200m", "75m"])
def test_smhocr_reads_equal(label):
    """The oracle's OCR image of a frame with a rendered scale label: both
    readers return the same results, the label among them."""
    frame = testing.make_frame(1280, 720, scale_texts=[(label, (60, 170))], scale_bars=[(60, 200, 120, 1)])
    be = ReferenceBackend()
    be.load_frame(frame)
    assert be.crop_to_map(True) is not None
    img = be.ocr_preprocess()
    got = [dataclasses.astuple(r) for r in SmhOcrEngine().read(img, dpi=96)]
    want = [dataclasses.astuple(r) for r in JSmhOcrEngine().read(img, dpi=96)]
    assert got == want and label in {g[0] for g in got}


# -- the web protocol -------------------------------------------------------------------


def test_protocol_encodings_byte_equal():
    rng = np.random.default_rng(7)
    rgba = rng.integers(0, 256, (9, 13, 4), dtype=np.uint8)
    markers = [((1.5, 2.25), (30.0, 40.75)), ((0.0, 0.0), (5.5, -3.0))]
    data = rng.integers(0, 65535, (6, 5), dtype=np.uint16)
    hm = dict(width=5, height=6, bounds=((-100, 200), (300, -400)), scale=(1.0, 2.0, 512.0))
    pairs = [
        (protocol.encode_map(rgba), jprotocol.encode_map(rgba)),
        (protocol.encode_markers(markers, True), jprotocol.encode_markers(markers, True)),
        (protocol.encode_markers([], False), jprotocol.encode_markers([], False)),
        (protocol.encode_update_state(2.542373, Rect(left=10, top=20, right=300, bottom=400)),
         jprotocol.encode_update_state(2.542373, JRect(left=10, top=20, right=300, bottom=400))),
        (protocol.encode_update_state(None, None), jprotocol.encode_update_state(None, None)),
        (protocol.encode_heightmap(Heightmap(data=data, **hm)), jprotocol.encode_heightmap(JHeightmap(data=data, **hm))),
        (protocol.encode_heightmap(None), jprotocol.encode_heightmap(None)),
        (protocol.encode_fit_to_minimap(True), jprotocol.encode_fit_to_minimap(True)),
        (protocol.encode_debug({"fps": 14.9, "stages": [1, 2]}), jprotocol.encode_debug({"fps": 14.9, "stages": [1, 2]})),
        (protocol.encode_inspect({"x": 3, "rgb": [1, 2, 3]}), jprotocol.encode_inspect({"x": 3, "rgb": [1, 2, 3]})),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got == want, i


@pytest.mark.parametrize("data", [
    b"\x01\x00" + np.array([1.5, 2.0, 3.25, -4.0], "<f4").tobytes(),
    b"\x02\x00\x07\x00\x00\x00",
    b"\x03\x00\x05\x00\x00\x00\x09\x00\x00\x00",
    b"\x01\x00\x00", b"\x09\x00", b"\x01",
], ids=["add", "delete", "inspect", "short_add", "unknown", "truncated"])
def test_protocol_decodes_equal(data):
    got, want = protocol.decode_interaction(data), jprotocol.decode_interaction(data)
    assert (got is None) == (want is None)
    if got is not None:
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


# -- the App --------------------------------------------------------------------------


def _first_update(app, timeout=90.0):
    updates = []
    deliver = app.loop.on_update
    app.loop.on_update = lambda r, d: (updates.append(r), deliver(r, d))
    app.start()
    try:
        deadline = time.time() + timeout
        while not any(r is not None for r in updates) and time.time() < deadline:
            time.sleep(0.02)
    finally:
        app.stop()
    return next((r for r in updates if r is not None), None)


def test_app_on_the_numpy_oracle_matches_smh_tpus_app():
    """`--synthetic --backend numpy --device cpu --no-web`: the port's App
    (its parser, source, settings and engine) and smh_tpu's App deliver the
    same first update and answer /api/status alike."""
    args = tapp.build_parser().parse_args(["--synthetic", "--backend", "numpy", "--device", "cpu", "--no-web"])
    port_s, ref_s = Settings(path=None), JSettings(path=None)
    for s in (port_s, ref_s):
        s.set("hardware_acceleration", False, save=False)
    port = tapp.App(tapp._build_source(args), settings=port_s, device=args.device, serve=False,
                    ocr_engine=SmhOcrEngine())
    ref = japp.App(japp._build_source(args), settings=ref_s, serve=False, ocr_engine=JSmhOcrEngine())
    got, want = _first_update(port), _first_update(ref)
    assert got is not None and want is not None
    assert _result(got) == _result(want)
    assert len(got.markers) == 1
    assert port._api("/api/status", {}) == ref._api("/api/status", {})
    assert port._api("/api/status", {})[1]["backend"] == "numpy"


# -- firing solutions, the ripper stand-in, the Tesseract mock ---------------------------


def test_milliradians_equal_over_the_table():
    from smh_tpu.squadex import milliradians as jmil
    from smh_tpu_torch.squadex import milliradians as tmil

    for meters in np.linspace(0.0, 1400.0, 281):
        for alt in (-120.0, -7.5, 0.0, 33.0, 250.0):
            got, want = tmil.calc(float(meters), alt), jmil.calc(float(meters), alt)
            assert got == want or (np.isnan(got) and np.isnan(want)), (meters, alt)


@pytest.mark.parametrize("seed", range(3))
def test_solutions_equal_on_seeded_lines(seed):
    """solve() through the heightmap (fitted and offset), by the scale
    ratio alone, and with neither."""
    from smh_tpu.geometry import Line as JLine
    from smh_tpu.squadex import solutions as jsol
    from smh_tpu_torch.geometry import Line
    from smh_tpu_torch.squadex import solutions as tsol

    rng = np.random.default_rng(30 + seed)
    data = rng.integers(0, 65535, (64, 80), dtype=np.uint16)
    hm = dict(width=80, height=64, bounds=((-4, -3), (84, 67)), scale=(1.0, 1.0, 512.0))
    hms = Heightmap(data=data, **hm), JHeightmap(data=data, **hm)
    rects = Rect(left=10, top=20, right=410, bottom=340), JRect(left=10, top=20, right=410, bottom=340)
    for _ in range(8):
        (x0, y0), (x1, y1) = rng.uniform(0, 420, (2, 2))
        ends = ((float(x0), float(y0)), (float(x1), float(y1)))
        for ratio, bounds, fit in ((None, True, False), (None, True, True), (2.542373, False, False), (None, False, False)):
            got, want = (
                sol.solve(L.from_tuple(ends), ratio, r if bounds else None, h if bounds else None, fit)
                for sol, L, r, h in ((tsol, Line, rects[0], hms[0]), (jsol, JLine, rects[1], hms[1]))
            )
            assert (got is None) == (want is None)
            if got is not None:
                a, b = np.array(dataclasses.astuple(got), float), np.array(dataclasses.astuple(want), float)
                np.testing.assert_array_equal(a, b)


def test_stub_ripper_writes_the_same_bytes(monkeypatch):
    import io
    import sys

    from smh_tpu.heightmaps import stub_ripper as jstub
    from smh_tpu_torch.heightmaps import stub_ripper as tstub

    outs = []
    for mod in (tstub, jstub):
        for argv in (["-p", "paks"], ["-p", "paks", "-m", "Maps/Narva/Narva_RAAS_v1.umap", "-k", "0x0"],
                     ["-m", "Maps/Empty.umap"]):
            buf = io.BytesIO()
            monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(buf))
            assert mod.main(argv) == 0
            outs.append(buf.getvalue())
    assert outs[:3] == outs[3:]
    assert len(outs[1]) > 257 * 257 * 2


def test_traineddata_bytes_equal(tmp_path):
    from smh_tpu.ocr import tessdata_gen as jgen
    from smh_tpu_torch.ocr import tessdata_gen as tgen

    got = tgen.ensure_default(tmp_path / "port").read_bytes()
    assert got == jgen.write_traineddata(tmp_path / "jax" / "eng.traineddata").read_bytes()
    assert got[:4] == b"SMHT"


def test_smhtess_mocks_read_alike(tmp_path, monkeypatch):
    """The port's smhtess build (smh_tpu_torch/build/smhtess-<hash>/) and the
    JAX package's read the same OCR band alike through one binding."""
    from smh_tpu.native import tessmock as jmock
    from smh_tpu_torch.native import tessmock as tmock
    from smh_tpu_torch.ocr import tesseract as ttess
    from smh_tpu_torch.ocr.tessdata_gen import ensure_default

    so = tmock.lib_path()
    assert so is not None and so.parent.parent == tmock._BUILD_ROOT
    assert tmock.lib_path() == so  # built once
    jso = jmock.lib_path()
    if jso is None:
        pytest.skip("no C++ toolchain for the JAX package's smhtess")
    ensure_default(tmp_path)
    frame = testing.make_frame(1280, 720, scale_texts=[("900m", (60, 170))], scale_bars=[(60, 200, 120, 1)])
    be = ReferenceBackend()
    be.load_frame(frame)
    assert be.crop_to_map(True) is not None
    img = be.ocr_preprocess()
    reads = []
    for lib in (so, jso):
        monkeypatch.setenv("SMH_TESS_LIB", str(lib))
        reads.append([dataclasses.astuple(r) for r in ttess.TesseractEngine(tessdata=str(tmp_path)).read(img, dpi=96)])
    assert reads[0] == reads[1] and "900m" in {r[0] for r in reads[0]}
