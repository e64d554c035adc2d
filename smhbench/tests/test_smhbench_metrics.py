"""The metric arithmetic on hand-made inputs: rates and percentiles over
every sample of a window, the readers' means, the idle-share union, the
roofline share and the labels of the idle gaps."""

import pytest

from smhbench import harness, readers
from smhbench import yardstick as Y
from smhbench.reference import consts as C


def test_quantile_is_nearest_rank_over_all_values():
    xs = list(range(1, 101))
    assert Y.quantile(xs, 0.5) == 50 and Y.quantile(xs, 0.95) == 95 and Y.quantile(xs, 1.0) == 100
    assert Y.quantile([7.0], 0.95) == 7.0 and Y.quantile([3, 1, 2], 0.5) == 2
    with pytest.raises(ValueError):
        Y.quantile([], 0.5)


def test_union_and_gaps_cover_the_window_exactly():
    rows = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0), (3.5, 3.6)]
    assert Y.union_s(rows, 0.5, 10.0) == pytest.approx(1.5 + 1.0 + 1.0)
    g = Y.gaps(rows, 0.5, 10.0)
    assert g == [(2.0, 3.0), (4.0, 9.0)]
    assert Y.union_s(rows, 0.5, 10.0) + sum(b - a for a, b in g) == pytest.approx(9.5)
    assert Y.gaps([], 0.0, 2.0) == [(0.0, 2.0)] and Y.gaps([(5.0, 6.0)], 0.0, 2.0) == [(0.0, 2.0)]


def _run(**kw):
    base = dict(cfg={"env": {}, "route": "sparse"}, t0=10.0, t1=12.0, paused_s=0.0,
                updates=[], spans=[], counters={}, slices=[], shapes={})
    base.update(kw)
    return harness.Run(**base)


def test_end_to_end_rates_and_tails_take_every_update_of_the_window():
    # 300 updates, t in (10, 13]; screen -> update is take -> update + 60 ms
    ups = [(10.0 + 0.01 * i, 0, float(i % 50), {}, 60.0 + i % 50, 60.0) for i in range(1, 301)]
    ctx = {"traffic": {"feed": "live"}, "updates": ups}
    out = harness._end_to_end(ctx, {"t0": 10.0, "t1": 12.0}, 5.0)
    lat = [u[2] for u in ups if 10.0 < u[0] <= 12.0]
    assert len(lat) == 200
    assert out["update_p50_ms"] == Y.quantile(lat, 0.5) and out["update_p95_ms"] == Y.quantile(lat, 0.95)
    assert out["live_fps"] == pytest.approx(100.0)
    assert out["screen_to_update_ms"] == 60.0 + Y.quantile(lat, 0.5)
    assert set(out) == {"live_fps", "update_p50_ms", "update_p95_ms", "screen_to_update_ms", "setup_s"}
    run = _run(updates=[u for u in ups if 10.0 < u[0] <= 12.0])
    assert readers.latency_ms(run, 0.95) == Y.quantile(lat, 0.95) and readers.latency_ms(_run(), 0.95) is None
    assert harness.reader("update_p95_ms.live")(run) == Y.quantile(lat, 0.95)
    assert harness.reader("update_p50_ms.live")(run) == Y.quantile(lat, 0.5)
    assert out["setup_s"] == 5.0
    # the card's time a frame: every row of the slices, overlaps counted whole, over the frames of their batches
    one = [("Memcpy HtoD", 0.100, 0.102, "copy"), ("fused_mask_kernel", 0.101, 0.104, "kernel"),
           ("hostpack_kernel", 0.104, 0.105, "kernel")]
    two = [("hostpack_kernel", 2.500, 2.501, "kernel"), ("hostpack_kernel", 2.600, 2.601, "kernel")]
    slices = [{"lo": 0.0, "hi": 1.0, "rows": one}, {"lo": 2.0, "hi": 3.0, "rows": two}]
    counters = {"frames_out": 480, "batch": 8}
    vid = harness._end_to_end({"traffic": {"feed": "video"}, "counters": counters},
                              {"t0": 0.0, "t1": 4.0, "slices": slices}, 1.0)
    assert vid["video_fps"] == 120.0 and vid["video_device_us_per_frame"] == pytest.approx(1e6 * 0.008 / 24)
    assert "video_device_us_per_frame" not in harness._end_to_end(
        {"traffic": {"feed": "video"}, "counters": counters}, {"t0": 0.0, "t1": 4.0, "slices": []}, 1.0)
    # the traced run's rate leaves out the seconds the profiler held the program
    assert harness.reader("frames_per_s.video")(_run(t0=0.0, t1=5.0, paused_s=1.0, counters={"frames_out": 480})) \
        == 120.0
    assert harness.reader("frames_per_s.video")(_run(counters={"frames_out": 0})) is None


def test_screen_to_update_takes_every_stamped_update_of_the_window_and_nothing_else():
    """The median and 95th percentile of screen -> update, and the mean
    screen -> take, count each update of the window whose frame carries the
    source's stamp: none before the window or after it, and no unstamped
    frame, whose update still counts in the rate and in take -> update."""
    stamped = [(10.0 + 0.01 * i, i % 12, 5.0, (0.0, 0.0, 0.0), 70.0 + i, 65.0 + i % 3) for i in range(1, 101)]
    outside = [(9.5, 0, 5.0, (0.0, 0.0, 0.0), 1e6, 1e6), (12.5, 0, 5.0, (0.0, 0.0, 0.0), 1e6, 1e6)]
    unstamped = [(11.5, 0, 5.0, (0.0, 0.0, 0.0), None, None)]
    ups = stamped + outside + unstamped
    out = harness._end_to_end({"traffic": {"feed": "live"}, "updates": ups}, {"t0": 10.0, "t1": 12.0}, 1.0)
    waits = [70.0 + i for i in range(1, 101)]
    assert out["screen_to_update_ms"] == Y.quantile(waits, 0.5) == 120.0
    assert out["live_fps"] == pytest.approx(101 / 2.0)
    run = _run(updates=[u for u in ups if 10.0 < u[0] <= 12.0])
    assert len(run.updates) == 101
    assert harness.reader("screen_to_update_p95_ms.live")(run) == Y.quantile(waits, 0.95) == 165.0
    ages = [65.0 + i % 3 for i in range(1, 101)]
    assert harness.reader("screen_age_at_take_ms.live")(run) == pytest.approx(sum(ages) / len(ages))
    none = _run(updates=unstamped)
    assert harness.reader("screen_to_update_p95_ms.live")(none) is None
    assert harness.reader("screen_age_at_take_ms.live")(none) is None
    assert "screen_to_update_ms" not in harness._end_to_end({"traffic": {"feed": "live"}, "updates": unstamped},
                                                            {"t0": 10.0, "t1": 12.0}, 1.0)


def test_stage_and_span_means():
    run = _run(updates=[(11.0, 0, 1.0, (0.001, 0.0, 0.004)), (11.5, 1, 1.0, (0.003, 0.0, 0.0))],
               spans=[("submit", 10.5, 10.502), ("submit", 11.0, 11.004), ("submit", 9.0, 9.5), ("consume", 10.6, 11.0)])
    assert readers.stage_ms(run, "ocr") == pytest.approx(2.0)
    assert readers.stage_ms(run, "crop_to_map") == pytest.approx(2.0)
    assert readers.span_ms(run, "submit") == pytest.approx(3.0)  # the span begun before t0 is not the window's
    assert readers.span_ms(run, "batch_pack") is None and readers.stage_ms(_run(), "ocr") is None


def _slice(rows, lo=0.0, hi=1.0):
    return {"lo": lo, "hi": hi, "rows": rows}


def test_kernel_time_idle_share_and_roofline_of_slices():
    g = C.map_geometry(1920, 1080)
    shapes = Y.shapes(g, {"nz": 400, "win": (300, 500), "band": 20})
    rows = [("classify_luma_kernel", 0.10, 0.10 + 4e-6, "kernel"), ("hostpack_kernel", 0.20, 0.20 + 4e-6, "kernel"),
            ("Memcpy HtoD (Pinned -> Device)", 0.30, 0.30 + 10e-6, "copy"),
            ("classify_luma_kernel", 0.60, 0.60 + 4e-6, "kernel"), ("hostpack_kernel", 0.70, 0.70 + 4e-6, "kernel"),
            ("mystery_kernel", 0.80, 0.80 + 2e-6, "kernel")]
    run = _run(slices=[_slice(rows)], shapes=shapes)
    assert readers.kernel_us_per_frame(run) == pytest.approx(18.0 / 2)
    assert readers.device_idle_pct(run) == pytest.approx(100.0 * (1 - 28e-6))
    least = 2 * Y.bound_s(Y.kernel_bytes("classify_luma", shapes, "sparse")) + \
        2 * Y.bound_s(Y.kernel_bytes("hostpack", shapes, "sparse"))
    assert readers.pass_roofline(run) == pytest.approx(100.0 * least / 18e-6)
    assert 0 < readers.pass_roofline(run) < 100
    assert readers.kernel_us_per_frame(_run()) is None and readers.device_idle_pct(_run()) is None
    assert readers.pass_roofline(_run()) is None
    batch = _run(slices=[_slice(rows)], shapes=shapes, counters={"batch": 8})
    assert readers.kernel_us_per_frame(batch) == pytest.approx(18.0 / 16)


def test_kernel_bytes_count_each_byte_once():
    g = C.map_geometry(1920, 1080)
    s = Y.shapes(g, {"nz": 400, "win": (300, 500), "band": 20})
    px, bits = 822 * 986, 822 * ((986 + 7) // 8)
    assert Y.kernel_bytes("classify_luma", s, "sparse") == 5 * px
    assert Y.kernel_bytes("fused_mask", s, "sparse") == 3 * px + bits
    assert Y.kernel_bytes("quiet_walk", s, "sparse") == 3 * px + 16
    assert Y.kernel_bytes("brq_preprocess", s, "sparse") == 7 * 411 * 493 + 411 * 62 + 16
    assert Y.kernel_bytes("mask_words", s, "sparse") == bits + 4 * (7 + 800)
    assert Y.kernel_bytes("classify_luma", s, "sparse", b=8) == 8 * 5 * px
    assert Y.kernel_bytes("delta_apply", s, "sparse", b=8) == 9 * s["flat"]
    assert Y.kernel_bytes("ocr_band", s, "window-gray") > Y.kernel_bytes("ocr_band", {**s, "band": 0}, "window-gray")
    assert Y.kernel_bytes("no_such", s, "sparse") is None


def test_breakdown_labels_each_gap_by_the_span_covering_most_of_it():
    rows = [("a_kernel", 0.1, 0.2, "kernel"), ("b_kernel", 0.5, 0.55, "kernel")]
    spans = [("submit", 0.0, 0.15), ("consume", 0.2, 0.45), ("submit", 0.45, 0.6)]
    out = harness.breakdown([_slice(rows)], spans)
    assert out["device_ops"][0][0] == "a_kernel" and out["device_ops"][0][1] == pytest.approx(0.1)
    labels = {round(s, 6): k for k, s in out["idle_gaps"]}
    assert labels[0.45] == "submit"  # the last gap, covered by a submit span for 0.05 s of its 0.45
    assert labels[0.3] == "consume" and labels[0.1] == "submit"
    assert len(out["idle_gaps"]) == 3 and len(out["device_ops"]) == 2
