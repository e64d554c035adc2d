"""A run with the timed path broken underneath comes out not correct.

These drive the whole run but the look for a card (`harness.run` on the
CPU, where every kernel runs its plain PyTorch twin), at 1920x1080 and with
a short warm-up so a test run holds them: a sound run is correct; the
control (`stale`: each frame served the previous frame's answer) and each
fault a cell can have (`frozen`: the state returned unchanged; `stale_ratio`:
the frame's ratio left as the frame before's; `half`: half of the answers or
of each batch left out; `altered`: an answer altered where it is produced)
are not. No cell spans chips, so there is no
exchange between chips to leave out."""

import pytest

from smhbench import harness

SEED = 2**31 + 4242
SCREEN = (1920, 1080)
LIVE = ["smhocr-4k.drag", "grayband-1080p.pan"]


def run(workload: str, fault=None) -> dict:
    video = workload.endswith(".video")
    return harness.run(workload, SEED, 4.0 if video else 2.0, False, device="cpu", fault=fault, screen=SCREEN,
                       warm=1 if video else 4, ref_workers=2)


@pytest.mark.parametrize("workload", LIVE + ["smhocr-4k.video"])
def test_a_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["_numbers"]["compared"] > 0 and out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", LIVE + ["smhocr-4k.video"])
def test_the_control_is_not_correct(workload):
    out = run(workload, "stale")
    assert not out["correct"]
    assert out["checks"]["marker_gap_px"]["value"] > out["checks"]["marker_gap_px"]["limit"]


@pytest.mark.parametrize("fault", ["frozen", "half", "altered"])
@pytest.mark.parametrize("workload", ["grayband-1080p.pan", "smhocr-4k.video"])
def test_each_fault_is_not_correct(workload, fault):
    out = run(workload, fault)
    assert not out["correct"], (fault, out["checks"])


def test_a_stale_ratio_is_not_correct_on_the_pan():
    """The pan's scale label and bar change every frame, so a ratio served
    from the frame before (a scales read skipped, a band left unchanged)
    reads a gap while the markers and the minimap are the frame's own."""
    out = run("grayband-1080p.pan", "stale_ratio")
    assert not out["correct"]
    c = out["checks"]
    assert c["ratio_gap"]["value"] > c["ratio_gap"]["limit"]
    assert c["marker_gap_px"]["value"] <= c["marker_gap_px"]["limit"]


def test_an_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        harness.Fault("no-such-fault")


@pytest.mark.parametrize("workload", ["grayband-1080p.pan", "smhocr-4k.video"])
def test_a_traced_run_holds_the_program_quiet_around_each_slice(workload, monkeypatch):
    """The profiler starts and stops only while every offered frame is
    answered; the run goes on correct after, and its rates leave the held
    time out."""
    import time

    seen = []

    def fake_take(seconds, launches, clock, pause, resume):
        resume()
        lo = clock()
        time.sleep(seconds)
        pause()
        seen.append((lo, clock()))
        resume()
        return {"lo": lo, "hi": seen[-1][1], "rows": []}

    monkeypatch.setattr(harness.P, "take", fake_take)
    video = workload.endswith(".video")
    out = harness.run(workload, SEED, 8.0 if video else 6.0, True, device="cpu", screen=SCREEN,
                      warm=1 if video else 4, ref_workers=2)
    assert out["correct"], out["checks"]
    assert len(seen) == harness.SLICES
    if not video:
        assert out["metrics"]["update_p95_ms.live"]["value"] > 0
    else:
        assert out["metrics"]["frames_per_s.video"]["value"] > 0
