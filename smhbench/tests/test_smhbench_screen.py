"""Screen -> update on a live run: the source's stamp is taken when the
screen is read, so for every update of the window what a player waits is at
least take -> update, and the frame's age at its take is never negative.
The benchmark's own reading of that age agrees, frame by frame, with the
program's mailbox span within the grab's time. One short run on the CPU at
1920x1080, where every kernel runs its plain PyTorch twin."""

import statistics

import pytest

from smhbench import harness, spans

SEED = 2**31 + 2323


def test_a_live_run_stamps_every_update_at_the_screen(monkeypatch):
    kept = []

    class KeptRun(harness.Run):
        def __init__(self, *args):
            super().__init__(*args)
            kept.append(self)

    monkeypatch.setattr(harness, "Run", KeptRun)
    out = harness.run("grayband-1080p.drag", SEED, 2.0, False, device="cpu", screen=(1920, 1080), warm=4,
                      ref_workers=2)
    assert out["correct"], out["checks"]
    run = kept[0]
    assert len(run.updates) > 5
    for _, _, take_to_update, _, screen_to_update, screen_to_take in run.updates:
        assert screen_to_take >= 0 and screen_to_update >= take_to_update
        assert screen_to_update == pytest.approx(screen_to_take + take_to_update)
    assert out["metrics"]["screen_to_update_ms"]["value"] > 0
    age = harness.reader("screen_age_at_take_ms.live")(run)
    mailbox = harness.reader("mailbox_wait_ms.live")(run)
    assert age is not None and mailbox is not None
    # Frame by frame, on one clock: the stamp lies inside the program's `capture.grab` span
    # (the source's call and the dedup compare), the mailbox's publish comes after that span,
    # and its take before the benchmark's. So the age at the take exceeds the mailbox wait by
    # the grab and the hand-off, which the median keeps to the grab's time.
    recs = spans.records(run, run.t0 - 5.0)
    boxes = sorted((r for r in recs if r.name == "capture.mailbox"), key=lambda r: r.end)
    grabs = sorted((r for r in recs if r.name == "capture.grab"), key=lambda r: r.start)
    over, grab_ms = [], []
    for t, _, take_to_update, _, _, screen_to_take in run.updates:
        take = t - take_to_update / 1e3
        stamp = take - screen_to_take / 1e3
        box = [r for r in boxes if r.end <= take][-1]
        grab = [r for r in grabs if r.start <= stamp][-1]
        assert grab.start <= stamp <= grab.end <= box.start < box.end <= take
        over.append(screen_to_take - 1e3 * (box.end - box.start))
        grab_ms.append(1e3 * (grab.end - grab.start))
    assert 0 < statistics.median(over) <= statistics.median(grab_ms) + 1.0, (over, grab_ms)
