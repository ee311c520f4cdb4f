"""Checkpoint/resume: a preempted render resumes bit-identically.

The counter-based RNG keys every draw by (pixel, sample, bounce), so an
interrupted 8-pass render restored from a 4-pass checkpoint must produce the
same accumulation buffer as an uninterrupted run — the determinism the
reference's wall-clock-seeded RNG cannot offer (SURVEY §4.5).
"""

import numpy as np

from vrenderer_pathtracer import Renderer, RenderSettings
from vrenderer_pathtracer.render.progressive import (
    ProgressiveScheduler,
    restore_checkpoint,
    save_checkpoint,
)

SETTINGS = RenderSettings(
    use_cornell_box=True, has_hdr=False, samples_per_pass=2, bounces=2
)


def test_checkpoint_resume_bitwise(tmp_path):
    straight = Renderer(32, 32, settings=SETTINGS)
    for _ in range(8):
        img_straight, _ = straight.render()

    part = Renderer(32, 32, settings=SETTINGS)
    for _ in range(4):
        part.render()
    save_checkpoint(part, tmp_path / "ckpt")

    resumed = Renderer(32, 32, settings=SETTINGS)
    restore_checkpoint(resumed, tmp_path / "ckpt")
    assert resumed.frame == part.frame
    for _ in range(4):
        img_resumed, _ = resumed.render()

    np.testing.assert_array_equal(
        np.asarray(img_resumed), np.asarray(img_straight)
    )


def test_restored_at_target_does_not_advance(tmp_path):
    """A checkpoint already at target_spp must display the existing
    accumulation, not append another pass (round-1 advisor finding)."""
    r = Renderer(16, 16, settings=SETTINGS)
    for _ in range(4):  # spp = 8 = target
        r.render()
    save_checkpoint(r, tmp_path / "ckpt")

    r2 = Renderer(16, 16, settings=SETTINGS)
    sched = ProgressiveScheduler(r2, target_spp=8, checkpoint_dir=None)
    restore_checkpoint(r2, tmp_path / "ckpt")
    frame_before = r2.frame
    accum_before = np.asarray(r2._accum).copy()
    img, depth = sched.run()
    assert r2.frame == frame_before
    np.testing.assert_array_equal(np.asarray(r2._accum), accum_before)
    # Displayed image equals the live renderer's last tonemapped state.
    live_img, live_depth = r.current_frame()
    np.testing.assert_array_equal(img, np.asarray(live_img))
    np.testing.assert_array_equal(depth, np.asarray(live_depth))


def test_scheduler_reaches_target(tmp_path):
    r = Renderer(16, 16, settings=SETTINGS)
    seen = []
    sched = ProgressiveScheduler(
        r, target_spp=8, checkpoint_dir=str(tmp_path), checkpoint_every=2,
        on_pass=lambda i, spp: seen.append(spp),
    )
    img, depth = sched.run()
    assert r.samples_per_pixel >= 8
    assert seen == [2, 4, 6, 8]
    assert np.isfinite(img).all()

    # A new scheduler resumes from the checkpoint instead of restarting.
    r2 = Renderer(16, 16, settings=SETTINGS)
    sched2 = ProgressiveScheduler(r2, target_spp=8, checkpoint_dir=str(tmp_path))
    assert sched2.resume_if_possible()
    assert r2.samples_per_pixel >= 6  # checkpoint was at pass 8 (spp 8)


def test_corrupt_checkpoint_recovers_fresh(tmp_path):
    """Failure recovery (SURVEY §5.3): a half-written/corrupt checkpoint is
    survived — resume logs the failure and starts fresh instead of
    crashing the job."""
    import json
    import pathlib

    r = Renderer(16, 16, settings=SETTINGS)
    r.render()
    sched = ProgressiveScheduler(
        r, target_spp=8, checkpoint_dir=str(tmp_path),
        checkpoint_every=1, metrics_path=str(tmp_path / "metrics.jsonl"),
    )
    sched.run()
    # Corrupt every data file in the checkpoint.
    latest = tmp_path / "latest"
    assert latest.exists()
    for f in pathlib.Path(latest).rglob("*"):
        if f.is_file():
            f.write_bytes(b"corrupt" * 16)
    r2 = Renderer(16, 16, settings=SETTINGS)
    sched2 = ProgressiveScheduler(
        r2, target_spp=8, checkpoint_dir=str(tmp_path),
        metrics_path=str(tmp_path / "metrics.jsonl"),
    )
    assert not sched2.resume_if_possible()  # no crash, fresh start
    img, _ = sched2.run()  # completes from scratch
    assert r2.samples_per_pixel >= 8
    events = [json.loads(line)["event"]
              for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert "resume_failed" in events
    assert events.count("done") == 2


def test_metrics_jsonl_records_passes(tmp_path):
    import json

    r = Renderer(16, 16, settings=SETTINGS)
    sched = ProgressiveScheduler(
        r, target_spp=6, metrics_path=str(tmp_path / "m.jsonl"))
    sched.run()
    recs = [json.loads(line)
            for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    passes = [x for x in recs if x["event"] == "pass"]
    assert len(passes) == 3  # 6 spp / 2 per pass
    assert passes[-1]["spp"] == 6
    assert all(x["ms"] > 0 and x["mrays_per_s"] > 0 for x in passes)  # 5-digit precision survives compile-dominated first passes
    assert recs[-1]["event"] == "done"
