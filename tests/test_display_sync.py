"""Display-sync: repeat scheduling + vsync-rate estimation (VERDICT r1
item 8; reference: player/video.c:810-944, video/out/vo.c:416-530).

A fake injectable clock makes the vblank behavior deterministic and
real-time-free.
"""

import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator.pipeline.player import Pipeline
from mpv_frame_interpolator.pipeline.present import PresentClock


class FakeTime:
    """perf_counter/sleep pair where sleep is exact (zero jitter)."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def sleep(self, d):
        self.t += max(d, 0.0)


class TestRepeatSchedule:
    def test_24_on_60_pulldown(self):
        """24 fps content on a 60 Hz grid: the 3:2 pulldown cadence, via
        the accumulated sub-vsync error (not a constant round(2.5)=2)."""
        pc = PresentClock(60.0, clock=FakeTime())
        infos = [pc.present(i / 24.0) for i in range(12)]
        nums = [i.num_vsyncs for i in infos[1:]]
        assert sorted(set(nums)) == [2, 3]
        # the accumulated error keeps the average pinned at 2.5 vsyncs per
        # frame (a constant round(2.5) would drift at 2.0); float noise in
        # the pts stream may perturb a single step but never three in a row
        assert sum(nums) / len(nums) == pytest.approx(2.5, abs=0.1)
        for a, b, c in zip(nums, nums[1:], nums[2:]):
            assert not (a == b == c)
        # slots advance by the previous frame's repeat count
        slots = [i.vsync_index for i in infos]
        for k in range(1, len(infos)):
            assert slots[k] - slots[k - 1] == infos[k].num_vsyncs

    def test_display_rate_content_single_vsync(self):
        pc = PresentClock(60.0, clock=FakeTime())
        infos = [pc.present(i / 60.0) for i in range(30)]
        assert all(i.num_vsyncs == 1 for i in infos[1:])
        assert [i.vsync_index for i in infos] == list(range(30))

    def test_next_frame_never_inside_repeats(self):
        """Even if pts mapping suggests an earlier vblank, the next frame
        waits out the previous frame's repeats."""
        pc = PresentClock(60.0, clock=FakeTime())
        pc.present(0.0)
        a = pc.present(3 / 60.0)        # 3-vsync frame
        b = pc.present(3.2 / 60.0)      # nominally 0.2 vsyncs later
        assert b.vsync_index >= a.vsync_index + b.num_vsyncs


class TestRefreshEstimation:
    def test_estimate_is_vsync_rate_not_frame_rate(self):
        """24 fps bypass content on 60 Hz: the flip intervals are 2-3
        vsyncs, but the estimate must still be ~60, not ~24 (the r1 bug)."""
        pc = PresentClock(60.0, clock=FakeTime())
        for i in range(64):
            pc.present(i / 24.0)
        assert pc.estimated_display_fps() == pytest.approx(60.0, rel=0.01)
        assert pc.vsync_jitter() < 1e-9      # exact fake sleeps

    def test_estimate_tracks_actual_panel_rate(self):
        """Panel really runs 59.94 while the mode says 60: the estimate
        converges on the true vblank rate."""
        pc = PresentClock(60.0, actual_fps=59.94, clock=FakeTime())
        for i in range(64):
            pc.present(i / 60.0)
        assert pc.estimated_display_fps() == pytest.approx(59.94, rel=1e-3)


class TestPipelineRetarget:
    def test_cadence_retargets_to_measured_refresh(self, small_cfg):
        """End-to-end display-sync adaptation: a 59.94 Hz panel driven
        with a nominal 60 retargets the cadence to the measured rate
        (vo.c:416 check_estimated_display_fps analog)."""
        frames = list(synthetic.moving_box(small_cfg, 60))
        engine = InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False,
            measure_timing=False))
        pc = PresentClock(60.0, actual_fps=59.94, clock=FakeTime())

        class Sink:
            def write(self, out):
                pass

            def close(self):
                pass

        pipe = Pipeline(iter(frames), engine, Sink(), present=pc,
                        stage_uploads=False)
        pipe.drop_late_sources = False
        pipe.run()
        assert pc.presented >= 128
        assert engine.cadence.target_frame_time == pytest.approx(
            1.0 / 59.94, rel=1e-3)
