"""Cadence engine semantics (vf_HopperRender.c:425-501, 541-567)."""

import math

import pytest

from mpv_frame_interpolator.pipeline.cadence import (
    CadenceEngine, InterpolationState)


def feed(eng, n, fps=24.0, start=0.0, speed_changes=None):
    plans = []
    for i in range(n):
        if speed_changes and i in speed_changes:
            eng.set_speed(speed_changes[i])
        plans.append(eng.on_source_frame(start + i / fps, fps))
    return plans


class TestCadence24to60:
    def test_first_frame_passthrough(self):
        eng = CadenceEngine(60.0)
        p = eng.on_source_frame(0.0, 24.0)
        assert p.passthrough and not p.compute_flow

    def test_3_2_pattern(self):
        eng = CadenceEngine(60.0)
        plans = feed(eng, 6)
        counts = [len(p.outputs) for p in plans]
        assert counts == [0, 3, 2, 3, 2, 3]
        # 1 passthrough + 13 warps = 14 outputs for 6 sources ~ 60/24 ratio

    def test_blend_values(self):
        eng = CadenceEngine(60.0)
        plans = feed(eng, 3)
        blends = [s.blend for p in plans for s in p.outputs]
        assert blends == pytest.approx([0.0, 0.4, 0.8, 0.2, 0.6], abs=1e-9)

    def test_pts_progression(self):
        eng = CadenceEngine(60.0)
        plans = feed(eng, 4)
        pts = [s.pts for p in plans for s in p.outputs]
        # anchored at frame 2's container pts (1/24), stepping by 1/60
        expect = [1 / 24 + k / 60 for k in range(len(pts))]
        assert pts == pytest.approx(expect, abs=1e-9)
        # within drift tolerance, container pts never re-anchors
        assert not any(p.inconsistent_detected for p in plans)

    def test_blending_scalar_stays_in_range(self):
        eng = CadenceEngine(59.94)
        for i in range(500):
            eng.on_source_frame(i / 23.976, 23.976)
            assert 0.0 <= eng.blending_scalar < 1.0


class TestBypass:
    def test_high_fps_source_not_needed(self):
        eng = CadenceEngine(60.0)
        p = eng.on_source_frame(0.0, 60.0)
        assert p.passthrough
        assert eng.state == InterpolationState.NOT_NEEDED

    def test_reactivation_on_fps_drop(self):
        eng = CadenceEngine(60.0)
        eng.on_source_frame(0.0, 120.0)
        assert eng.state == InterpolationState.NOT_NEEDED
        p = eng.on_source_frame(1 / 24, 24.0)
        assert eng.state == InterpolationState.ACTIVE
        # that frame is source frame #1 (counter never advanced while
        # bypassed), so it's still a passthrough anchor
        assert p.passthrough

    def test_speed_aware_bypass(self):
        # 24 fps at 3x speed = effective 72 fps >= 60 -> NotNeeded
        eng = CadenceEngine(60.0)
        eng.set_speed(3.0)
        p = eng.on_source_frame(0.0, 24.0)
        assert p.passthrough
        assert eng.state == InterpolationState.NOT_NEEDED

    def test_too_slow_bypasses_until_command(self):
        eng = CadenceEngine(60.0)
        feed(eng, 3)
        eng.mark_too_slow()
        p = eng.on_source_frame(3 / 24, 24.0)
        assert p.passthrough
        eng.set_speed(1.0)  # any command reactivates (vf:551-554)
        assert eng.state == InterpolationState.ACTIVE


class TestResync:
    def test_speed_change_reanchors_pts(self):
        eng = CadenceEngine(60.0)
        feed(eng, 4)
        eng.set_speed(0.5)
        p = eng.on_source_frame(4 / 24, 24.0)
        assert p.outputs[0].pts == pytest.approx(4 / 24)

    def test_speed_changes_intermediate_step(self):
        eng = CadenceEngine(60.0)
        feed(eng, 2)
        eng.set_speed(0.5)  # slower playback: pts step = tft * speed
        p = eng.on_source_frame(2 / 24, 24.0)
        steps = [b.pts for b in p.outputs]
        for a, b in zip(steps, steps[1:]):
            assert b - a == pytest.approx((1 / 60) * 0.5)

    def test_inconsistent_timings_fallback(self):
        eng = CadenceEngine(60.0)
        feed(eng, 3)
        # jump the container pts by 1s: > 50 ms drift
        p = eng.on_source_frame(1.0 + 3 / 24, 24.0)
        assert p.inconsistent_detected
        assert p.outputs[0].pts == pytest.approx(1.0 + 3 / 24)
        assert eng.inconsistent_timings
        # once inconsistent, every frame anchors to container pts
        p2 = eng.on_source_frame(1.0 + 4 / 24, 24.0)
        assert p2.outputs[0].pts == pytest.approx(1.0 + 4 / 24)

    def test_seek_reset(self):
        eng = CadenceEngine(60.0)
        feed(eng, 5)
        eng.reset()
        assert eng.blending_scalar == 0.0
        p = eng.on_source_frame(100.0, 24.0)
        assert p.passthrough  # frame counter restarted
        p2 = eng.on_source_frame(100.0 + 1 / 24, 24.0)
        assert p2.outputs[0].pts == pytest.approx(100.0 + 1 / 24)


class TestCadenceRates:
    @pytest.mark.parametrize("src,dst", [(24, 60), (25, 60), (30, 60),
                                         (23.976, 59.94), (24, 120)])
    def test_output_rate_matches_display(self, src, dst):
        eng = CadenceEngine(dst)
        n = 200
        total = sum(len(p.outputs) for p in feed(eng, n, fps=src))
        # first frame is a passthrough; long-run output count ~ n * dst/src
        expect = (n - 1) * dst / src
        assert abs(total - expect) <= math.ceil(dst / src) + 1

    def test_vfr_source(self):
        """Variable-fps source: blending scalar must stay in [0,1) and
        output counts follow the per-frame nominal fps."""
        eng = CadenceEngine(60.0)
        pts = 0.0
        import random
        rng = random.Random(7)
        for _ in range(300):
            fps = rng.choice([12.0, 24.0, 25.0, 30.0, 48.0])
            eng.on_source_frame(pts, fps)
            pts += 1.0 / fps
            assert 0.0 <= eng.blending_scalar < 1.0
