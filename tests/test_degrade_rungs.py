"""Degradation ladder beyond the radius floor (VERDICT r3 next #2).

The reference's only degradation lever is the search radius, which
scales its launch grid (opticalFlowCalc.c:130, consumed by
vf_HopperRender.c:326-345).  On this rebuild the fused pair also
carries work radius does not scale -- so the controller gets two more
levers: pyramid depth and calc resolution (EngineConfig.degrade_rungs),
stepped only after radius hits the floor and unwound first on recovery.
"""

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.ops.flow import FlowGeometry
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)


def _cad():
    from mpv_frame_interpolator.pipeline.cadence import CadenceEngine
    c = CadenceEngine(60.0)
    c.on_source_frame(0.0, 24.0)
    return c


class TestControllerLadder:
    def test_steps_ladder_after_radius_floor_then_too_slow(self):
        from mpv_frame_interpolator.pipeline.quality import (
            QualityController)
        c = _cad()
        q = QualityController(search_radius=6, too_slow_patience=2,
                              max_level=2)
        slow = c.source_frame_time
        q.update(slow, c)
        assert (q.search_radius, q.level) == (5, 0)
        q.update(slow, c)
        assert (q.search_radius, q.level) == (5, 1)
        q.update(slow, c)
        assert (q.search_radius, q.level) == (5, 2)
        q.update(slow, c)               # ladder exhausted: streak 1
        assert c.state.name == "ACTIVE"
        q.update(slow, c)               # streak 2 -> TooSlow
        assert c.state.name == "TOO_SLOW"

    def test_cold_rung_is_not_entered(self):
        from mpv_frame_interpolator.pipeline.quality import (
            QualityController)
        c = _cad()
        q = QualityController(search_radius=5, too_slow_patience=99,
                              max_level=2)
        warm = {0, 2}
        q.rung_warm = lambda lvl: lvl in warm
        slow = c.source_frame_time
        q.update(slow, c)
        assert q.level == 0             # rung 1 cold: no step, streak
        warm.add(1)
        q.update(slow, c)
        assert q.level == 1

    def test_recovery_unwinds_level_before_radius(self):
        from mpv_frame_interpolator.pipeline.quality import (
            QualityController)
        c = _cad()
        q = QualityController(search_radius=5, max_level=2)
        q.level = 2
        fast = c.source_frame_time / 10
        q.update(fast, c)
        assert (q.search_radius, q.level) == (5, 1)
        q.update(fast, c)
        assert (q.search_radius, q.level) == (5, 0)
        q.update(fast, c)
        assert (q.search_radius, q.level) == (6, 0)


def _frames(n=10):
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    return list(synthetic.moving_box(cfg, n))


def _materialize(outs):
    return [(np.asarray(o.device_planes()[0]),
             np.asarray(o.device_planes()[1])) for o in outs]


class TestEngineLadder:
    def test_rung_outputs_match_static_config(self):
        """An engine degraded to rung k produces bit-identical outputs to
        an engine statically configured with that rung's geometry."""
        frames = _frames()
        base = FlowGeometry.create(64, 96, 96, 270, 0)
        rung = (1, 2)                   # one iteration down, half res
        e_dyn = InterpolationEngine(EngineConfig(
            display_fps=60.0, auto_quality=True, initial_search_radius=5,
            measure_timing=False, background_precompile=False,
            degrade_rungs=(rung,)))
        e_dyn.quality.level = 1         # controller has stepped down
        e_static = InterpolationEngine(EngineConfig(
            display_fps=60.0, auto_quality=False, initial_search_radius=5,
            measure_timing=False, background_precompile=False,
            num_iterations=max(base.iterations - rung[0], 1),
            max_calc_res=max(270 // rung[1], 64)))
        got = [o for f in frames for o in e_dyn.push(f)]
        ref = [o for f in frames for o in e_static.push(f)]
        assert len(got) == len(ref)
        for (y1, uv1), (y2, uv2) in zip(_materialize(got),
                                        _materialize(ref)):
            np.testing.assert_array_equal(y1, y2)
            np.testing.assert_array_equal(uv1, uv2)

    def test_over_budget_engine_steps_down_and_stays_active(self):
        """Sustained over-budget measurements walk radius to the floor,
        then the ladder down -- playback stays ACTIVE while rungs remain
        (the reference would already have flipped TooSlow)."""
        e = InterpolationEngine(EngineConfig(
            display_fps=60.0, auto_quality=True, initial_search_radius=6,
            measure_timing=False, background_precompile=False,
            too_slow_patience=3, degrade_rungs=((1, 1), (2, 2))))
        # 6 frames = 5 controller updates: radius 6->5, level 0->1->2,
        # then 2 over-budget frames of streak -- within patience 3
        for f in _frames(6):
            e.push(f)
            # inject an over-budget measurement for the next update
            e._last_calc_duration = e.cadence.source_frame_time
        assert e.quality.search_radius == 5
        assert e.quality.level == 2
        assert e.cadence.state.name == "ACTIVE"
        # and the recovery path unwinds once the measurements improve
        # (same continuous stream: _frames(12)[6:] continues the pts grid)
        e._last_calc_duration = e.cadence.source_frame_time / 100
        for f in _frames(12)[6:]:
            e.push(f)
            e._last_calc_duration = e.cadence.source_frame_time / 100
        assert e.quality.level == 0

    def test_push_many_honors_level(self):
        frames = _frames(9)
        e1 = InterpolationEngine(EngineConfig(
            display_fps=60.0, auto_quality=True, initial_search_radius=5,
            measure_timing=False, background_precompile=False,
            degrade_rungs=((2, 2),)))
        e1.quality.level = 1
        e2 = InterpolationEngine(EngineConfig(
            display_fps=60.0, auto_quality=True, initial_search_radius=5,
            measure_timing=False, background_precompile=False,
            degrade_rungs=((2, 2),)))
        e2.quality.level = 1
        ref = [o for f in frames for o in e1.push(f)]
        got = e2.push_many(frames, group_size=4)
        for (y1, uv1), (y2, uv2) in zip(_materialize(ref),
                                        _materialize(got)):
            np.testing.assert_array_equal(y1, y2)
            np.testing.assert_array_equal(uv1, uv2)

    def test_blend_rung_matches_blend_model(self):
        """The last-resort rung switches the interpolator family: a
        ladder-degraded engine on its blend rung produces exactly what a
        blend-configured engine produces (cross-fade at display rate --
        still better than the reference's TooSlow source-rate snap)."""
        frames = _frames()
        e_dyn = InterpolationEngine(EngineConfig(
            display_fps=60.0, auto_quality=True, initial_search_radius=5,
            measure_timing=False, background_precompile=False,
            degrade_rungs=((2, 2), (2, 2, "blend"))))
        e_dyn.quality.level = 2
        e_blend = InterpolationEngine(EngineConfig(
            display_fps=60.0, auto_quality=False, initial_search_radius=5,
            measure_timing=False, background_precompile=False,
            model="blend"))
        got = [o for f in frames for o in e_dyn.push(f)]
        ref = [o for f in frames for o in e_blend.push(f)]
        for (y1, uv1), (y2, uv2) in zip(_materialize(got),
                                        _materialize(ref)):
            np.testing.assert_array_equal(y1, y2)
            np.testing.assert_array_equal(uv1, uv2)

    def test_default_ladder_has_flow_bearing_middle_rung(self):
        """VERDICT r4 next #5: between the near-full-quality rung and
        the blend cliff there must be a deeper rung that still computes
        flow, so the controller has a real middle step."""
        rungs = EngineConfig().degrade_rungs
        assert len(rungs) >= 3
        assert rungs[-1][2] == "blend"           # last resort only
        assert all(m is None for _, _, m in rungs[:-1])
        (d1, r1, _), (d2, r2, _) = rungs[0], rungs[1]
        assert d2 >= d1 and r2 > r1              # strictly deeper

    def test_rung_validation(self):
        with pytest.raises(ValueError):
            EngineConfig(degrade_rungs=((-1, 1),))
        with pytest.raises(ValueError):
            EngineConfig(degrade_rungs=((1, 0),))
        with pytest.raises(ValueError):
            EngineConfig(degrade_rungs=((1, 1, "nope"),))
