"""Honest flow/warp split telemetry (VERDICT r1 weak-1 / next-3).

The reference times flow and warp separately with CL profiling events
(opticalFlowCalc.c:111-122,192-201).  The rebuild's fused dispatch has no
internal boundary, so split numbers come from dedicated flow/warp programs:
measured per-frame in split_timing="always" (reference-authentic two
dispatches), or calibrated once per (radius, batch, mode, model) spec in
"auto" when a telemetry consumer asks.  The fabricated 40/60 split is gone.
"""

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)


def run_engine(cfg, frames):
    eng = InterpolationEngine(cfg)
    outs = []
    for f in frames:
        outs.extend(eng.push(f))
    return eng, outs


@pytest.fixture(scope="module")
def frames(small_cfg):
    return list(synthetic.moving_box(small_cfg, 5))


class TestAlwaysMode:
    def test_outputs_bit_exact_vs_fused(self, frames):
        base = dict(scene_detection=True, auto_quality=False,
                    measure_timing=True, background_precompile=False)
        _, fused = run_engine(EngineConfig(**base, split_timing="off"),
                              frames)
        _, split = run_engine(EngineConfig(**base, split_timing="always"),
                              frames)
        assert len(fused) == len(split)
        for a, b in zip(fused, split):
            ya, uva = a.device_planes()
            yb, uvb = b.device_planes()
            np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
            np.testing.assert_array_equal(np.asarray(uva), np.asarray(uvb))

    def test_split_times_are_real_measurements(self, frames):
        eng, _ = run_engine(EngineConfig(
            scene_detection=False, auto_quality=False, measure_timing=True,
            background_precompile=False,
            split_timing="always"), frames)
        flow = eng.stats.last("flow_time")
        warp = eng.stats.last("warp_total")
        total = eng.stats.last("source_frame_time")
        assert flow > 0 and warp > 0
        # the stage times ARE the measured total (same sync points), so
        # they must sum to it -- not to an invented 40/60 of it
        assert total == pytest.approx(flow + warp, rel=1e-6)


class TestAutoMode:
    def test_no_split_cost_until_requested(self, frames):
        eng, _ = run_engine(EngineConfig(
            scene_detection=False, auto_quality=False, measure_timing=True,
            background_precompile=False,
            split_timing="auto"), frames)
        assert eng.stats.last("flow_time") == 0.0
        assert not eng._split_cache

    def test_calibrates_once_per_spec_after_request(self, frames, small_cfg):
        eng = InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False, measure_timing=True,
            background_precompile=False,
            split_timing="auto"))
        eng.request_split_timing()
        for f in frames:
            eng.push(f)
        assert eng.stats.last("flow_time") > 0
        assert eng.stats.last("warp_time") > 0
        # 24->60 alternates batch sizes 2/3: one calibration per spec
        specs = set(eng._split_cache)
        assert 1 <= len(specs) <= 3
        n_before = len(specs)
        for f in synthetic.moving_box(small_cfg, 4):
            eng.push(f.with_pts(f.pts + 10.0))
        assert len(eng._split_cache) == n_before   # no re-calibration

    def test_radius_change_recalibrates(self, frames):
        eng = InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False, measure_timing=True,
            background_precompile=False,
            split_timing="auto"))
        eng.request_split_timing()
        for f in frames:
            eng.push(f)
        n_before = len(eng._split_cache)
        eng.quality.search_radius = 11
        for f in frames:
            eng.push(f.with_pts(f.pts + 100.0))
        assert len(eng._split_cache) > n_before
        assert any(spec[0] == 11 for spec in eng._split_cache)

    def test_property_read_enables_split(self, frames):
        from mpv_frame_interpolator.api import Player
        eng = InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False, measure_timing=True,
            background_precompile=False,
            split_timing="auto"))
        p = Player(engine=eng)
        assert p.get_property("ofc-time") == 0.0   # enables measurement
        for f in frames:
            eng.push(f)
        assert p.get_property("ofc-time") > 0
        assert p.get_property("warp-time") > 0
