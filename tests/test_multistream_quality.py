"""Multi-stream parity with the single-stream engine (VERDICT r1 item 6).

Each stream of MultiStreamEngine is a full InterpolationEngine: its own
quality controller, stats, scene state, and telemetry -- the analog of K
independent instances of the reference filter's priv state.  When one
stream goes over budget, ONLY that stream degrades.
"""

import dataclasses as dc

import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.pipeline.cadence import InterpolationState
from mpv_frame_interpolator.pipeline.engine import EngineConfig
from mpv_frame_interpolator.parallel.streams import MultiStreamEngine


def sources(small_cfg, n_streams, n_frames, fps=None):
    cfgs = [dc.replace(small_cfg, seed=small_cfg.seed + k,
                       **({"fps": fps} if fps else {}))
            for k in range(n_streams)]
    return [list(synthetic.gradient_pan(c, n_frames)) for c in cfgs]


class TestPerStreamState:
    def test_per_stream_quality_controllers(self, small_cfg):
        ms = MultiStreamEngine(EngineConfig(
            scene_detection=False, auto_quality=True, measure_timing=True,
            initial_search_radius=8), n_streams=3)
        assert len({id(e.quality) for e in ms.engines}) == 3
        assert len({id(e.stats) for e in ms.engines}) == 3
        assert len({id(e.scene) for e in ms.engines}) == 3

    def test_one_stream_degrades_alone(self, small_cfg):
        """Inject an over-budget measurement into stream 1 only: its
        radius must drop / state must change while stream 0's stays."""
        ms = MultiStreamEngine(EngineConfig(
            scene_detection=False, auto_quality=True, measure_timing=True,
            initial_search_radius=8, too_slow_patience=1000), n_streams=2)
        # slow source rate = generous compute budget, so the healthy
        # stream never degrades from CI load (budget 125ms/frame vs ~6ms).
        # 8 fps, not 6: integer display/source ratios land the blend
        # accumulator exactly on the 1.0 wrap boundary where float
        # rounding (reference-exact, vf_HopperRender.c:371-374) makes the
        # per-pair output count alternate.
        srcs = sources(small_cfg, 2, 6, fps=8.0)
        for step in range(3):
            ms.push_batch([srcs[0][step], srcs[1][step]])
        r0 = ms.engines[0].quality.search_radius
        r1 = ms.engines[1].quality.search_radius
        # stream 1 "measures" way over budget on every pair
        for step in range(3, 6):
            ms.engines[1]._last_calc_duration = 10.0
            ms.push_batch([srcs[0][step], srcs[1][step]])
        assert ms.engines[1].quality.search_radius <= max(r1 - 3, 5)
        # stream 0 is still at (or above) its previous radius
        assert ms.engines[0].quality.search_radius >= r0
        assert ms.engines[0].cadence.state == InterpolationState.ACTIVE

    def test_too_slow_isolated(self, small_cfg):
        """A stream that stays over budget at minimum radius goes TooSlow;
        the others keep interpolating."""
        ms = MultiStreamEngine(EngineConfig(
            scene_detection=False, auto_quality=True, measure_timing=True,
            initial_search_radius=5, too_slow_patience=1), n_streams=2)
        srcs = sources(small_cfg, 2, 10, fps=8.0)
        for step in range(2):
            ms.push_batch([srcs[0][step], srcs[1][step]])
        for step in range(2, 9):
            ms.engines[1]._last_calc_duration = 10.0   # persistent overload
            outs = ms.push_batch([srcs[0][step], srcs[1][step]])
        assert ms.engines[1].cadence.state == InterpolationState.TOO_SLOW
        assert ms.engines[0].cadence.state == InterpolationState.ACTIVE
        # TooSlow stream passes sources through; healthy stream interpolates
        assert len(outs[1]) == 1
        assert len(outs[0]) >= 2

    def test_per_stream_stats_and_scene(self, small_cfg):
        ms = MultiStreamEngine(EngineConfig(
            scene_detection=True, auto_quality=False, measure_timing=True),
            n_streams=2)
        srcs = sources(small_cfg, 2, 4)
        for step in range(4):
            ms.push_batch([srcs[0][step], srcs[1][step]])
        for e in ms.engines:
            assert e.stats.last("source_frame_time") > 0
        # telemetry surface works per stream
        assert ms.stats(0) is not ms.stats(1)

    def test_batched_radius_vector(self, small_cfg):
        """batch_dispatch carries per-stream radii: streams at different
        radii produce their own quality outputs in one dispatch."""
        import numpy as np
        from mpv_frame_interpolator.pipeline.engine import (
            InterpolationEngine)
        kw = dict(scene_detection=False, auto_quality=False,
                  measure_timing=False)
        srcs = sources(small_cfg, 2, 3)
        ms = MultiStreamEngine(EngineConfig(**kw, initial_search_radius=5),
                               n_streams=2, batch_dispatch=True)
        ms.engines[1].quality.search_radius = 11
        got = [[] for _ in range(2)]
        for step in range(3):
            outs = ms.push_batch([srcs[0][step], srcs[1][step]])
            for k, fr in outs.items():
                got[k].extend(fr)
        # reference: independent single engines at those radii
        for k, radius in ((0, 5), (1, 11)):
            eng = InterpolationEngine(EngineConfig(
                **kw, initial_search_radius=radius))
            expect = []
            for f in srcs[k][:3]:
                expect.extend(eng.push(f))
            assert len(expect) == len(got[k])
            for a, b in zip(expect, got[k]):
                va, vb = a.to_video_frame(), b.to_video_frame()
                np.testing.assert_array_equal(va.y, vb.y)
