"""Framedrop recovery: output pts sequence across a dropped source frame.

The playloop's decoder-level framedrop (player.py drop_late_sources,
check_framedrop analog player/video.c:315-332) sheds a source frame before
the engine sees it, so the next pair spans a 2x source pts gap.  These
tests pin what the cadence engine does with that gap:

* at 24 fps the 41.7 ms gap stays under the 50 ms drift limit
  (vf_HopperRender.c:470), so the output timeline continues smoothly;
* at lower source rates the gap exceeds the limit and the documented
  "inconsistent timings" re-anchor fires (vf_HopperRender.c:468-477).
"""

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.pipeline.cadence import CadenceEngine
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator.pipeline.player import Pipeline
from mpv_frame_interpolator.pipeline.present import PresentInfo


def collect_pts(cad, pts_seq, fps):
    out = []
    for pts in pts_seq:
        plan = cad.on_source_frame(pts, fps)
        if plan.passthrough:
            out.append((pts, plan.inconsistent_detected))
        else:
            out.extend((s.pts, plan.inconsistent_detected)
                       for s in plan.outputs)
    return out


class TestCadenceAcrossDrop:
    def test_24fps_drop_stays_consistent(self):
        """A single dropped frame at 24->60 keeps the timeline smooth: the
        gap (41.7ms) is under the drift limit, no re-anchor happens, and
        output pts stay strictly monotone on the target grid."""
        cad = CadenceEngine(display_fps=60.0)
        src = [i / 24.0 for i in range(10)]
        del src[5]                       # the dropped source frame
        out = collect_pts(cad, src, 24.0)
        assert not any(inc for _, inc in out)
        pts = [p for p, _ in out]
        diffs = np.diff(pts)
        # strictly monotone; every step is one target frame time (the drop
        # does not compress or duplicate output slots)
        assert (diffs > 0).all()
        np.testing.assert_allclose(diffs[2:], 1.0 / 60.0, atol=1e-9)

    def test_low_fps_drop_triggers_drift_reanchor(self):
        """At 16 fps source the post-drop gap is 125 ms > 50 ms: the
        inconsistent-timings fallback must fire and re-anchor output pts to
        the source pts (vf_HopperRender.c:468-477)."""
        cad = CadenceEngine(display_fps=60.0)
        src = [i / 16.0 for i in range(10)]
        del src[5]
        out = collect_pts(cad, src, 16.0)
        assert any(inc for _, inc in out)
        pts = [p for p, _ in out]
        assert (np.diff(pts) > 0).all()
        # after the re-anchor the timeline continues from the source pts
        assert cad.inconsistent_timings

    def test_num_int_frames_stable_across_drop(self):
        """The per-pair output count depends on blend phase + rate ratio
        only; a drop must not make it explode."""
        cad = CadenceEngine(display_fps=60.0)
        src = [i / 24.0 for i in range(12)]
        del src[6]
        counts = []
        for pts in src:
            plan = cad.on_source_frame(pts, 24.0)
            if not plan.passthrough:
                counts.append(len(plan.outputs))
        assert max(counts) <= 4          # 24->60 emits 2..3 per source


class _AlwaysLateClock:
    """Present clock whose feedback always reports a late frame, forcing
    the pipeline's framedrop path."""

    untimed = False
    display_fps = 60.0
    vsync_interval = 1.0 / 60.0

    def __init__(self):
        self.presented = 0

    def present(self, pts):
        self.presented += 1
        return PresentInfo(self.presented, 1, 0.0, 0.005, False)

    def reset(self):
        pass

    def estimated_display_fps(self):
        return self.display_fps

    def vsync_jitter(self):
        return 0.0


class _ListSink:
    def __init__(self):
        self.pts = []

    def write(self, out):
        self.pts.append(out.pts)

    def close(self):
        pass


class TestPipelineDropPath:
    def test_drop_then_monotone_output(self, small_cfg):
        frames = list(synthetic.moving_box(small_cfg, 16))
        engine = InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False, measure_timing=False))
        sink = _ListSink()
        pipe = Pipeline(iter(frames), engine, sink,
                        present=_AlwaysLateClock(), stage_uploads=False,
                        adapt_display_rate=False)
        pipe.run()
        assert pipe.sources_dropped >= 1
        # the engine kept interpolating across the drop and pts stayed
        # strictly monotone
        assert pipe.frames_out > pipe.frames_in - pipe.sources_dropped
        assert (np.diff(sink.pts) > 0).all()
