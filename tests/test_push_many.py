"""Grouped dispatch (engine.push_many) vs the per-pair push path.

VERDICT r3 next #1: pair-grouped dispatch for transcode/serving.  The
contract is strict equivalence: push_many(frames) returns the SAME
outputs (pts and bit-identical planes) as concatenating push(f), while
batching K pairs into one fused device program.
"""

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)


def _build(display_fps, **kw):
    return InterpolationEngine(EngineConfig(
        display_fps=display_fps, auto_quality=False,
        initial_search_radius=5, measure_timing=False,
        background_precompile=False, **kw))


def _materialize(outs):
    return [(o.pts, np.asarray(o.device_planes()[0]),
             np.asarray(o.device_planes()[1])) for o in outs]


@pytest.mark.parametrize("display_fps,group", [(60.0, 4), (120.0, 3)])
def test_push_many_matches_push(display_fps, group):
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 11))
    e1 = _build(display_fps)
    e2 = _build(display_fps)
    ref = [o for f in frames for o in e1.push(f)]
    got = e2.push_many(frames, group_size=group)
    assert len(got) == len(ref)
    for (p1, y1, uv1), (p2, y2, uv2) in zip(_materialize(ref),
                                            _materialize(got)):
        assert abs(p1 - p2) < 1e-9
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(uv1, uv2)


def test_push_many_scene_cut_matches(monkeypatch):
    """A hard cut inside a group folds identically (traced cut logic is
    shared with the single-pair program)."""
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 8))
    # force a cut mid-stream: replace frame 4+ with inverted content
    import dataclasses
    frames = [dataclasses.replace(f, y=(255 - f.y) if i >= 4 else f.y)
              for i, f in enumerate(frames)]
    e1 = _build(60.0)
    e2 = _build(60.0)
    ref = [o for f in frames for o in e1.push(f)]
    got = e2.push_many(frames, group_size=8)
    assert len(got) == len(ref)
    for (p1, y1, uv1), (p2, y2, uv2) in zip(_materialize(ref),
                                            _materialize(got)):
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(uv1, uv2)


def test_push_many_incremental_calls():
    """Feeding the same stream across several push_many calls (partial
    groups at each boundary) still matches."""
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 10))
    e1 = _build(60.0)
    e2 = _build(60.0)
    ref = [o for f in frames for o in e1.push(f)]
    got = []
    got += e2.push_many(frames[:3], group_size=4)
    got += e2.push_many(frames[3:7], group_size=4)
    got += e2.push_many(frames[7:], group_size=4)
    assert [round(o.pts, 6) for o in got] == \
        [round(o.pts, 6) for o in ref]
    for (_, y1, uv1), (_, y2, uv2) in zip(_materialize(ref),
                                          _materialize(got)):
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(uv1, uv2)


class _CollectSink:
    def __init__(self):
        self.frames = []

    def write(self, out):
        self.frames.append((out.pts, np.asarray(out.device_planes()[0]),
                            np.asarray(out.device_planes()[1])))

    def close(self):
        pass


def test_pipeline_group_matches_ungrouped():
    """VERDICT r4 next #6: grouped dispatch is reachable from the product
    surface.  Pipeline(group=K) transcodes through engine.push_many and
    must emit bit-identical frames to the ungrouped pipeline."""
    from mpv_frame_interpolator.pipeline.player import Pipeline
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 9))
    s1, s2 = _CollectSink(), _CollectSink()
    Pipeline(iter(frames), _build(60.0), s1, present=None,
             stage_uploads=False).run()
    Pipeline(iter(frames), _build(60.0), s2, present=None,
             stage_uploads=False, group=4).run()
    assert len(s1.frames) == len(s2.frames) and len(s1.frames) > 0
    for (p1, y1, uv1), (p2, y2, uv2) in zip(s1.frames, s2.frames):
        assert abs(p1 - p2) < 1e-9
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(uv1, uv2)


def test_cli_group_requires_encode_sink():
    from mpv_frame_interpolator import cli
    with pytest.raises(SystemExit):
        cli.main(["synthetic:moving_box", "--frames", "3", "--group", "4",
                  "--width", "64", "--height", "48", "--untimed"])


def test_push_many_timing_feeds_controller():
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 10))
    e = InterpolationEngine(EngineConfig(
        display_fps=60.0, auto_quality=False, initial_search_radius=5,
        measure_timing=True,
        background_precompile=False))
    outs = e.push_many(frames, group_size=4)
    assert outs
    # grouped duration (per pair) lands in the stats like push's does
    assert e.stats.summary()["source_frame_time"]["count"] >= 1
