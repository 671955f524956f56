"""warp_loop="scan" must be bit-identical to the vmapped warp batch.

The scan variant exists to cut cold-start compile time (the warp body is
traced once per program instead of unrolled per blend position); it runs
the exact same per-position ops, so every output mode and model family
must match byte-for-byte.
"""

import dataclasses as dc

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)

KW = dict(scene_detection=False, auto_quality=False, measure_timing=False,
          display_fps=120.0)


def run(cfg_engine, frames):
    eng = InterpolationEngine(cfg_engine)
    outs = []
    for f in frames:
        outs.extend(eng.push(f))
    return [o.to_video_frame() for o in outs]


def assert_identical(a, b):
    assert len(a) == len(b)
    for va, vb in zip(a, b):
        assert va.pts == vb.pts
        np.testing.assert_array_equal(va.y, vb.y)
        np.testing.assert_array_equal(va.uv, vb.uv)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 5, 6])
def test_scan_matches_vmap_modes(small_cfg, mode):
    frames = list(synthetic.moving_box(small_cfg, 4))
    a = run(EngineConfig(**KW, frame_output_mode=mode, warp_loop="vmap"),
            frames)
    b = run(EngineConfig(**KW, frame_output_mode=mode, warp_loop="scan"),
            frames)
    assert_identical(a, b)


@pytest.mark.parametrize("model", ["hopper", "hopperx", "hopperq",
                                   "hopperxq", "blend", "repeat"])
def test_scan_matches_vmap_models(small_cfg, model):
    frames = list(synthetic.gradient_pan(small_cfg, 3))
    a = run(EngineConfig(**KW, model=model, warp_loop="vmap"), frames)
    b = run(EngineConfig(**KW, model=model, warp_loop="scan"), frames)
    assert_identical(a, b)


def test_scan_matches_vmap_p010_and_scene(small_cfg):
    cfg10 = dc.replace(small_cfg, pixfmt="p010")
    frames = list(synthetic.gradient_pan(cfg10, 3))
    kw = dict(KW, scene_detection=True)
    a = run(EngineConfig(**kw, warp_loop="vmap"), frames)
    b = run(EngineConfig(**kw, warp_loop="scan"), frames)
    assert_identical(a, b)


def test_warp_loop_validation():
    with pytest.raises(ValueError):
        EngineConfig(warp_loop="unrolled")
