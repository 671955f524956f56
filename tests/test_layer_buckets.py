"""Layer-bucketed flow programs (VERDICT r2 item 2).

The reference scales its delta-sum launch grid's layer dimension with the
LIVE search radius (opticalFlowCalc.c:130), so dropping the radius really
cuts compute -- that's how its TooSlow rescue works.  The rebuild keeps
the radius traced (no recompiles within a bucket) but compiles layer-count
VARIANTS (EngineConfig.layer_buckets): radius r runs the smallest variant
with layers >= r.  These tests pin:

* bit-exactness: a small-layer variant produces the identical flow field
  for every radius it serves (masked tail layers never change the
  first-min argmin);
* the engine actually selects the bucket for the live radius and
  switching buckets mid-stream keeps outputs bit-identical to a fixed
  MAX-layer engine.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mpv_frame_interpolator.frame import split_chroma
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.ops.flow import FlowGeometry, _flow_impl
from mpv_frame_interpolator.ops.oracle import MAX_SEARCH_RADIUS
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)


def planes(cfg, source="gradient_pan"):
    g = getattr(synthetic, source)(cfg, 2)
    f1, f2 = next(g), next(g)
    return [jnp.asarray(x) for x in (f1.y, *split_chroma(f1.uv),
                                     f2.y, *split_chroma(f2.uv))]


@pytest.mark.parametrize("layers,radius", [
    (5, 5), (5, 3), (8, 8), (8, 6), (16, 11),
])
def test_bucket_variant_bit_exact(layers, radius):
    cfg = synthetic.SyntheticConfig(width=96, height=64)
    a = planes(cfg)
    geom = FlowGeometry.create(64, 96, 96)
    o1, b1 = _flow_impl(geom, jnp.int32(radius), 0, *a, jnp.int32(8),
                        jnp.int32(6), layers=layers)
    o2, b2 = _flow_impl(geom, jnp.int32(radius), 0, *a, jnp.int32(8),
                        jnp.int32(6), layers=MAX_SEARCH_RADIUS)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))


def _run(engine, frames):
    outs = []
    for f in frames:
        for o in engine.push(f):
            outs.append(o.to_video_frame())
    return outs


def test_engine_bucket_selection_and_parity():
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 8))

    def build(buckets):
        return InterpolationEngine(EngineConfig(
            display_fps=60.0, auto_quality=False, initial_search_radius=5,
            measure_timing=False, background_precompile=False,
            layer_buckets=buckets))

    e_b = build((5, 8, 16))
    e_m = build(())          # round-2 behavior: single 16-layer program
    assert e_b._layers_for(5) == 5
    assert e_b._layers_for(6) == 8
    assert e_b._layers_for(16) == 16
    assert e_m._layers_for(5) == MAX_SEARCH_RADIUS

    o_b, o_m = [], []
    for i, f in enumerate(frames):
        if i == 4:
            # mid-stream radius change crossing a bucket boundary
            e_b.quality.search_radius = 9
            e_m.quality.search_radius = 9
        o_b.extend(_run(e_b, [f]))
        o_m.extend(_run(e_m, [f]))
    assert len(o_b) == len(o_m) and len(o_b) > 0
    for a, b in zip(o_b, o_m):
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.uv, b.uv)


def test_bucket_warm_specs_tracked():
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 4))
    e = InterpolationEngine(EngineConfig(
        display_fps=60.0, auto_quality=False, initial_search_radius=5,
        measure_timing=False, background_precompile=False))
    _run(e, frames)
    # spec = (mode, n_batch, model, layers, degrade level)
    assert all(len(spec) == 5 and spec[3] == 5 and spec[4] == 0
               for spec in e._warm)
