"""Shift-decomposed warp sampler (ops/warp._sample_all_planes): exact
equality with the per-pixel-gather path across modes, bit depths,
borders, and the runtime fallback."""

import numpy as np
import jax.numpy as jnp
import pytest

from mpv_frame_interpolator.frame import FrameFormat, VideoFrame
from mpv_frame_interpolator.ops.flow import FlowGeometry
from mpv_frame_interpolator.ops import warp as W

H_, W_ = 96, 128


def planes(seed, shift=0):
    rng = np.random.default_rng(seed)
    dt = np.uint16 if shift else np.uint8
    top = 255 << shift if shift else 255
    mk = lambda h, w: rng.integers(0, top + 1, (h, w)).astype(dt)
    return (mk(H_, W_), mk(H_ // 2, W_ // 2), mk(H_ // 2, W_ // 2),
            mk(H_, W_), mk(H_ // 2, W_ // 2), mk(H_ // 2, W_ // 2))


def flow_field(geom, kind, seed=3):
    rng = np.random.default_rng(seed)
    lh, lw = geom.low_h, geom.low_w
    if kind == "uniform":
        ox = np.full((lh, lw), 5, np.int32)
        oy = np.full((lh, lw), -3, np.int32)
    elif kind == "few":
        ox = rng.choice([-7, 0, 4, 11], (lh, lw)).astype(np.int32)
        oy = rng.choice([-2, 1, 6], (lh, lw)).astype(np.int32)
    elif kind == "border":
        # large displacements that push samples over every border
        ox = rng.choice([-90, -40, 60, 90], (lh, lw)).astype(np.int32)
        oy = rng.choice([-80, 50, 70], (lh, lw)).astype(np.int32)
    elif kind == "wild":
        # more distinct values than _ROLL_K -> runtime gather fallback
        ox = rng.integers(-100, 100, (lh, lw)).astype(np.int32)
        oy = rng.integers(-100, 100, (lh, lw)).astype(np.int32)
    elif kind == "huge":
        # |shift| beyond _ROLL_B -> fallback via the magnitude guard
        ox = np.full((lh, lw), 300, np.int32)
        oy = np.full((lh, lw), -280, np.int32)
    return jnp.asarray(np.stack([ox, oy]))


def run_mode(mode, kind, shift=0, t=0.37, occ=False):
    geom = FlowGeometry.create(H_, W_, W_)
    a = [jnp.asarray(p) for p in planes(11, shift)]
    blurred = flow_field(geom, kind)
    fields = W._warp_fields(geom, blurred)
    dtype = jnp.uint16 if shift else jnp.uint8
    outs = {}
    for sampling in ("gather", "shift"):
        y, u, v = W._warp_sample(geom, mode, shift and 8, dtype, *a,
                                 fields, jnp.float32(t), jnp.float32(0.0),
                                 jnp.float32(255.0), occlusion_aware=occ,
                                 sampling=sampling)
        outs[sampling] = (np.asarray(y), np.asarray(u), np.asarray(v))
    return outs


FIELDS = ("uniform", "few", "border", "wild", "huge")


class TestShiftEqualsGather:
    @pytest.mark.parametrize("kind", FIELDS)
    @pytest.mark.parametrize("mode", [W.WARPED_FRAME_12, W.WARPED_FRAME_21,
                                      W.BLENDED_FRAME, W.HSV_FLOW])
    def test_modes_8bit(self, mode, kind):
        outs = run_mode(mode, kind)
        for g, s in zip(outs["gather"], outs["shift"]):
            np.testing.assert_array_equal(g, s)

    @pytest.mark.parametrize("kind", ("few", "border"))
    def test_p010(self, kind):
        outs = run_mode(W.BLENDED_FRAME, kind, shift=8)
        for g, s in zip(outs["gather"], outs["shift"]):
            np.testing.assert_array_equal(g, s)

    def test_occlusion_aware(self):
        outs = run_mode(W.BLENDED_FRAME, "few", occ=True)
        for g, s in zip(outs["gather"], outs["shift"]):
            np.testing.assert_array_equal(g, s)

    @pytest.mark.parametrize("t", [0.0, 0.123, 0.5, 0.999, 1.0])
    def test_blend_positions(self, t):
        outs = run_mode(W.BLENDED_FRAME, "few", t=t)
        for g, s in zip(outs["gather"], outs["shift"]):
            np.testing.assert_array_equal(g, s)


class TestEngineDefaultShift:
    def test_config_default_and_validation(self):
        from mpv_frame_interpolator.pipeline.engine import EngineConfig
        assert EngineConfig().warp_sampling == "shift"
        for gone in ("nope", "pair", "fused", "pallas"):
            with pytest.raises(ValueError):
                EngineConfig(warp_sampling=gone)

    def test_engine_outputs_match_gather_engine(self):
        from mpv_frame_interpolator.io import synthetic
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        cfg = synthetic.SyntheticConfig(width=64, height=48)
        frames = list(synthetic.moving_box(cfg, 6))
        outs = {}
        for sampling in ("gather", "shift"):
            eng = InterpolationEngine(EngineConfig(
                warp_sampling=sampling, background_precompile=False,
                measure_timing=False))
            got = []
            for f in frames:
                for o in eng.push(f):
                    vf = o.to_video_frame()
                    got.append((vf.pts, vf.y.copy(), vf.uv.copy()))
            outs[sampling] = got
        assert len(outs["gather"]) == len(outs["shift"]) > 0
        for (pg, yg, uvg), (ps, ys, uvs) in zip(outs["gather"],
                                                outs["shift"]):
            assert pg == ps
            np.testing.assert_array_equal(yg, ys)
            np.testing.assert_array_equal(uvg, uvs)


class TestBilinearShift:
    """The 1/64-pel shift sampler (hopperq families) must be
    bit-identical to the per-pixel _bilinear_sample path, fallback
    included."""

    @pytest.mark.parametrize("kind", FIELDS)
    @pytest.mark.parametrize("occ", [False, True])
    def test_blended_8bit(self, kind, occ):
        geom = FlowGeometry.create(H_, W_, W_)
        a = [jnp.asarray(p) for p in planes(11, 0)]
        blurred = flow_field(geom, kind)
        fields = W._warp_fields(geom, blurred)
        outs = {}
        for sampling in ("gather", "shift"):
            y, u, v = W._warp_sample(
                geom, W.BLENDED_FRAME, 0, jnp.uint8, *a, fields,
                jnp.float32(0.4), jnp.float32(0.0), jnp.float32(255.0),
                occlusion_aware=occ, bilinear=True, sampling=sampling)
            outs[sampling] = (np.asarray(y), np.asarray(u), np.asarray(v))
        for g, s in zip(outs["gather"], outs["shift"]):
            np.testing.assert_array_equal(g, s)

    def test_blended_p010(self):
        geom = FlowGeometry.create(H_, W_, W_)
        a = [jnp.asarray(p) for p in planes(11, 8)]
        blurred = flow_field(geom, "few")
        fields = W._warp_fields(geom, blurred)
        outs = {}
        for sampling in ("gather", "shift"):
            y, u, v = W._warp_sample(
                geom, W.BLENDED_FRAME, 8, jnp.uint16, *a, fields,
                jnp.float32(0.63), jnp.float32(0.0), jnp.float32(255.0),
                bilinear=True, sampling=sampling)
            outs[sampling] = (np.asarray(y), np.asarray(u), np.asarray(v))
        for g, s in zip(outs["gather"], outs["shift"]):
            np.testing.assert_array_equal(g, s)
