"""Interpolator model families: hopper facade, blend and repeat fallbacks."""

import numpy as np
import pytest
import jax.numpy as jnp

from mpv_frame_interpolator import models
from mpv_frame_interpolator.models.hopper import HopperModel
from mpv_frame_interpolator.ops import oracle
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator.io import synthetic

from conftest import frame_pair, planar


def eng(**kw):
    kw.setdefault("scene_detection", False)
    kw.setdefault("auto_quality", False)
    kw.setdefault("measure_timing", False)
    return InterpolationEngine(EngineConfig(**kw))


class TestRegistry:
    def test_validate(self):
        assert models.validate("hopper") == "hopper"
        with pytest.raises(ValueError):
            models.validate("nope")
        with pytest.raises(ValueError):
            eng(model="bogus")


class TestHopperModel:
    def test_facade_matches_oracle(self, small_cfg):
        f1, f2 = frame_pair(small_cfg)
        m = HopperModel.for_frame(f1.fmt.height, f1.fmt.width,
                                  search_radius=6)
        a = [jnp.asarray(x) for x in (*planar(f1), *planar(f2))]
        off, blur = m.analyze(*a)
        off_ref, blur_ref = oracle.calculate_optical_flow(
            f1.y, f1.uv, f2.y, f2.uv, search_radius=6,
            res_scalar=m.geom.res_scalar, lh=m.geom.low_h, lw=m.geom.low_w)
        np.testing.assert_array_equal(off_ref.astype(np.int32),
                                      np.asarray(off))
        y, u, v = m.synthesize(*a, blur, 0.4)
        ry, _ = oracle.warp_frame(f1.y, f1.uv, f2.y, f2.uv, blur_ref, 0.4,
                                  oracle.BLENDED_FRAME, m.geom.res_scalar,
                                  m.geom.actual_width)
        np.testing.assert_array_equal(ry, np.asarray(y))

    def test_interpolate_batch(self, small_cfg):
        f1, f2 = frame_pair(small_cfg)
        m = HopperModel.for_frame(f1.fmt.height, f1.fmt.width)
        a = [jnp.asarray(x) for x in (*planar(f1), *planar(f2))]
        y, u, v = m.interpolate(*a, ts=[0.0, 0.25, 0.5, 0.75])
        assert y.shape[0] == 4 and u.shape == (4, 24, 32)


class TestFallbackModels:
    def test_blend_is_zero_flow_crossfade(self, small_cfg):
        e = eng(model="blend")
        frames = list(synthetic.moving_box(small_cfg, 3))
        outs = []
        for f in frames:
            outs.extend(e.push(f))
        geom = e.geom
        zero = np.zeros((2, geom.low_h, geom.low_w), np.int16)
        ry, _ = oracle.warp_frame(frames[0].y, frames[0].uv, frames[1].y,
                                  frames[1].uv, zero, 0.4,
                                  oracle.BLENDED_FRAME, geom.res_scalar,
                                  geom.actual_width)
        got = outs[2].to_video_frame()   # second output of pair 1: t=0.4
        np.testing.assert_array_equal(ry, got.y)

    def test_repeat_outputs_source_frames(self, small_cfg):
        e = eng(model="repeat")
        frames = list(synthetic.moving_box(small_cfg, 3))
        outs = []
        for f in frames:
            outs.extend(e.push(f))
        geom = e.geom
        zero = np.zeros((2, geom.low_h, geom.low_w), np.int16)
        # t=0.4 snaps to 0.0 -> frame1 (through levels)
        ry, _ = oracle.warp_frame(frames[0].y, frames[0].uv, frames[1].y,
                                  frames[1].uv, zero, 0.0,
                                  oracle.BLENDED_FRAME, geom.res_scalar,
                                  geom.actual_width)
        got = outs[2].to_video_frame()
        np.testing.assert_array_equal(ry, got.y)
        # t=0.8 snaps to 1.0 -> frame2
        ry2, _ = oracle.warp_frame(frames[0].y, frames[0].uv, frames[1].y,
                                   frames[1].uv, zero, 1.0,
                                   oracle.BLENDED_FRAME, geom.res_scalar,
                                   geom.actual_width)
        got2 = outs[3].to_video_frame()
        np.testing.assert_array_equal(ry2, got2.y)


class TestBatchModes:
    def test_sbs_batch_matches_single(self, small_cfg):
        import jax.numpy as jnp
        from mpv_frame_interpolator.ops.warp import (
            make_warp_fn, make_warp_batch_fn, SIDE_BY_SIDE_2)
        f1, f2 = frame_pair(small_cfg)
        m = HopperModel.for_frame(f1.fmt.height, f1.fmt.width)
        a = [jnp.asarray(x) for x in (*planar(f1), *planar(f2))]
        _, blur = m.analyze(*a)
        single = make_warp_fn(m.geom, SIDE_BY_SIDE_2)
        batch = make_warp_batch_fn(m.geom, SIDE_BY_SIDE_2)
        ys, us, vs = batch(*a, blur, jnp.asarray([0.2, 0.7], jnp.float32),
                           jnp.float32(0.0), jnp.float32(255.0))
        for i, t in enumerate((0.2, 0.7)):
            y1, u1, v1 = single(*a, blur, jnp.float32(t),
                                jnp.float32(0.0), jnp.float32(255.0))
            np.testing.assert_array_equal(np.asarray(y1), np.asarray(ys[i]))
            np.testing.assert_array_equal(np.asarray(u1), np.asarray(us[i]))


class TestHopperX:
    def _ground_truth_midpoints(self, n=4):
        """moving_box at vx=4/24fps has exact midpoints at vx=2/48fps."""
        cfg24 = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
        cfg48 = synthetic.SyntheticConfig(width=96, height=64, fps=48.0)
        src = list(synthetic.moving_box(cfg24, n, vx=4, vy=0))
        fine = list(synthetic.moving_box(cfg48, 2 * n, vx=2, vy=0))
        mids = [fine[2 * i + 1] for i in range(n - 1)]
        return src, mids

    def _run(self, model, src):
        e = eng(model=model, initial_search_radius=8)
        outs = []
        for f in src:
            outs.extend(e.push(f))
        return outs

    def test_snaps_at_high_disagreement(self):
        """Behavioral spec: where |s12-s21| is far above the ramp, the
        hopperx output equals the nearest-source warp; elsewhere it equals
        the plain blend.  (PSNR would prefer the ghosted average -- see
        ops/warp._occlusion_adjust -- so the spec, not PSNR, is asserted.)"""
        src, mids = self._ground_truth_midpoints()
        outs_b = self._run_display("hopper", src)
        outs_x = self._run_display("hopperx", src)
        diff_frames = 0
        for a, b in zip(outs_b, outs_x):
            ya = a.to_video_frame().y.astype(int)
            yb = b.to_video_frame().y.astype(int)
            if not np.array_equal(ya, yb):
                diff_frames += 1
        # the t=0.5 midpoints contain occluded box edges -> must differ
        assert diff_frames >= 1

    def _run_display(self, model, src, fps=48.0):
        e = eng(model=model, display_fps=fps, initial_search_radius=8)
        outs = []
        for f in src:
            outs.extend(e.push(f))
        return outs

    def test_identical_when_samples_agree(self, small_cfg):
        """On a static scene s12 == s21 everywhere -> hopperx == hopper."""
        frames = [f.with_pts(i / 24.0) for i, f in
                  enumerate([next(iter(synthetic.moving_box(small_cfg, 1)))] * 4)]
        for f in frames:
            f.nominal_fps = 24.0
        a = self._run("hopper", frames)
        b = self._run("hopperx", frames)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x.to_video_frame().y),
                                          np.asarray(y.to_video_frame().y))


class TestHopperQ:
    def _sine_pair(self, shift=5, w=128, h=64):
        """Analytic content: luma sin pattern, frame2 = frame1 shifted by
        `shift` px; ground truth at ANY subpixel position is computable."""
        import numpy as np
        from mpv_frame_interpolator.frame import FrameFormat, VideoFrame, interleave_chroma

        def pattern(delta):
            x = np.arange(w)[None, :] - delta
            y = np.arange(h)[:, None]
            val = 128 + 90 * np.sin(2 * np.pi * x / 16.0) \
                      + 20 * np.sin(2 * np.pi * y / 24.0)
            return np.clip(val, 0, 255).astype(np.uint8)

        def mk(delta, pts):
            yp = pattern(delta)
            u = np.full((h // 2, w // 2), 128, np.uint8)
            v = np.full((h // 2, w // 2), 128, np.uint8)
            return VideoFrame(yp, interleave_chroma(u, v),
                              FrameFormat(w, h), pts=pts, nominal_fps=24.0), pattern
        f1, _ = mk(0.0, 0.0)
        f2, _ = mk(float(shift), 1 / 24.0)
        return f1, f2, pattern

    @pytest.mark.parametrize("t,margin", [(0.3, 3.0), (0.5, -0.2), (0.7, 3.0)])
    def test_subpixel_beats_nearest(self, t, margin):
        # at t=0.5 the two nearest-roundings straddle the true position
        # symmetrically and the blend cancels most of the error, so the
        # bilinear win is small there; off-center it is decisive
        import jax.numpy as jnp
        from mpv_frame_interpolator.frame import psnr_arrays
        from mpv_frame_interpolator.ops import warp as W
        from mpv_frame_interpolator.ops.flow import FlowGeometry

        shift = 5
        f1, f2, pattern = self._sine_pair(shift)
        geom = FlowGeometry.create(64, 128, 128)
        m = HopperModel.for_frame(64, 128, search_radius=8)
        a = [jnp.asarray(x) for x in (*planar(f1), *planar(f2))]
        _, blur = m.analyze(*a)

        gt = pattern(shift * t)[8:-8, 16:-16]

        def render(bilinear):
            fields = W._warp_fields(geom, blur)
            y, u, v = W._warp_sample(
                geom, W.BLENDED_FRAME, 0, jnp.uint8, *a, fields,
                jnp.float32(t), jnp.float32(0.0), jnp.float32(255.0),
                bilinear=bilinear)
            return np.asarray(y)[8:-8, 16:-16]

        p_near = psnr_arrays(render(False), gt, 255)
        p_bilin = psnr_arrays(render(True), gt, 255)
        assert p_bilin > p_near + margin, (p_near, p_bilin)

    def test_engine_hopperq_runs(self, small_cfg):
        e = eng(model="hopperq")
        outs = []
        for f in synthetic.moving_box(small_cfg, 3):
            outs.extend(e.push(f))
        assert len(outs) == 6


class TestModelGuards:
    def test_blend_scalar_guard(self, small_cfg):
        # opticalFlowCalc.c:209-211 rejects blendingScalar > 1.0
        import jax.numpy as jnp
        f1, f2 = frame_pair(small_cfg)
        m = HopperModel.for_frame(f1.fmt.height, f1.fmt.width)
        a = [jnp.asarray(x) for x in (*planar(f1), *planar(f2))]
        _, blur = m.analyze(*a)
        with pytest.raises(ValueError, match="blending scalar"):
            m.synthesize(*a, blur, 1.5)

    def test_engine_flush_is_empty(self, small_cfg):
        e = eng()
        for f in synthetic.moving_box(small_cfg, 2):
            e.push(f)
        assert e.flush() == []


class TestHopperQChroma:
    def test_subpixel_chroma(self):
        """Chroma sine pan: hopperq's bilinear chroma must beat nearest."""
        import jax.numpy as jnp
        from mpv_frame_interpolator.frame import (
            FrameFormat, VideoFrame, interleave_chroma, psnr_arrays)
        from mpv_frame_interpolator.ops import warp as W

        w, h, shift = 128, 64, 6

        def upat(delta):
            # chroma-plane sine (planar coords); delta in LUMA pixels
            x = np.arange(w // 2)[None, :] - delta / 2.0
            y = np.arange(h // 2)[:, None]
            return np.clip(128 + 60 * np.sin(2 * np.pi * (x + y / 3) / 10.0),
                           0, 255).astype(np.uint8)

        def ypat(delta):
            x = np.arange(w)[None, :] - delta
            return np.clip(128 + 80 * np.sin(2 * np.pi * x / 16.0), 0, 255
                           ).astype(np.uint8) * np.ones((h, 1), np.uint8)

        def mk(delta, pts):
            return VideoFrame(ypat(delta),
                              interleave_chroma(upat(delta), upat(delta)),
                              FrameFormat(w, h), pts=pts, nominal_fps=24.0)

        f1, f2 = mk(0, 0.0), mk(shift, 1 / 24.0)
        m = HopperModel.for_frame(h, w, search_radius=8)
        a = [jnp.asarray(x) for x in (*planar(f1), *planar(f2))]
        _, blur = m.analyze(*a)
        fields = W._warp_fields(m.geom, blur)
        t = 0.4
        gt_u = upat(shift * t)[4:-4, 8:-8]

        def render(**kw):
            _, u, _ = W._warp_sample(
                m.geom, W.BLENDED_FRAME, 0, jnp.uint8, *a, fields,
                jnp.float32(t), jnp.float32(0.0), jnp.float32(255.0), **kw)
            return np.asarray(u)[4:-4, 8:-8]

        p_near = psnr_arrays(render(), gt_u, 255)
        p_bilin = psnr_arrays(render(bilinear=True), gt_u, 255)
        assert p_bilin > p_near + 2.0, (p_near, p_bilin)


class TestHopperXQ:
    """hopperxq = hopperq (sub-pixel) + hopperx (occlusion-aware blend)."""

    def test_engine_runs_and_differs_from_parents(self, small_cfg):
        import numpy as np
        # smooth gradient: sub-pixel sampling measurably differs from
        # nearest (a piecewise-constant scene would alias them)
        frames = list(synthetic.gradient_pan(small_cfg, 3, vx=3, vy=1))

        def run(model):
            e = eng(model=model)
            outs = []
            for f in frames:
                outs.extend(e.push(f))
            # outs[1] is the t=0 slot (all families coincide there);
            # outs[2] is a fractional blend position (t=0.4)
            return np.asarray(outs[2].device_planes()[0])

        xq = run("hopperxq")
        q = run("hopperq")
        x = run("hopperx")
        base = run("hopper")
        # the combination is its own point in quality space: sub-pixel
        # sampling differs from hopperx, occlusion handling from hopperq
        assert not np.array_equal(xq, x)
        assert not np.array_equal(xq, base)
        assert xq.shape == q.shape

    def test_agreeing_samples_match_hopperq(self, small_cfg):
        """On a static (zero-motion, fully agreeing) scene the occlusion
        term is inactive: hopperxq == hopperq exactly."""
        import numpy as np
        from mpv_frame_interpolator.frame import FrameFormat, VideoFrame
        fmt = FrameFormat(64, 48)
        still = VideoFrame(np.full((48, 64), 120, np.uint8),
                           np.full((24, 64), 128, np.uint8), fmt,
                           pts=0.0, nominal_fps=24.0)
        def run(model):
            e = eng(model=model)
            outs = []
            for i in range(3):
                outs.extend(e.push(VideoFrame(
                    still.y, still.uv, fmt, pts=i / 24.0,
                    nominal_fps=24.0)))
            return [np.asarray(o.device_planes()[0]) for o in outs]
        for a, b in zip(run("hopperxq"), run("hopperq")):
            np.testing.assert_array_equal(a, b)
