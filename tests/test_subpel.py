"""Measured sub-pixel flow (EngineConfig.subpel_flow, hopperq/hopperxq).

The reference's flow is integer-pel (the signed-square commit only adds
whole pixels); ops/flow.subpel_refine fits a 2-D quadratic through the
windowed SAD costs on the 3x3 neighborhood of the committed offset and
the bilinear warp consumes the 1/64-pel result.

What to expect (and what these tests pin):

* On NON-UNIFORM motion (zoom/stretch) subpel wins multiple dB: integer
  flow quantizes the displacement gradient into stair-steps whose errors
  do NOT cancel across the bidirectional blend.
* On UNIFORM translation the bidirectional blend cancels any constant
  flow error to first order, so integer flow already measures near the
  bilinear-resampling ceiling; subpel must track the TRUE motion much
  better (flow-field accuracy) while costing at most a fraction of a dB
  of PSNR (estimator noise).
* On exact integer motion the gates (d0==0 / non-PD Hessian) make the
  refinement a no-op.
* With the flag off, outputs are bit-identical to the pre-feature path.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mpv_frame_interpolator.frame import FrameFormat, VideoFrame
from mpv_frame_interpolator.ops.flow import (
    FlowGeometry, _flow_impl, _subsampled_f2, blur_flow, subpel_refine)
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, _make_source_step)

W, H = 128, 96


def _texture(xs, yy):
    return (128.0
            + 55.0 * np.sin(2 * np.pi * xs / 23.0)
            * np.cos(2 * np.pi * yy / 19.0)
            + 40.0 * np.sin(2 * np.pi * xs / 61.0))


def _frame(y_plane):
    uv = np.full((H // 2, W), 128, np.uint8)
    return VideoFrame(np.clip(np.round(y_plane), 0, 255).astype(np.uint8),
                      uv, FrameFormat(W, H, "nv12"))


def pan_frame(t: float, v: float = 1.5) -> VideoFrame:
    """Uniform translation by v px/frame; analytic truth at any t."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    return _frame(_texture(xx - t * v, yy))


def zoom_frame(t: float) -> VideoFrame:
    """Eulerian zoom-pan frame(t) = g((1 - t*b)x - t*a): displacement
    varies ~2.5 px across the width, so flow errors cannot cancel."""
    a, b = 1.2, 2.5 / W
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    return _frame(_texture((1 - t * b) * xx - t * a, yy))


def interpolate(f1, f2, t, subpel: bool, model: str = "hopperq"):
    geom = FlowGeometry.create(H, W, W)
    step = _make_source_step(geom, 2, 0, "nearest", False, model,
                             "vmap", subpel)
    y, uv, blurred, _ = step(
        jnp.asarray(f1.y), jnp.asarray(f1.uv),
        jnp.asarray(f2.y), jnp.asarray(f2.uv),
        jnp.asarray([t], jnp.float32), jnp.int32(8),
        jnp.int32(8), jnp.int32(6),
        jnp.float32(0.0), jnp.float32(255.0), jnp.float32(28.0))
    return np.asarray(y[0]), np.asarray(blurred)


def psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = np.mean(d * d)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def central(img):
    return img[12:-12, 12:-12]


def refine_field(f1, f2):
    """(blurred-int flow, subpel 1/64 field) as the engine computes it."""
    geom = FlowGeometry.create(H, W, W)
    pl = lambda f: (jnp.asarray(f.y), jnp.asarray(f.uv[:, 0::2]),
                    jnp.asarray(f.uv[:, 1::2]))
    a1, a2 = pl(f1), pl(f2)
    off, blurred = _flow_impl(geom, jnp.int32(8), 0, *a1, *a2,
                              jnp.int32(8), jnp.int32(6), layers=16)
    frac = subpel_refine(geom, off, *a1, _subsampled_f2(geom, *a2))
    b64 = blur_flow((off << 6) + frac, geom.low_h, geom.low_w)
    return np.asarray(blurred), np.asarray(b64), np.asarray(frac)


class TestSubpelQuality:
    @pytest.mark.parametrize("t", [0.25, 0.5, 0.75])
    def test_zoom_improves_multiple_db(self, t):
        """Non-uniform motion: stair-stepped integer flow loses dBs that
        the measured sub-pel field recovers."""
        f1, f2 = zoom_frame(0.0), zoom_frame(1.0)
        truth = zoom_frame(t).y
        y_int, _ = interpolate(f1, f2, t, subpel=False)
        y_sub, _ = interpolate(f1, f2, t, subpel=True)
        p_int = psnr(central(y_int), central(truth))
        p_sub = psnr(central(y_sub), central(truth))
        assert p_sub > p_int + 1.5, (t, p_int, p_sub)

    def test_zoom_improves_hopperxq(self):
        f1, f2 = zoom_frame(0.0), zoom_frame(1.0)
        truth = zoom_frame(0.5).y
        y_int, _ = interpolate(f1, f2, 0.5, False, model="hopperxq")
        y_sub, _ = interpolate(f1, f2, 0.5, True, model="hopperxq")
        assert psnr(central(y_sub), central(truth)) \
            > psnr(central(y_int), central(truth)) + 1.0

    def test_uniform_pan_flow_accuracy(self):
        """1.5 px/frame pan: the integer+blur flow sits a half-pel off
        (committed offsets straddle -1/-2); the sub-pel field must land
        within 0.1 px of the true motion, with modest spatial noise."""
        f1, f2 = pan_frame(0.0), pan_frame(1.0)
        blurred, b64, _ = refine_field(f1, f2)
        inner = (slice(6, -6), slice(6, -6))
        assert abs(blurred[0][inner].mean() - (-1.5)) > 0.3   # int is off
        sub_x = b64[0][inner] / 64.0
        assert abs(sub_x.mean() - (-1.5)) < 0.1, sub_x.mean()
        assert sub_x.std() < 0.3
        assert abs(b64[1][inner].mean() / 64.0) < 0.1         # y ~ 0

    def test_uniform_pan_psnr_within_noise(self):
        """Uniform translation is subpel's worst case (bidirectional
        cancellation makes integer flow 'free'); the cost must stay under
        a fraction of a dB."""
        f1, f2 = pan_frame(0.0), pan_frame(1.0)
        truth = pan_frame(0.5).y
        y_int, _ = interpolate(f1, f2, 0.5, subpel=False)
        y_sub, _ = interpolate(f1, f2, 0.5, subpel=True)
        p_int = psnr(central(y_int), central(truth))
        p_sub = psnr(central(y_sub), central(truth))
        assert p_sub > p_int - 0.8, (p_int, p_sub)

    def test_integer_pan_not_degraded(self):
        f1, f2 = pan_frame(0.0, v=2.0), pan_frame(1.0, v=2.0)
        truth = pan_frame(0.5, v=2.0).y
        y_int, _ = interpolate(f1, f2, 0.5, subpel=False)
        y_sub, _ = interpolate(f1, f2, 0.5, subpel=True)
        p_int = psnr(central(y_int), central(truth))
        p_sub = psnr(central(y_sub), central(truth))
        assert p_sub > p_int - 0.5, (p_int, p_sub)

    def test_zoom_improves_hopper_rounded(self):
        """Integer families consume the measured field as round-to-nearest
        (vs floor-of-integer-blur); on non-uniform motion the better-
        centered field must not lose and should win at mid-blend."""
        f1, f2 = zoom_frame(0.0), zoom_frame(1.0)
        t = 0.5
        truth = zoom_frame(t).y
        y_int, _ = interpolate(f1, f2, t, False, model="hopper")
        y_sub, _ = interpolate(f1, f2, t, True, model="hopper")
        p_int = psnr(central(y_int), central(truth))
        p_sub = psnr(central(y_sub), central(truth))
        assert p_sub > p_int + 0.5, (p_int, p_sub)

    def test_hopperx_subpel_not_degraded(self):
        f1, f2 = pan_frame(0.0), pan_frame(1.0)
        truth = pan_frame(0.5).y
        y_int, _ = interpolate(f1, f2, 0.5, False, model="hopperx")
        y_sub, _ = interpolate(f1, f2, 0.5, True, model="hopperx")
        p_int = psnr(central(y_int), central(truth))
        p_sub = psnr(central(y_sub), central(truth))
        assert p_sub > p_int - 0.8, (p_int, p_sub)

    def test_flag_off_unchanged_and_default_off(self):
        f1, f2 = pan_frame(0.0), pan_frame(1.0)
        a = interpolate(f1, f2, 0.5, subpel=False)
        b = interpolate(f1, f2, 0.5, subpel=False)
        np.testing.assert_array_equal(a[0], b[0])
        assert EngineConfig().subpel_flow is False


class TestSubpelRefineOp:
    def test_clamped_range_and_shape(self):
        f1, f2 = pan_frame(0.0), pan_frame(1.0)
        geom = FlowGeometry.create(H, W, W)
        _, b64, frac = refine_field(f1, f2)
        assert frac.shape == (2, geom.low_h, geom.low_w)
        assert frac.min() >= -32 and frac.max() <= 32

    def test_identical_frames_zero(self):
        """Exact match everywhere: d0 == 0 gate zeroes the correction."""
        f1 = pan_frame(0.0)
        geom = FlowGeometry.create(H, W, W)
        pl = lambda f: (jnp.asarray(f.y), jnp.asarray(f.uv[:, 0::2]),
                        jnp.asarray(f.uv[:, 1::2]))
        a1 = pl(f1)
        blurred = jnp.zeros((2, geom.low_h, geom.low_w), jnp.int32)
        frac = np.asarray(subpel_refine(geom, blurred, *a1,
                                        _subsampled_f2(geom, *a1)))
        assert np.all(frac == 0)

    def test_p010_scale(self):
        """10-bit inputs ride the same fit on the 8-bit scale."""
        f1, f2 = pan_frame(0.0), pan_frame(1.0)
        geom = FlowGeometry.create(H, W, W)
        up = lambda f: ((f.y.astype(np.uint16) << 8),
                        (f.uv.astype(np.uint16) << 8))
        y1, uv1 = up(f1)
        y2, uv2 = up(f2)
        pl = lambda y, uv: (jnp.asarray(y), jnp.asarray(uv[:, 0::2]),
                            jnp.asarray(uv[:, 1::2]))
        a1, a2 = pl(y1, uv1), pl(y2, uv2)
        off, _ = _flow_impl(geom, jnp.int32(8), 8, *a1, *a2,
                            jnp.int32(8), jnp.int32(6), layers=16)
        frac = np.asarray(subpel_refine(geom, off, *a1,
                                        _subsampled_f2(geom, *a2),
                                        luma_shift=8))
        inner = (slice(6, -6), slice(6, -6))
        assert frac.min() >= -32 and frac.max() <= 32
        assert np.abs(frac[0][inner]).mean() > 2   # it did measure motion


def test_shift_probes_match_gather():
    """The phase-decomposed 3x3 probe sampler must be bit-identical to
    the per-pixel-gather form it replaced (same contract as the pyramid
    sampler's runtime fallback)."""
    import mpv_frame_interpolator.ops.flow as F
    from mpv_frame_interpolator.io import synthetic
    cfg = synthetic.SyntheticConfig(width=W, height=H, fps=24.0)
    f1, f2 = list(synthetic.gradient_pan(cfg, 2, vx=3, vy=2))
    geom = FlowGeometry.create(H, W, W)
    pl = lambda f: (jnp.asarray(f.y), jnp.asarray(f.uv[:, 0::2]),
                    jnp.asarray(f.uv[:, 1::2]))
    a1, a2 = pl(f1), pl(f2)
    off, _ = _flow_impl(geom, jnp.int32(8), 0, *a1, *a2,
                        jnp.int32(8), jnp.int32(6), layers=16)
    probe = _subsampled_f2(geom, *a2)
    frac_shift = subpel_refine(geom, off, *a1, probe)
    orig = F._phase_stacks
    F._phase_stacks = lambda *a, **k: None      # force the gather branch
    try:
        frac_gather = subpel_refine(geom, off, *a1, probe)
    finally:
        F._phase_stacks = orig
    np.testing.assert_array_equal(np.asarray(frac_shift),
                                  np.asarray(frac_gather))
