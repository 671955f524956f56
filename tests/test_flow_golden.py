"""Golden tests: JAX flow pipeline must match the NumPy oracle bit-exactly."""

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.ops import oracle
from mpv_frame_interpolator.ops.flow import FlowGeometry, make_flow_fn, blur_flow
import jax.numpy as jnp

from conftest import frame_pair, planar


def _run_both(cfg, source="moving_box", radius=8, ds=8, nbs=6, **kw):
    f1, f2 = frame_pair(cfg, source, **kw)
    geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride, f1.fmt.width)

    off_ref, blur_ref = oracle.calculate_optical_flow(
        f1.y, f1.uv, f2.y, f2.uv,
        search_radius=radius, res_scalar=geom.res_scalar,
        lh=geom.low_h, lw=geom.low_w,
        delta_scalar=ds, neighbor_bias_scalar=nbs)

    fn = make_flow_fn(geom, radius)
    y1, u1, v1 = planar(f1)
    y2, u2, v2 = planar(f2)
    off_jax, blur_jax = fn(y1, u1, v1, y2, u2, v2,
                           jnp.int32(ds), jnp.int32(nbs))
    return geom, off_ref, blur_ref, np.asarray(off_jax), np.asarray(blur_jax)


class TestFlowGolden:
    def test_moving_box_exact(self, small_cfg):
        _, off_ref, blur_ref, off_jax, blur_jax = _run_both(small_cfg)
        np.testing.assert_array_equal(off_ref.astype(np.int32), off_jax)
        np.testing.assert_array_equal(blur_ref.astype(np.int32), blur_jax)

    def test_noise_exact(self, small_cfg):
        _, off_ref, blur_ref, off_jax, blur_jax = _run_both(
            small_cfg, source="noise", radius=5)
        np.testing.assert_array_equal(off_ref.astype(np.int32), off_jax)
        np.testing.assert_array_equal(blur_ref.astype(np.int32), blur_jax)

    def test_gradient_pan_exact(self, small_cfg):
        _, off_ref, blur_ref, off_jax, blur_jax = _run_both(
            small_cfg, source="gradient_pan", radius=11)
        np.testing.assert_array_equal(off_ref.astype(np.int32), off_jax)

    @pytest.mark.parametrize("radius", [5, 16])
    def test_radius_extremes(self, small_cfg, radius):
        _, off_ref, _, off_jax, _ = _run_both(small_cfg, radius=radius)
        np.testing.assert_array_equal(off_ref.astype(np.int32), off_jax)

    def test_pyramid_res_scalar(self, pyramid_cfg):
        geom, off_ref, blur_ref, off_jax, blur_jax = _run_both(
            pyramid_cfg, source="gradient_pan", radius=6)
        assert geom.res_scalar >= 1
        np.testing.assert_array_equal(off_ref.astype(np.int32), off_jax)
        np.testing.assert_array_equal(blur_ref.astype(np.int32), blur_jax)

    def test_delta_scalar_variants(self, small_cfg):
        _, off_ref, _, off_jax, _ = _run_both(small_cfg, ds=3, nbs=10)
        np.testing.assert_array_equal(off_ref.astype(np.int32), off_jax)


class TestFlowSemantics:
    """Property tests on the oracle itself (it is the golden model, so it
    gets sanity checks independent of any implementation)."""

    def test_static_scene_zero_flow(self, small_cfg):
        f1, _ = frame_pair(small_cfg)
        geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride, f1.fmt.width)
        off, _ = oracle.calculate_optical_flow(
            f1.y, f1.uv, f1.y, f1.uv, search_radius=8,
            res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
        # identical frames: zero offset always has the lowest delta+bias
        assert np.all(off == 0)

    def test_translation_detected(self, small_cfg):
        # gradient_pan with vx=2: frame2 content = frame1 shifted left by 2,
        # i.e. f2(x) = f1(x + 2) -> matching offset is +2 (sampled +x in f1)
        f1, f2 = frame_pair(small_cfg, "gradient_pan", vx=2, vy=0)
        geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride, f1.fmt.width)
        off, _ = oracle.calculate_optical_flow(
            f1.y, f1.uv, f2.y, f2.uv, search_radius=8,
            res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
        interior = off[0, 8:-8, 8:-8]
        # dominant offset should be +2 in x
        vals, counts = np.unique(interior, return_counts=True)
        assert vals[np.argmax(counts)] == 2

    def test_blur_is_box_average(self):
        rng = np.random.default_rng(0)
        field = rng.integers(-40, 40, size=(2, 24, 32)).astype(np.int16)
        blurred = oracle.blur_flow(field)
        # center pixel check against direct computation
        y, x = 12, 16
        acc = 0
        for ky in range(-4, 4):
            for kx in range(-4, 4):
                acc += int(field[0, y + ky, x + kx])
        expect = int(np.sign(acc) * (abs(acc) // 64))
        assert blurred[0, y, x] == expect

    def test_blur_jax_matches_oracle(self):
        rng = np.random.default_rng(1)
        field = rng.integers(-100, 100, size=(2, 17, 23)).astype(np.int32)
        ref = oracle.blur_flow(field)
        jx = np.asarray(blur_flow(jnp.asarray(field), 17, 23))
        np.testing.assert_array_equal(ref, jx)


class TestStridedFrames:
    """stride > encoded width (mp_image layouts; vf_HopperRender.c:446
    passes stride as frameWidth and the encoded width as actualWidth)."""

    def test_flow_with_padding(self):
        from mpv_frame_interpolator.io.synthetic import SyntheticConfig
        cfg = SyntheticConfig(width=64, height=48, stride=80)
        geom, off_ref, blur_ref, off_jax, blur_jax = _run_both(cfg, radius=7)
        assert geom.stride == 80 and geom.actual_width == 64
        np.testing.assert_array_equal(off_ref.astype(np.int32), off_jax)
        np.testing.assert_array_equal(blur_ref.astype(np.int32), blur_jax)


class TestDeviceMetrics:
    def test_psnr_device_matches_host(self):
        from mpv_frame_interpolator.ops.metrics import psnr_device
        from mpv_frame_interpolator.frame import psnr_arrays
        rng = np.random.default_rng(0)
        a = rng.integers(0, 255, (64, 64)).astype(np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-5, 5, a.shape), 0, 255).astype(np.uint8)
        host = psnr_arrays(a, b, 255)
        dev = float(psnr_device(jnp.asarray(a), jnp.asarray(b)))
        assert abs(host - dev) < 0.01
        assert float(psnr_device(jnp.asarray(a), jnp.asarray(a))) == 999.0


class TestWraparound:
    def test_delta_scalar_31_wraps_identically(self, small_cfg):
        """delta << 31 wraps mod 2^32 (the reference's uint shifts,
        calcDeltaSumsKernel.cl:99); oracle and JAX must wrap the same."""
        _, off_ref, _, off_jax, _ = _run_both(small_cfg, ds=31, nbs=31,
                                              radius=6)
        np.testing.assert_array_equal(off_ref.astype(np.int32), off_jax)


class TestPartialPyramid:
    """NUM_ITERATIONS knob (config.h:4): a nonzero value caps the pyramid
    depth (opticalFlowCalc.c:146-149)."""

    @pytest.mark.parametrize("num_iter", [1, 2, 3])
    def test_capped_iterations_exact(self, small_cfg, num_iter):
        f1, f2 = frame_pair(small_cfg, "gradient_pan")
        geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride,
                                   f1.fmt.width, num_iter_cfg=num_iter)
        assert geom.iterations == num_iter
        off_ref, blur_ref = oracle.calculate_optical_flow(
            f1.y, f1.uv, f2.y, f2.uv, search_radius=7,
            res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w,
            num_iter_cfg=num_iter)
        fn = make_flow_fn(geom, 7)
        off_jax, blur_jax = fn(*planar(f1), *planar(f2),
                               jnp.int32(8), jnp.int32(6))
        np.testing.assert_array_equal(off_ref.astype(np.int32),
                                      np.asarray(off_jax))
        np.testing.assert_array_equal(blur_ref.astype(np.int32),
                                      np.asarray(blur_jax))
