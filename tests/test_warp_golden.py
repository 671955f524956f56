"""Golden tests: JAX warp must match the NumPy oracle for every output mode."""

import numpy as np
import pytest
import jax.numpy as jnp

from mpv_frame_interpolator.ops import oracle
from mpv_frame_interpolator.ops.flow import FlowGeometry, make_flow_fn
from mpv_frame_interpolator.ops.warp import make_warp_fn
from mpv_frame_interpolator.frame import interleave_chroma

from conftest import frame_pair, planar


def _setup(cfg, source="moving_box", radius=8, **kw):
    f1, f2 = frame_pair(cfg, source, **kw)
    geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride, f1.fmt.width)
    _, blur_ref = oracle.calculate_optical_flow(
        f1.y, f1.uv, f2.y, f2.uv, search_radius=radius,
        res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
    return f1, f2, geom, blur_ref


def _compare(f1, f2, geom, blur, mode, t, black=0.0, white=255.0,
             exact=True):
    ref_y, ref_uv = oracle.warp_frame(
        f1.y, f1.uv, f2.y, f2.uv, blur, t, mode,
        geom.res_scalar, geom.actual_width, black, white)

    fn = make_warp_fn(geom, mode)
    y1, u1, v1 = planar(f1)
    y2, u2, v2 = planar(f2)
    jy, ju, jv = fn(jnp.asarray(y1), jnp.asarray(u1), jnp.asarray(v1),
                    jnp.asarray(y2), jnp.asarray(u2), jnp.asarray(v2),
                    jnp.asarray(blur.astype(np.int32)),
                    jnp.float32(t), jnp.float32(black), jnp.float32(white))
    jy = np.asarray(jy)
    juv = interleave_chroma(np.asarray(ju), np.asarray(jv))

    wa = geom.actual_width
    ry, ruv = ref_y[:, :wa], ref_uv[:, :wa]
    if exact:
        np.testing.assert_array_equal(ry, jy)
        np.testing.assert_array_equal(ruv, juv)
    else:
        # HSV mode: atan2/float ulp differences may move hue sector edges
        for a, b in ((ry.astype(int), jy.astype(int)),
                     (ruv.astype(int), juv.astype(int))):
            frac_diff = np.mean(np.abs(a - b) > 2)
            assert frac_diff < 0.005, f"{frac_diff=}"


MODES_EXACT = [oracle.WARPED_FRAME_12, oracle.WARPED_FRAME_21,
               oracle.BLENDED_FRAME, oracle.GREY_FLOW,
               oracle.SIDE_BY_SIDE_1, oracle.SIDE_BY_SIDE_2]


class TestWarpGolden:
    @pytest.mark.parametrize("mode", MODES_EXACT)
    def test_modes_exact(self, small_cfg, mode):
        f1, f2, geom, blur = _setup(small_cfg)
        _compare(f1, f2, geom, blur, mode, 0.4)

    @pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 0.9999])
    def test_blend_positions(self, small_cfg, t):
        f1, f2, geom, blur = _setup(small_cfg, "gradient_pan")
        _compare(f1, f2, geom, blur, oracle.BLENDED_FRAME, t)

    def test_levels(self, small_cfg):
        f1, f2, geom, blur = _setup(small_cfg)
        _compare(f1, f2, geom, blur, oracle.BLENDED_FRAME, 0.3,
                 black=16.0, white=219.0)

    def test_hsv_flow_near_exact(self, small_cfg):
        f1, f2, geom, blur = _setup(small_cfg, "gradient_pan")
        _compare(f1, f2, geom, blur, oracle.HSV_FLOW, 0.5, exact=False)

    def test_pyramid_geometry(self, pyramid_cfg):
        f1, f2, geom, blur = _setup(pyramid_cfg, "gradient_pan", radius=6)
        _compare(f1, f2, geom, blur, oracle.BLENDED_FRAME, 0.6)


class TestStridedWarp:
    def test_warp_with_padding(self):
        from mpv_frame_interpolator.io.synthetic import SyntheticConfig
        cfg = SyntheticConfig(width=64, height=48, stride=80)
        f1, f2, geom, blur = _setup(cfg)
        assert geom.stride == 80 and geom.actual_width == 64
        _compare(f1, f2, geom, blur, oracle.BLENDED_FRAME, 0.35)


class TestPyramidAllModes:
    @pytest.mark.parametrize("mode", MODES_EXACT)
    def test_modes_exact_pyramid(self, pyramid_cfg, mode):
        f1, f2, geom, blur = _setup(pyramid_cfg, "gradient_pan", radius=5)
        assert geom.res_scalar >= 1
        _compare(f1, f2, geom, blur, mode, 0.55)


class TestRandomizedParity:
    """Randomized sweep: oracle vs JAX across random geometry/params."""

    @pytest.mark.parametrize("seed", range(6))
    def test_random_config(self, seed):
        import random
        from mpv_frame_interpolator.io.synthetic import SyntheticConfig
        rng = random.Random(seed)
        w = rng.choice([32, 48, 64, 96])
        h = rng.choice([32, 48, 64])
        stride = w + rng.choice([0, 16])
        cfg = SyntheticConfig(width=w, height=h, stride=stride,
                              seed=1000 + seed)
        src = rng.choice(["moving_box", "gradient_pan", "noise"])
        radius = rng.randint(5, 16)
        ds = rng.randint(0, 12)
        nbs = rng.randint(0, 10)
        mode = rng.choice(MODES_EXACT)
        t = rng.random()
        black = float(rng.randint(0, 32))
        white = float(rng.randint(200, 255))

        f1, f2 = frame_pair(cfg, src)
        geom = FlowGeometry.create(h, stride, w)
        off_ref, blur_ref = oracle.calculate_optical_flow(
            f1.y, f1.uv, f2.y, f2.uv, search_radius=radius,
            res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w,
            delta_scalar=ds, neighbor_bias_scalar=nbs)
        fn = make_flow_fn(geom, radius)
        a = [jnp.asarray(x) for x in (*planar(f1), *planar(f2))]
        off_jax, blur_jax = fn(*a, jnp.int32(ds), jnp.int32(nbs))
        np.testing.assert_array_equal(off_ref.astype(np.int32),
                                      np.asarray(off_jax),
                                      err_msg=f"flow seed={seed}")
        _compare(f1, f2, geom, blur_ref, mode, t, black, white)


class TestLevelsEdgeCases:
    def test_degenerate_white_equals_black(self, small_cfg):
        """white == black would divide by zero in the reference's float
        formula; the integer path clamps the denominator to 1."""
        f1, f2, geom, blur = _setup(small_cfg)
        fn = make_warp_fn(geom, oracle.BLENDED_FRAME)
        y1, u1, v1 = planar(f1)
        y2, u2, v2 = planar(f2)
        jy, ju, jv = fn(jnp.asarray(y1), jnp.asarray(u1), jnp.asarray(v1),
                        jnp.asarray(y2), jnp.asarray(u2), jnp.asarray(v2),
                        jnp.asarray(blur.astype(np.int32)),
                        jnp.float32(0.5), jnp.float32(128.0),
                        jnp.float32(128.0))
        out = np.asarray(jy)
        assert out.min() >= 0 and out.max() <= 255  # no NaN/garbage

    def test_extreme_levels(self, small_cfg):
        f1, f2, geom, blur = _setup(small_cfg)
        _compare(f1, f2, geom, blur, oracle.BLENDED_FRAME, 0.5,
                 black=0.0, white=1.0)
        _compare(f1, f2, geom, blur, oracle.BLENDED_FRAME, 0.5,
                 black=254.0, white=255.0)
