"""Format conversion (autoconvert analog) tests."""

import numpy as np

from mpv_frame_interpolator.frame import NV12, P010
from mpv_frame_interpolator.io import convert, synthetic


class TestConvert:
    def test_bit_depth_roundtrip(self, small_cfg):
        f8 = next(iter(synthetic.moving_box(small_cfg, 1)))
        f16 = convert.convert_frame(f8, P010)
        assert f16.fmt.pixfmt == P010 and f16.y.dtype == np.uint16
        back = convert.convert_frame(f16, NV12)
        np.testing.assert_array_equal(back.y, f8.y)
        np.testing.assert_array_equal(back.uv, f8.uv)
        # no-op conversion returns the same frame
        assert convert.autoconvert(f8, NV12) is f8

    def test_i420_to_frame(self):
        rng = np.random.default_rng(0)
        y = rng.integers(0, 255, (48, 64)).astype(np.uint8)
        u = rng.integers(0, 255, (24, 32)).astype(np.uint8)
        v = rng.integers(0, 255, (24, 32)).astype(np.uint8)
        f = convert.i420_to_frame(y, u, v, pts=1.5, nominal_fps=25.0)
        np.testing.assert_array_equal(f.y, y)
        np.testing.assert_array_equal(f.uv[:, 0::2], u)
        np.testing.assert_array_equal(f.uv[:, 1::2], v)
        assert f.pts == 1.5 and f.nominal_fps == 25.0

    def test_rgb_grey_is_neutral_chroma(self):
        rgb = np.full((32, 32, 3), 128, np.uint8)
        f = convert.rgb_to_frame(rgb)
        # grey input -> chroma at 128, luma mid-range
        assert np.all(np.abs(f.uv.astype(int) - 128) <= 1)
        assert 100 < f.y.mean() < 140

    def test_rgb_primaries_chroma_direction(self):
        red = convert.rgb_to_frame(np.full((16, 16, 3), (255, 0, 0), np.uint8))
        blue = convert.rgb_to_frame(np.full((16, 16, 3), (0, 0, 255), np.uint8))
        # V (Cr) high for red, U (Cb) high for blue
        assert red.uv[:, 1::2].mean() > 200
        assert blue.uv[:, 0::2].mean() > 200


class TestAutoconvertScaling:
    def test_rescale_leg(self, small_cfg):
        import numpy as np
        from mpv_frame_interpolator.io import synthetic
        from mpv_frame_interpolator.io.convert import autoconvert
        f = next(iter(synthetic.moving_box(small_cfg, 1)))
        out = autoconvert(f, "nv12", want_width=32, want_height=24)
        assert (out.fmt.width, out.fmt.height) == (32, 24)
        out2 = autoconvert(f, "p010", want_width=32, want_height=24)
        assert out2.fmt.pixfmt == "p010" and out2.y.dtype == np.uint16

    def test_noop_when_matching(self, small_cfg):
        from mpv_frame_interpolator.io import synthetic
        from mpv_frame_interpolator.io.convert import autoconvert
        f = next(iter(synthetic.moving_box(small_cfg, 1)))
        assert autoconvert(f, "nv12") is f
        assert autoconvert(f, "nv12", want_width=64, want_height=48) is f
