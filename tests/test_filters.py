"""Host-side user filter chain (--vf analog)."""

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.filters import (
    parse_chain, apply_chain, crop, vflip, hflip, rotate, fps)
from mpv_frame_interpolator.frame import split_chroma


def frames(n=3, **kw):
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0, **kw)
    return list(synthetic.moving_box(cfg, n))


class TestFilters:
    def test_crop(self):
        f = crop(32, 16, 8, 4)(frames(1)[0])
        assert f.fmt.width == 32 and f.fmt.height == 16
        assert f.uv.shape == (8, 32)

    def test_crop_rejects_odd(self):
        with pytest.raises(ValueError):
            crop(33, 16)

    def test_vflip_hflip_roundtrip(self):
        f0 = frames(1)[0]
        f = vflip()(vflip()(f0))
        np.testing.assert_array_equal(f0.y, f.y)
        np.testing.assert_array_equal(f0.uv, f.uv)
        g = hflip()(hflip()(f0))
        np.testing.assert_array_equal(f0.y, g.y)

    def test_rotate_dims(self):
        f = rotate(90)(frames(1)[0])
        assert (f.fmt.width, f.fmt.height) == (48, 64)
        f2 = rotate(180)(frames(1)[0])
        assert (f2.fmt.width, f2.fmt.height) == (64, 48)

    def test_fps_conversion(self):
        src = frames(6)     # 24 fps
        out = list(apply_chain([fps(12.0)], src))
        assert len(out) == 3
        assert all(abs(f.nominal_fps - 12.0) < 1e-9 for f in out)
        out2 = list(apply_chain([fps(48.0)], frames(4)))
        assert len(out2) == 7   # duplicated up (last frame emits once)

    def test_parse_chain_and_compose(self):
        chain = parse_chain("crop=32:16,vflip,setpts=1.5")
        out = list(apply_chain(chain, frames(2)))
        assert out[0].fmt.width == 32
        assert out[0].pts == pytest.approx(1.5)
        with pytest.raises(ValueError):
            parse_chain("bogus=1")

    def test_engine_consumes_filtered(self):
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        chain = parse_chain("crop=32:32,hflip")
        e = InterpolationEngine(EngineConfig(scene_detection=False,
                                             auto_quality=False,
                                             measure_timing=False))
        outs = []
        for f in apply_chain(chain, frames(3)):
            outs.extend(e.push(f))
        assert len(outs) == 6
        assert outs[-1].fmt.width == 32


class TestFiltersP010:
    def test_filters_on_p010(self):
        """Filter chain is dtype-agnostic (rotate/flip/crop on uint16)."""
        cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                        pixfmt="p010")
        f = frames(1)[0]  # nv12 baseline for shape reference
        f16 = next(iter(synthetic.moving_box(cfg, 1)))
        out = rotate(90)(vflip()(crop(32, 16, 8, 4)(f16)))
        assert out.y.dtype.itemsize == 2
        assert (out.fmt.width, out.fmt.height) == (16, 32)


class TestScale:
    def test_downscale_geometry_and_content(self, small_cfg):
        from mpv_frame_interpolator.io.filters import scale
        import numpy as np
        f = next(iter(synthetic.moving_box(small_cfg, 1)))
        out = scale(32, 24)(f)
        assert (out.fmt.width, out.fmt.height) == (32, 24)
        assert out.uv.shape == (12, 32)
        # mean brightness is preserved by a resize
        assert abs(float(out.y.mean()) - float(f.y.mean())) < 3.0

    def test_upscale_identity_on_flat(self, small_cfg):
        from mpv_frame_interpolator.io.filters import scale
        import numpy as np
        from mpv_frame_interpolator.frame import FrameFormat, VideoFrame
        fmt = FrameFormat(16, 16)
        f = VideoFrame(np.full((16, 16), 77, np.uint8),
                       np.full((8, 16), 128, np.uint8), fmt)
        out = scale(64, 64)(f)
        assert (out.y == 77).all() and (out.uv == 128).all()

    def test_keep_aspect(self, small_cfg):
        from mpv_frame_interpolator.io.filters import scale
        f = next(iter(synthetic.moving_box(small_cfg, 1)))   # 64x48
        out = scale(32, -2)(f)
        assert (out.fmt.width, out.fmt.height) == (32, 24)

    def test_parse_chain_scale(self):
        from mpv_frame_interpolator.io.filters import parse_chain
        assert len(parse_chain("scale=128:96")) == 1

    def test_odd_geometry_rejected(self):
        from mpv_frame_interpolator.io.filters import scale
        import pytest
        with pytest.raises(ValueError):
            scale(33, 24)


class TestDeinterlace:
    def test_bob_doubles_rate_and_preserves_fields(self, small_cfg):
        from mpv_frame_interpolator.io.filters import deinterlace
        import numpy as np
        f = next(iter(synthetic.moving_box(small_cfg, 1)))
        out = deinterlace("bob")(f)
        assert len(out) == 2
        top, bottom = out
        np.testing.assert_array_equal(top.y[0::2], f.y[0::2])
        np.testing.assert_array_equal(bottom.y[1::2], f.y[1::2])
        assert top.pts == f.pts
        assert bottom.pts > top.pts
        assert top.nominal_fps == f.nominal_fps * 2
        assert top.fmt.height == f.fmt.height

    def test_weave_passthrough(self, small_cfg):
        from mpv_frame_interpolator.io.filters import deinterlace
        f = next(iter(synthetic.moving_box(small_cfg, 1)))
        assert deinterlace("weave")(f) is f

    def test_chain_through_pipeline(self, small_cfg):
        from mpv_frame_interpolator.io.filters import (apply_chain,
                                                           parse_chain)
        frames = list(synthetic.moving_box(small_cfg, 4))
        chain = parse_chain("deinterlace=bob,scale=32:24")
        out = list(apply_chain(chain, iter(frames)))
        assert len(out) == 8
        assert out[0].fmt.width == 32
