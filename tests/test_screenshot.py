"""Screenshot subsystem: in-repo PNG codec (utils/png.py), YUV->RGB
conversion (io/convert.frame_to_rgb), PngDumpSink, and the Player
`screenshot` command (player/screenshot.c analog)."""

import numpy as np
import pytest

from mpv_frame_interpolator.frame import FrameFormat, VideoFrame
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.convert import frame_to_rgb, rgb_to_frame
from mpv_frame_interpolator.utils.png import (
    decode_png, encode_png, write_png)


class TestPngCodec:
    def test_gray_roundtrip(self):
        rng = np.random.default_rng(7)
        img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
        np.testing.assert_array_equal(decode_png(encode_png(img)), img)

    def test_rgb_roundtrip(self):
        rng = np.random.default_rng(8)
        img = rng.integers(0, 256, (24, 31, 3), dtype=np.uint8)
        np.testing.assert_array_equal(decode_png(encode_png(img)), img)

    def test_signature_and_chunks(self):
        data = encode_png(np.zeros((4, 4), np.uint8))
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert b"IHDR" in data and b"IDAT" in data and data[-8:-4] == b"IEND"

    def test_rejects_bad_input(self):
        with pytest.raises(ValueError):
            encode_png(np.zeros((4, 4), np.float32))
        with pytest.raises(ValueError):
            encode_png(np.zeros((4, 4, 2), np.uint8))

    def test_write_png(self, tmp_path):
        p = tmp_path / "x.png"
        write_png(str(p), np.full((8, 8), 200, np.uint8))
        assert decode_png(p.read_bytes())[0, 0] == 200


class TestFrameToRgb:
    def test_rgb_yuv_rgb_roundtrip_close(self):
        """Full-saturation primaries survive the 4:2:0 trip within the
        expected subsampling/limited-range error."""
        rgb = np.zeros((32, 48, 3), np.uint8)
        rgb[:16, :, 0] = 200     # top half reddish
        rgb[16:, :, 2] = 180     # bottom bluish
        rgb[:, 24:, 1] = 90
        back = frame_to_rgb(rgb_to_frame(rgb))
        # interior pixels (away from the chroma-block color edges)
        err = np.abs(back[4:12, 4:20].astype(int) - rgb[4:12, 4:20])
        assert err.max() <= 6, err.max()

    def test_gray_exact_scale(self):
        fmt = FrameFormat(16, 16, "nv12")
        f = VideoFrame(np.full((16, 16), 126, np.uint8),
                       np.full((8, 16), 128, np.uint8), fmt)
        rgb = frame_to_rgb(f)
        # Y=126 limited-range -> (126-16)*255/219 = 128.08 -> 128
        assert np.all(np.abs(rgb.astype(int) - 128) <= 1)

    def test_p010(self):
        fmt = FrameFormat(16, 16, "p010")
        f = VideoFrame(np.full((16, 16), 126 << 8, np.uint16),
                       np.full((8, 16), 128 << 8, np.uint16), fmt)
        rgb = frame_to_rgb(f)
        assert rgb.shape == (16, 16, 3) and rgb.dtype == np.uint8
        assert np.all(np.abs(rgb.astype(int) - 128) <= 1)

    def test_stride_cropped(self):
        fmt = FrameFormat(20, 16, "nv12", stride=32)
        f = VideoFrame(np.zeros((16, 32), np.uint8),
                       np.full((8, 32), 128, np.uint8), fmt)
        assert frame_to_rgb(f).shape == (16, 20, 3)


class TestScreenshotCommand:
    def _run_pipeline(self, tmp_path, n=6):
        from mpv_frame_interpolator.api import Player
        from mpv_frame_interpolator.io.sinks import NullSink
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        from mpv_frame_interpolator.pipeline.player import Pipeline
        cfg = synthetic.SyntheticConfig(width=64, height=48)
        engine = InterpolationEngine(EngineConfig(
            background_precompile=False, measure_timing=False))
        pipe = Pipeline(synthetic.moving_box(cfg, n), engine, NullSink(),
                        present=None)
        player = Player(engine=engine)
        player.bind_pipeline(pipe)
        pipe.run()
        return player

    def test_screenshot_writes_png(self, tmp_path):
        player = self._run_pipeline(tmp_path)
        path = str(tmp_path / "shot.png")
        assert player.command("screenshot", path) == path
        img = decode_png(open(path, "rb").read())
        assert img.shape == (48, 64, 3)

    def test_screenshot_before_any_frame(self):
        from mpv_frame_interpolator.api import Player, PropertyError
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        player = Player(engine=InterpolationEngine(EngineConfig(
            background_precompile=False)))
        with pytest.raises(PropertyError):
            player.command("screenshot")

    def test_png_dump_sink(self, tmp_path):
        import subprocess, sys, os
        out = tmp_path / "pngs"
        r = subprocess.run(
            [sys.executable, "-m", "mpv_frame_interpolator",
             "synthetic:moving_box", "--width", "64", "--height", "48",
             "--frames", "3", "--untimed", "--dump-png", str(out)],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ))
        assert r.returncode == 0, r.stderr[-2000:]
        files = sorted(out.glob("*.png"))
        assert len(files) >= 3
        img = decode_png(files[0].read_bytes())
        assert img.shape == (48, 64, 3)
