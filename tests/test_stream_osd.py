"""Network stream backends (stream/stream_* analog) + OSD overlay."""

import socket
import threading

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic, sinks
from mpv_frame_interpolator.io.stream import (
    is_stream_url, open_stream)
from mpv_frame_interpolator.io.y4m import Y4MReader, Y4MWriter


def serve_y4m_over(sock_factory, frames, w, h):
    """Accept one client and stream frames as y4m."""
    server = sock_factory()

    def serve():
        conn, _ = server.accept()
        fh = conn.makefile("wb")
        wtr = Y4MWriter(fh, w, h, 24.0)
        for f in frames:
            wtr.write(f)
        fh.flush()
        fh.close()
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return server, t


class TestStreamBackends:
    def test_is_stream_url(self):
        assert is_stream_url("tcp://1.2.3.4:5")
        assert is_stream_url("unix:///tmp/s.sock")
        assert not is_stream_url("/path/file.y4m")

    def test_tcp_y4m_stream(self, small_cfg):
        frames = list(synthetic.moving_box(small_cfg, 4))
        server = socket.socket()
        server.bind(("127.0.0.1", 0))
        server.listen(1)
        port = server.getsockname()[1]
        _, t = serve_y4m_over(lambda: server, frames, 64, 48)
        rdr = Y4MReader(open_stream(f"tcp://127.0.0.1:{port}"))
        got = list(rdr)
        assert len(got) == 4
        np.testing.assert_array_equal(got[2].y, frames[2].y)
        t.join(timeout=5)

    def test_unix_y4m_stream(self, small_cfg, tmp_path):
        frames = list(synthetic.moving_box(small_cfg, 3))
        path = str(tmp_path / "dec.sock")
        server = socket.socket(socket.AF_UNIX)
        server.bind(path)
        server.listen(1)
        _, t = serve_y4m_over(lambda: server, frames, 64, 48)
        rdr = Y4MReader(open_stream(f"unix://{path}"))
        assert len(list(rdr)) == 3
        t.join(timeout=5)

    def test_bad_scheme(self):
        with pytest.raises(ValueError):
            open_stream("ftp://x/y")


class TestOsd:
    def test_draw_text_marks_plane(self):
        from mpv_frame_interpolator.utils.osd import draw_text
        y = np.full((64, 128), 100, np.uint8)
        draw_text(y, "R5 ACTIVE 1.23MS", scale=1)
        assert (y == 235).any() and (y == 16).any()     # fg + bg drawn
        assert (y[32:] == 100).all()                    # only the box area

    def test_draw_text_p010_values(self):
        from mpv_frame_interpolator.utils.osd import draw_text
        y = np.full((64, 128), 100 << 8, np.uint16)
        draw_text(y, "0123", scale=1)
        assert (y == (235 << 8)).any()

    def test_out_of_bounds_noop(self):
        from mpv_frame_interpolator.utils.osd import draw_text
        y = np.full((10, 10), 50, np.uint8)
        draw_text(y, "TOOLONGTEXT", scale=4)
        assert (y == 50).all()

    def test_osd_sink_end_to_end(self, small_cfg):
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        eng = InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False, measure_timing=True,
            background_precompile=False))

        class Capture:
            def __init__(self):
                self.frames = []

            def write(self, out):
                self.frames.append(out)

            def close(self):
                pass

        cap = Capture()
        osd = sinks.OsdSink(cap, eng)
        for f in synthetic.moving_box(small_cfg, 3):
            for out in eng.push(f):
                osd.write(out)
        assert len(cap.frames) >= 3
        y = cap.frames[-1].device_planes()[0]
        assert (np.asarray(y)[:20, :60] == 235).any()   # overlay burned in
