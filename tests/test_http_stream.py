"""http(s) stream backend (VERDICT r2 missing #3).

Reference analog: stream/stream_lavf.c serves network URLs; its http
backend seeks by reconnecting with a byte offset.  The rebuild's
io/stream.py does the same: HttpFile issues `Range: bytes=<pos>-` on
seek, the container demuxers ride it unmodified, and rangeless servers
fall back to the streaming + spool-cache path.

Tests run against a local stdlib http server (zero-egress sandbox): one
handler with real Range support, one deliberately without.
"""

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.mkv import MKVReader
from mpv_frame_interpolator.io.stream import (
    HttpFile, is_stream_url, open_http_file, open_stream, supports_ranges)

from tests.test_mkv import build_mkv


class _Handler(BaseHTTPRequestHandler):
    """Serves self.server.payload with byte-range support."""
    ranges = True

    def log_message(self, *a):   # quiet
        pass

    def _common(self, head=False):
        data = self.server.payload
        rng = self.headers.get("Range")
        if rng and self.ranges:
            spec = rng.split("=", 1)[1]
            lo_s, _, hi_s = spec.partition("-")
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else len(data) - 1
            body = data[lo:hi + 1]
            self.send_response(206)
            self.send_header("Content-Range",
                             f"bytes {lo}-{hi}/{len(data)}")
        else:
            body = data
            self.send_response(200)
        if self.ranges:
            self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if not head:
            self.wfile.write(body)

    def do_GET(self):
        self._common()

    def do_HEAD(self):
        self._common(head=True)


class _NoRangeHandler(_Handler):
    ranges = False


@pytest.fixture()
def serve():
    servers = []

    def start(payload: bytes, handler=_Handler):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        srv.payload = payload
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}"

    yield start
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def test_is_stream_url():
    assert is_stream_url("http://h/x.y4m")
    assert is_stream_url("https://h/x.mkv")
    assert not is_stream_url("file.y4m")


def test_httpfile_read_seek(serve):
    data = bytes(range(256)) * 64
    url = serve(data) + "/blob.bin"
    fh = HttpFile(url)
    assert fh.read(16) == data[:16]
    assert fh.tell() == 16
    fh.seek(1000)
    assert fh.read(8) == data[1000:1008]
    fh.seek(-4, 2)
    assert fh.read() == data[-4:]
    assert fh.read(10) == b""
    fh.seek(0)
    assert fh.read(4) == data[:4]
    fh.close()


def test_httpfile_rejects_rangeless(serve):
    url = serve(b"xyz", _NoRangeHandler) + "/b"
    assert not supports_ranges(url)
    assert open_http_file(url) is None
    with pytest.raises(ValueError):
        HttpFile(url)


def test_mkv_over_http_plays_and_seeks(serve, small_cfg):
    frames = list(synthetic.moving_box(small_cfg, 7))
    data = build_mkv(frames, small_cfg.width, small_cfg.height)
    url = serve(data) + "/clip.mkv"
    rdr = MKVReader(HttpFile(url))
    assert rdr.width == small_cfg.width
    got = [f for f in rdr]
    assert len(got) == 7
    np.testing.assert_array_equal(got[3].y, frames[3].y)
    # O(1) pts seek straight over byte ranges
    pts = rdr.seek_pts(5 / 24.0)
    nxt = next(iter(rdr))
    assert abs(nxt.pts - pts) < 1e-6
    np.testing.assert_array_equal(nxt.y, frames[5].y)


def test_y4m_over_http_streams(serve, small_cfg, tmp_path):
    import io

    from mpv_frame_interpolator.io.y4m import Y4MReader, Y4MWriter
    buf = io.BytesIO()
    w = Y4MWriter(buf, small_cfg.width, small_cfg.height, 24.0)
    frames = list(synthetic.moving_box(small_cfg, 5))
    for f in frames:
        w.write(f)
    url = serve(buf.getvalue(), _NoRangeHandler) + "/clip.y4m"
    rdr = Y4MReader(open_stream(url))
    got = list(rdr)
    assert len(got) == 5
    np.testing.assert_array_equal(got[2].y, frames[2].y)
