"""Backward playback (io/reverse.ReversedSource; mpv --play-direction
analog: demux.c backward cache = seek back a chunk, decode forward, emit
reversed)."""

import subprocess
import sys

import numpy as np
import pytest

from mpv_frame_interpolator.frame import FrameFormat, VideoFrame
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.cache import CachedSource
from mpv_frame_interpolator.io.reverse import ReversedSource, ReverseError
from mpv_frame_interpolator.io.y4m import Y4MReader, Y4MWriter


def write_y4m(path, n=20, w=64, h=48, fps=24.0):
    cfg = synthetic.SyntheticConfig(width=w, height=h, fps=fps)
    frames = list(synthetic.moving_box(cfg, n))
    with open(path, "wb") as fh:
        wtr = Y4MWriter(fh, w, h, fps)
        for f in frames:
            wtr.write(f)
    return frames


class TestReversedSource:
    def test_frames_reversed_bitexact(self, tmp_path):
        path = tmp_path / "in.y4m"
        orig = write_y4m(path, n=20)
        rev = list(ReversedSource(Y4MReader(open(path, "rb")), chunk=8))
        assert len(rev) == 20
        for f_rev, f_orig in zip(rev, reversed(orig)):
            np.testing.assert_array_equal(f_rev.y, f_orig.y)
            np.testing.assert_array_equal(f_rev.uv, f_orig.uv)

    def test_pts_fresh_forward_timeline(self, tmp_path):
        path = tmp_path / "in.y4m"
        orig = write_y4m(path, n=12)
        rev = list(ReversedSource(Y4MReader(open(path, "rb")), chunk=5))
        pts = [f.pts for f in rev]
        assert pts[0] == pytest.approx(0.0)
        assert all(b > a for a, b in zip(pts, pts[1:]))
        # intervals mirror the source's own
        dt = 1 / 24.0
        for a, b in zip(pts, pts[1:]):
            assert b - a == pytest.approx(dt, abs=1e-9)
        assert pts[-1] == pytest.approx(orig[-1].pts)

    def test_chunk_one_and_larger_than_stream(self, tmp_path):
        path = tmp_path / "in.y4m"
        orig = write_y4m(path, n=7)
        for chunk in (1, 64):
            rev = list(ReversedSource(Y4MReader(open(path, "rb")),
                                      chunk=chunk))
            assert len(rev) == 7
            np.testing.assert_array_equal(rev[0].y, orig[-1].y)
            np.testing.assert_array_equal(rev[-1].y, orig[0].y)

    def test_native_ring_source(self, tmp_path):
        """The C++ ring restarts per chunk and its pool absorbs the
        chunk-buffering consumer."""
        from mpv_frame_interpolator.io import ingest
        if not ingest.have_native_ingest():
            pytest.skip("native extension not built")
        path = tmp_path / "in.y4m"
        orig = write_y4m(path, n=20)
        src = ingest.NativeY4MSource(str(path))
        rev = list(ReversedSource(src, chunk=6))
        assert len(rev) == 20
        np.testing.assert_array_equal(rev[3].y, orig[16].y)
        src.close()

    def test_unseekable_rejected_cached_accepted(self):
        cfg = synthetic.SyntheticConfig(width=32, height=32)
        gen = synthetic.moving_box(cfg, 9)   # bare generator: no seek API
        with pytest.raises(ReverseError):
            ReversedSource(gen)
        cached = CachedSource(synthetic.moving_box(cfg, 9))
        rev = list(ReversedSource(cached, chunk=4))
        assert len(rev) == 9
        orig = list(synthetic.moving_box(cfg, 9))
        np.testing.assert_array_equal(rev[0].y, orig[-1].y)

    def test_not_seekable_itself(self, tmp_path):
        path = tmp_path / "in.y4m"
        write_y4m(path, n=5)
        rs = ReversedSource(Y4MReader(open(path, "rb")))
        assert rs.seekable() is False


class TestPipelineBackward:
    def test_cli_backward_roundtrip(self, tmp_path):
        """End-to-end: CLI with --play-direction=backward produces the
        outputs of the reversed stream (first output == last source)."""
        path = tmp_path / "in.y4m"
        out = tmp_path / "out.y4m"
        orig = write_y4m(path, n=8)
        r = subprocess.run(
            [sys.executable, "-m", "mpv_frame_interpolator", str(path),
             "--play-direction", "backward", "--untimed", "--no-resume",
             "--display-fps", "24", "--frames", "0", "-o", str(out)],
            capture_output=True, text=True, timeout=600,
            env=dict(__import__("os").environ))
        assert r.returncode == 0, r.stderr[-2000:]
        got = list(Y4MReader(open(out, "rb")))
        assert len(got) >= 7
        np.testing.assert_array_equal(got[0].y, orig[-1].y)
