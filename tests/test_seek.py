"""Seek: O(1) source repositioning + pipeline/Player seek command.

Matches the reference's seek path (player/playloop.c:1294
execute_queued_seek -> demux_seek + reset_video_state player/video.c:98 +
the filter's own reset vf_HopperRender.c:562-567): the demuxer repositions
in O(1) (y4m/raw frames are fixed-size records), the prefetch queue is
flushed, and the engine + present clock re-anchor on the next two frames.
"""

import io
import threading

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.y4m import (
    RawYUVReader, Y4MReader, Y4MWriter, Y4MError)
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator.pipeline.player import Pipeline


def small_y4m(n=20, w=16, h=16, fps=24.0):
    cfg = synthetic.SyntheticConfig(width=w, height=h, fps=fps)
    buf = io.BytesIO()
    wtr = Y4MWriter(buf, w, h, fps)
    for f in synthetic.moving_box(cfg, n):
        wtr.write(f)
    buf.seek(0)
    return buf


def eng():
    return InterpolationEngine(EngineConfig(
        scene_detection=False, auto_quality=False, measure_timing=False))


class TestReaderSeek:
    def test_seek_frame_o1(self):
        rdr = Y4MReader(small_y4m(50))
        assert rdr.seekable()
        assert rdr.n_frames() == 50
        rdr.seek_frame(40)
        frames = list(rdr)
        assert len(frames) == 10
        assert frames[0].pts == pytest.approx(40 / 24.0)

    def test_seek_pts_and_backwards(self):
        rdr = Y4MReader(small_y4m(30))
        first = next(iter(rdr))
        assert first.pts == 0.0
        actual = rdr.seek_pts(20 / 24.0)
        assert actual == pytest.approx(20 / 24.0)
        f = next(iter(rdr))
        assert f.pts == pytest.approx(20 / 24.0)
        # backwards
        rdr.seek_pts(0.0)
        f0 = next(iter(rdr))
        assert f0.pts == 0.0
        np.testing.assert_array_equal(f0.y, first.y)

    def test_seek_past_eof_yields_nothing(self):
        rdr = Y4MReader(small_y4m(10))
        rdr.seek_frame(500)
        assert list(rdr) == []

    def test_variable_marker_fallback(self):
        """Streams with variable-length FRAME lines defeat the byte
        arithmetic; the linear-scan fallback must still land correctly."""
        base = small_y4m(8, w=8, h=8)
        data = base.getvalue()
        header_end = data.index(b"\n") + 1
        payload = 8 * 8 + 2 * 4 * 4
        # rebuild with an interpretation-parameter FRAME line on frame 2
        out = bytearray(data[:header_end])
        pos = header_end
        idx = 0
        while pos < len(data):
            marker_end = data.index(b"\n", pos) + 1
            out += b"FRAME Ip\n" if idx == 2 else data[pos:marker_end]
            out += data[marker_end:marker_end + payload]
            pos = marker_end + payload
            idx += 1
        rdr = Y4MReader(io.BytesIO(bytes(out)))
        rdr.seek_frame(5)
        frames = list(rdr)
        assert len(frames) == 3
        assert frames[0].pts == pytest.approx(5 / 24.0)

    def test_raw_reader_seek(self):
        cfg = synthetic.SyntheticConfig(width=16, height=16, fps=24.0)
        buf = io.BytesIO()
        for f in synthetic.moving_box(cfg, 12):
            u, v = f.uv[:, 0::2], f.uv[:, 1::2]
            buf.write(f.y.tobytes())
            buf.write(np.ascontiguousarray(u).tobytes())
            buf.write(np.ascontiguousarray(v).tobytes())
        buf.seek(0)
        rdr = RawYUVReader(buf, 16, 16, 24.0)
        assert rdr.n_frames() == 12
        rdr.seek_pts(8 / 24.0)
        frames = list(rdr)
        assert len(frames) == 4
        assert frames[0].pts == pytest.approx(8 / 24.0)

    def test_unseekable_raises(self):
        class NoSeek(io.RawIOBase):
            def __init__(self, data):
                self._b = io.BytesIO(data)

            def readinto(self, b):
                return self._b.readinto(b)

            def readable(self):
                return True

            def seekable(self):
                return False

        rdr = Y4MReader(io.BufferedReader(NoSeek(small_y4m(4).getvalue())))
        assert not rdr.seekable()
        with pytest.raises(Y4MError):
            rdr.seek_frame(2)


class _PtsSink:
    """Sink that triggers a queued pipeline seek after `trigger_at` writes."""

    def __init__(self, pipe_ref, seek_to=None, trigger_at=None):
        self.pts = []
        self._pipe_ref = pipe_ref
        self._seek_to = seek_to
        self._trigger_at = trigger_at

    def write(self, out):
        self.pts.append(out.pts)
        if (self._trigger_at is not None
                and len(self.pts) == self._trigger_at):
            self._pipe_ref[0].seek(self._seek_to)

    def close(self):
        pass


class TestPipelineSeek:
    def _run(self, n_frames, seek_to, trigger_at):
        rdr = Y4MReader(small_y4m(n_frames))
        pipe_ref = [None]
        sink = _PtsSink(pipe_ref, seek_to=seek_to, trigger_at=trigger_at)
        pipe = Pipeline(rdr, eng(), sink, present=None, stage_uploads=False)
        pipe_ref[0] = pipe
        pipe.run()
        return pipe, sink

    def test_seek_forward_mid_pair(self):
        """The seek lands at the next source-frame boundary: the current
        pair's remaining outputs flush, then the timeline restarts at the
        target."""
        pipe, sink = self._run(24, seek_to=16 / 24.0, trigger_at=5)
        assert pipe.seeks == 1
        jump = next(i for i, p in enumerate(sink.pts)
                    if p >= 16 / 24.0 - 1e-6)
        assert jump - 5 <= 4            # only the current plan's leftovers
        assert (np.diff(sink.pts[jump:]) > 0).all()

    def test_seek_backwards(self):
        pipe, sink = self._run(16, seek_to=0.0, trigger_at=8)
        assert pipe.seeks == 1
        drops = np.where(np.diff(sink.pts) < 0)[0]
        assert len(drops) == 1          # exactly one backwards pts jump
        j = int(drops[0]) + 1
        assert sink.pts[j] <= 2 / 24.0  # replay restarts near 0
        assert (np.diff(sink.pts[j:]) > 0).all()
        assert len(sink.pts) - j > 8

    def test_seek_unseekable_source_degrades_to_reset(self, small_cfg):
        frames = list(synthetic.moving_box(small_cfg, 8))
        pipe_ref = [None]
        sink = _PtsSink(pipe_ref, seek_to=0.1, trigger_at=3)
        pipe = Pipeline(iter(frames), eng(), sink, present=None,
                        stage_uploads=False)
        pipe_ref[0] = pipe
        pipe.run()
        assert pipe.seeks == 0           # no source seek happened
        assert len(sink.pts) > 3         # playback continued


class TestPlayerSeekCommand:
    def test_command_routes_to_pipeline(self):
        from mpv_frame_interpolator.api import Player
        rdr = Y4MReader(small_y4m(24))
        engine = eng()
        pipe_ref = [None]
        sink = _PtsSink(pipe_ref)
        pipe = Pipeline(rdr, engine, sink, present=None, stage_uploads=False)
        pipe_ref[0] = pipe
        player = Player(engine=engine)
        player.bind_pipeline(pipe)
        player.command("seek", 12 / 24.0)   # queued before run
        pipe.run()
        assert pipe.seeks == 1
        assert sink.pts[1] >= 12 / 24.0 - 1e-6

    def test_command_without_pipeline_errors(self):
        from mpv_frame_interpolator.api import Player, PropertyError
        player = Player(engine=eng())
        with pytest.raises(PropertyError):
            player.command("seek", 1.0)


class TestLoopAndEnd:
    def test_end_stops_early(self):
        rdr = Y4MReader(small_y4m(24))
        pipe_ref = [None]
        sink = _PtsSink(pipe_ref)
        pipe = Pipeline(rdr, eng(), sink, present=None, stage_uploads=False)
        pipe.end_pts = 10 / 24.0
        pipe.run()
        # sources beyond end are never consumed; the last included pair's
        # outputs extend at most one source interval past end
        assert pipe.frames_in <= 11
        assert max(sink.pts) <= 11 / 24.0 + 1e-9

    def test_loop_replays(self):
        rdr = Y4MReader(small_y4m(8))
        pipe_ref = [None]
        sink = _PtsSink(pipe_ref)
        pipe = Pipeline(rdr, eng(), sink, present=None, stage_uploads=False)
        pipe.loop = 2                      # 3 total plays
        pipe.run()
        drops = np.where(np.diff(sink.pts) < 0)[0]
        assert len(drops) == 2             # two wrap-arounds
        assert pipe.seeks == 2
        assert pipe.frames_in == 24

    def test_loop_with_end(self):
        rdr = Y4MReader(small_y4m(24))
        pipe_ref = [None]
        sink = _PtsSink(pipe_ref)
        pipe = Pipeline(rdr, eng(), sink, present=None, stage_uploads=False)
        pipe.loop = 5
        pipe.end_pts = 6 / 24.0            # --end beats --loop (mpv too)
        pipe.run()
        assert pipe.seeks == 0
        assert max(sink.pts) <= 7 / 24.0 + 1e-9
