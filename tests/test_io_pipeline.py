"""IO round-trips, present clock, pipeline orchestration, applet protocol."""

import io
import os

import numpy as np
import pytest

from mpv_frame_interpolator.frame import NV12, P010
from mpv_frame_interpolator.io import synthetic, sinks
from mpv_frame_interpolator.io.y4m import Y4MReader, Y4MWriter, RawYUVReader
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator.pipeline.player import Pipeline
from mpv_frame_interpolator.pipeline.present import PresentClock
from mpv_frame_interpolator.control.applet import (
    apply_command_code, telemetry_text)
from mpv_frame_interpolator.pipeline.cadence import InterpolationState


def eng(**kw):
    kw.setdefault("scene_detection", False)
    kw.setdefault("auto_quality", False)
    kw.setdefault("measure_timing", False)
    return InterpolationEngine(EngineConfig(**kw))


class TestY4M:
    def test_roundtrip_nv12(self, small_cfg):
        frames = list(synthetic.moving_box(small_cfg, 3))
        buf = io.BytesIO()
        w = Y4MWriter(buf, 64, 48, 24.0)
        for f in frames:
            w.write(f)
        buf.seek(0)
        rdr = Y4MReader(buf)
        back = list(rdr)
        assert rdr.fps == pytest.approx(24.0)
        assert len(back) == 3
        for a, b in zip(frames, back):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.uv, b.uv)

    def test_roundtrip_p010(self):
        cfg = synthetic.SyntheticConfig(width=64, height=48, fps=30.0,
                                        pixfmt=P010)
        frames = list(synthetic.moving_box(cfg, 2))
        buf = io.BytesIO()
        w = Y4MWriter(buf, 64, 48, 30.0, P010)
        for f in frames:
            w.write(f)
        buf.seek(0)
        back = list(Y4MReader(buf))
        assert back[0].fmt.pixfmt == P010
        # 10-bit payload preserved through the <<6 / >>6 transport
        np.testing.assert_array_equal(frames[0].y >> 6 << 6, back[0].y >> 0
                                      if False else back[0].y)

    def test_raw_reader(self, small_cfg, tmp_path):
        frames = list(synthetic.moving_box(small_cfg, 2))
        path = tmp_path / "raw.yuv"
        with open(path, "wb") as fh:
            for f in frames:
                u, v = f.uv[:, 0::2], f.uv[:, 1::2]
                fh.write(f.y.tobytes())
                fh.write(np.ascontiguousarray(u).tobytes())
                fh.write(np.ascontiguousarray(v).tobytes())
        back = list(RawYUVReader(open(path, "rb"), 64, 48, 24.0))
        assert len(back) == 2
        np.testing.assert_array_equal(frames[1].y, back[1].y)


class TestPresentClock:
    def test_untimed_never_sleeps(self):
        pc = PresentClock(60.0, untimed=True)
        infos = [pc.present(i / 60) for i in range(50)]
        assert pc.drops == 0
        assert [i.vsync_index for i in infos] == list(range(50))

    def test_num_vsyncs_display_sync(self):
        pc = PresentClock(60.0, untimed=True)
        pc.present(0.0)
        info = pc.present(1 / 30)   # 2-vsync frame duration
        assert info.num_vsyncs == 2

    def test_estimated_fps(self):
        pc = PresentClock(240.0)   # fast enough to actually pace in a test
        for i in range(30):
            pc.present(i / 240)
        est = pc.estimated_display_fps()
        # wide bounds: the 1-core CI host can overshoot sleeps under load
        assert 30 < est < 400


class TestPipeline:
    def test_run_with_present_and_sink(self, small_cfg):
        src = synthetic.moving_box(small_cfg, 5)
        sink = sinks.NullSink()
        pipe = Pipeline(src, eng(), sink,
                        PresentClock(60.0, untimed=True))
        n = pipe.run()
        assert n == 11 and sink.count == 11

    def test_y4m_sink(self, small_cfg, tmp_path):
        src = synthetic.moving_box(small_cfg, 3)
        out = tmp_path / "out.y4m"
        sink = sinks.Y4MFileSink(str(out), 64, 48, 60.0)
        Pipeline(src, eng(), sink).run()
        frames = list(Y4MReader(open(out, "rb")))
        assert len(frames) == 6
        assert frames[0].fmt.width == 64

    def test_speed_command(self, small_cfg):
        src = synthetic.moving_box(small_cfg, 4)
        e = eng()
        pipe = Pipeline(src, e, sinks.NullSink())
        pipe.set_speed(2.0)
        pipe.run()
        assert e.cadence.playback_speed == 2.0

    def test_source_error_propagates(self):
        def bad():
            yield from synthetic.moving_box(
                synthetic.SyntheticConfig(width=64, height=48), 1)
            raise RuntimeError("decode died")
        pipe = Pipeline(bad(), eng(), sinks.NullSink())
        with pytest.raises(RuntimeError, match="decode died"):
            pipe.run()


class TestAppletProtocol:
    def test_command_codes(self, small_cfg):
        e = eng()
        list(map(e.push, synthetic.moving_box(small_cfg, 2)))
        assert apply_command_code(e, 5)       # HSVFlow
        assert e.frame_output_mode == 3
        assert apply_command_code(e, 11)
        assert (e.black_level, e.white_level) == (16.0, 219.0)
        assert apply_command_code(e, 123)
        assert e.black_level == 23.0
        assert apply_command_code(e, 500)
        assert e.white_level == 100.0
        assert apply_command_code(e, 707)
        assert e.delta_scalar == 7
        assert apply_command_code(e, 815)
        assert e.neighbor_bias_scalar == 15
        assert apply_command_code(e, 0)
        assert e.cadence.state == InterpolationState.DEACTIVATED
        assert e.cadence.blending_scalar == 0.0
        assert apply_command_code(e, 1)
        assert e.cadence.state == InterpolationState.ACTIVE
        assert not apply_command_code(e, 999)

    def test_deactivated_passthrough(self, small_cfg):
        e = eng()
        apply_command_code(e, 0)
        outs = []
        for f in synthetic.moving_box(small_cfg, 3):
            outs.extend(e.push(f))
        assert len(outs) == 3  # all passthrough

    def test_telemetry_text_shape(self, small_cfg):
        e = eng()
        for f in synthetic.moving_box(small_cfg, 3):
            e.push(f)
        text = telemetry_text(e)
        lines = text.split("\n")
        assert lines[0].startswith("Search Radius: ")
        assert lines[1] == "Calc Res: 64x48"
        assert len(lines) == 17  # 7 stat lines + 10 warp slots


class TestFailOpen:
    def test_engine_failure_passes_through(self, small_cfg, monkeypatch):
        e = eng()
        boom = {"n": 0}
        orig = e.push

        def flaky(frame):
            boom["n"] += 1
            if boom["n"] == 2:
                raise RuntimeError("device fell over")
            return orig(frame)

        monkeypatch.setattr(e, "push", flaky)
        src = synthetic.moving_box(small_cfg, 4)
        sink = sinks.NullSink()
        pipe = Pipeline(src, e, sink)
        n = pipe.run()
        assert pipe.engine_failed
        # frame 1 passthrough + frames 2..4 passed through after failure
        assert n == 4

    def test_fail_closed_raises(self, small_cfg, monkeypatch):
        e = eng()
        monkeypatch.setattr(e, "push",
                            lambda f: (_ for _ in ()).throw(RuntimeError("x")))
        pipe = Pipeline(synthetic.moving_box(small_cfg, 2), e,
                        sinks.NullSink(), fail_open=False)
        with pytest.raises(RuntimeError):
            pipe.run()


class TestY4MFuzz:
    """Parser robustness (the reference fuzzes demuxers with libFuzzer,
    meson.build:398-405; same spirit, in-process)."""

    @pytest.mark.parametrize("blob", [
        b"", b"\x00" * 64, b"YUV4MPEG2\n", b"YUV4MPEG2 W0 H0 F24:1\n",
        b"YUV4MPEG2 W64 H48 F0:0 C420\nFRAME\n",
        b"YUV4MPEG2 W64 H48 F24:1 C444\n",
        b"YUV4MPEG2 W-3 H48 F24:1\n",
        b"YUV4MPEG2 W64 H48 F24:1 Cgarbage\n",
        b"NOTAY4M W64 H48\n",
    ])
    def test_garbage_headers_raise_cleanly(self, blob):
        from mpv_frame_interpolator.io.y4m import Y4MError
        try:
            frames = list(Y4MReader(io.BytesIO(blob)))
            # headers that parse but carry no/short frames yield nothing
            assert frames == [] or all(f.fmt.width > 0 for f in frames)
        except (Y4MError, ValueError):
            pass  # clean, typed failure

    def test_truncated_frame_payload(self):
        blob = b"YUV4MPEG2 W64 H48 F24:1 C420\nFRAME\n" + b"\x55" * 100
        frames = list(Y4MReader(io.BytesIO(blob)))
        assert frames == []

    def test_bad_frame_marker(self):
        blob = (b"YUV4MPEG2 W64 H48 F24:1 C420\nJUNK\n" + b"\x55" * 4608)
        from mpv_frame_interpolator.io.y4m import Y4MError
        with pytest.raises(Y4MError):
            list(Y4MReader(io.BytesIO(blob)))


class TestConcurrentControl:
    def test_ipc_properties_during_playback(self, small_cfg, tmp_path):
        import json as _json
        import socket as _socket
        import threading
        from mpv_frame_interpolator.api import Player
        from mpv_frame_interpolator.control.ipc import IPCServer

        e = eng()
        player = Player(engine=e)
        sock_path = str(tmp_path / "c.sock")
        srv = IPCServer(sock_path, player)
        srv.start()
        errors = []

        def hammer():
            try:
                c = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
                c.connect(sock_path)
                f = c.makefile("rwb")
                for i in range(30):
                    f.write((_json.dumps({"command": [
                        "set_property", "search-radius", 5 + i % 12]})
                        + "\n").encode())
                    f.flush()
                    _json.loads(f.readline())
                c.close()
            except Exception as ex:  # pragma: no cover
                errors.append(ex)

        t = threading.Thread(target=hammer)
        t.start()
        outs = []
        for f in synthetic.moving_box(small_cfg, 6):
            outs.extend(e.push(f))
        t.join()
        srv.stop()
        assert not errors
        assert len(outs) >= 6


class TestPsnrSink:
    def test_psnr_against_known_reference(self, small_cfg):
        # feed identical frames; every warp output is compared against the
        # source -> near-lossless (modulo level-mapping truncation)
        frames = list(synthetic.moving_box(small_cfg, 3))
        e = eng()
        outs = []
        for f in frames:
            outs.extend(e.push(f))
        ref_frames = [frames[0]] + [frames[i] for i in (0, 0, 0, 1, 1)]
        sink = sinks.PsnrSink(lambda i, pts: ref_frames[i])
        for o in outs:
            sink.write(o)
        assert len(sink.values) == 6
        # outputs interpolate between references; min PSNR still far above
        # noise (static-ish box source)
        assert sink.min > 15.0


class TestFfmpegDecode:
    def test_ffmpeg_source_through_stub(self, tmp_path, monkeypatch,
                                        small_cfg):
        """Exercise the external-decoder path with a stub ffmpeg that emits
        a y4m stream (the real binary is absent in this image)."""
        import stat
        import sys as _sys
        from mpv_frame_interpolator.io import synthetic as _syn
        from mpv_frame_interpolator.io.y4m import Y4MWriter
        clip = tmp_path / "clip.y4m"
        with open(clip, "wb") as fh:
            w = Y4MWriter(fh, 64, 48, 24.0)
            for f in _syn.moving_box(small_cfg, 3):
                w.write(f)
        stub = tmp_path / "ffmpeg"
        stub.write_text(
            f"#!{_sys.executable}\nimport sys, shutil\n"
            f"shutil.copyfileobj(open({str(clip)!r}, 'rb'), sys.stdout.buffer)\n")
        stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")

        from mpv_frame_interpolator.io import decode
        assert decode.have_ffmpeg()
        frames = list(decode.ffmpeg_source("whatever.mkv"))
        assert len(frames) == 3
        assert frames[0].fmt.width == 64
        assert frames[0].nominal_fps == pytest.approx(24.0)

    def test_missing_ffmpeg_raises_cleanly(self, monkeypatch):
        from mpv_frame_interpolator.io import decode
        monkeypatch.setenv("PATH", "/nonexistent")
        with pytest.raises(RuntimeError, match="ffmpeg is not installed"):
            list(decode.ffmpeg_source("x.mkv"))


class TestPgm16:
    def test_pgm_dump_p010(self, tmp_path):
        cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                        pixfmt=P010)
        e = eng()
        sink = sinks.PgmDumpSink(str(tmp_path))
        for f in synthetic.moving_box(cfg, 2):
            for o in e.push(f):
                sink.write(o)
        files = sorted(os.listdir(tmp_path))
        assert len(files) == 4
        with open(tmp_path / files[0], "rb") as fh:
            assert fh.readline().strip() == b"P5"
            assert fh.readline().strip() == b"64 48"
            assert fh.readline().strip() == b"255"
            data = fh.read()
            assert len(data) == 64 * 48


class TestDisplaySyncAdaptation:
    def test_retargets_to_measured_refresh(self, small_cfg):
        """vo.c check_estimated_display_fps analog: stable measured
        refresh near the nominal retargets the cadence."""
        e = eng()
        pipe = Pipeline(iter(()), e, sinks.NullSink(),
                        PresentClock(60.0))
        pc = pipe.present
        pc.presented = 128
        pc.untimed = False
        pc.estimated_display_fps = lambda: 59.94
        pc.vsync_jitter = lambda: 0.0
        pipe._maybe_adapt_display_rate()
        assert 1.0 / e.cadence.target_frame_time == pytest.approx(59.94)

    def test_ignores_unstable_or_far_estimates(self, small_cfg):
        e = eng()
        pipe = Pipeline(iter(()), e, sinks.NullSink(), PresentClock(60.0))
        pc = pipe.present
        pc.presented = 128
        pc.untimed = False
        pc.estimated_display_fps = lambda: 48.0   # >5% off: mode mismatch
        pc.vsync_jitter = lambda: 0.0
        pipe._maybe_adapt_display_rate()
        assert 1.0 / e.cadence.target_frame_time == pytest.approx(60.0)
        pc.estimated_display_fps = lambda: 59.9
        pc.vsync_jitter = lambda: 1.0             # jittery: don't trust
        pipe._maybe_adapt_display_rate()
        assert 1.0 / e.cadence.target_frame_time == pytest.approx(60.0)


class TestFramedrop:
    def test_sustained_lateness_sheds_source_frames(self, small_cfg):
        """check_framedrop analog: 8 consecutive late presents drop the
        next source frame; cadence re-anchors across the gap."""
        from mpv_frame_interpolator.pipeline.present import PresentInfo
        e = eng()

        class LateClock:
            untimed = False
            display_fps = 60.0
            vsync_interval = 1 / 60
            presented = 0
            drops = 0

            def present(self, pts):
                self.presented += 1
                return PresentInfo(self.presented, 1, 0.0, 0.01, False)

            def estimated_display_fps(self):
                return 60.0

            def vsync_jitter(self):
                return 0.0

            def reset(self):
                pass

        src = synthetic.moving_box(small_cfg, 10)
        pipe = Pipeline(src, e, sinks.NullSink(), present=LateClock())
        pipe.run()
        assert pipe.sources_dropped >= 1
        assert pipe.frames_in == 10


class TestUnderrun:
    def test_slow_source_counts_underruns(self, small_cfg):
        import time as _t
        from mpv_frame_interpolator.pipeline.present import PresentClock

        def slow_source():
            for f in synthetic.moving_box(small_cfg, 4):
                _t.sleep(0.06)   # slower than the 24fps source cadence
                yield f

        e = eng()
        pipe = Pipeline(slow_source(), e, sinks.NullSink(),
                        PresentClock(60.0, untimed=False), prefetch=1)
        pipe.run()
        assert pipe.underruns >= 1


class TestY4MRatio:
    @pytest.mark.parametrize("fps,expect", [
        (24.0, b"F24:1"), (60.0, b"F60:1"),
        (23.976023976023978, b"F24000:1001"), (29.97002997002997, b"F30000:1001"),
    ])
    def test_fps_ratio_encoding(self, fps, expect):
        buf = io.BytesIO()
        Y4MWriter(buf, 64, 48, fps)
        assert expect in buf.getvalue()
