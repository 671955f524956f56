"""Player API, JSON IPC server, watch-later resume."""

import json
import os

import socket
import time

import pytest

from mpv_frame_interpolator.api import Player, PropertyError, EventType
from mpv_frame_interpolator.control.ipc import IPCServer
from mpv_frame_interpolator.pipeline import resume
from mpv_frame_interpolator.pipeline.engine import EngineConfig
from mpv_frame_interpolator.io import synthetic


def make_player():
    return Player(EngineConfig(scene_detection=False, auto_quality=False,
                               measure_timing=False))


class TestPlayerAPI:
    def test_properties(self):
        p = make_player()
        assert p.get_property("speed") == 1.0
        p.set_property("speed", 2.0)
        assert p.get_property("speed") == 2.0
        assert p.engine.cadence.playback_speed == 2.0
        p.set_property("frame-output-mode", 3)
        assert p.engine.frame_output_mode == 3
        with pytest.raises(PropertyError):
            p.get_property("nope")
        with pytest.raises(PropertyError):
            p.set_property("interpolation-state", "ACTIVE")

    def test_radius_clamped(self):
        p = make_player()
        p.set_property("search-radius", 99)
        assert p.get_property("search-radius") == 16
        p.set_property("search-radius", 1)
        assert p.get_property("search-radius") == 5

    def test_observers_and_events(self, small_cfg):
        p = make_player()
        seen = []
        p.observe_property("speed", lambda n, v: seen.append(v))
        p.set_property("speed", 0.5)
        assert seen == [1.0, 0.5]
        # 0.5x speed halves the effective source rate: 5 outputs per source
        outs = list(p.feed_all(synthetic.moving_box(small_cfg, 3)))
        assert len(outs) == 1 + 5 + 5
        types = set()
        while True:
            ev = p.wait_event()
            if ev is None:
                break
            types.add(ev.type)
        assert EventType.FRAMES_OUT in types
        assert EventType.END_OF_STREAM in types

    def test_applet_code_command(self):
        p = make_player()
        p.command("applet-code", 5)   # HSVFlow
        assert p.get_property("frame-output-mode") == 3


class TestIPC:
    def test_json_protocol(self, tmp_path):
        p = make_player()
        sock_path = str(tmp_path / "ipc.sock")
        srv = IPCServer(sock_path, p)
        srv.start()
        try:
            c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            c.connect(sock_path)
            f = c.makefile("rwb")

            def rpc(obj):
                f.write((json.dumps(obj) + "\n").encode())
                f.flush()
                return json.loads(f.readline())

            r = rpc({"command": ["get_property", "speed"]})
            assert r == {"error": "success", "data": 1.0}
            r = rpc({"command": ["set_property", "speed", 2.5],
                     "request_id": 7})
            assert r["error"] == "success" and r["request_id"] == 7
            assert p.get_property("speed") == 2.5
            r = rpc({"command": ["observe_property", 1, "search-radius"]})
            assert r["error"] == "success"
            # initial observer push arrives as an event line
            ev = json.loads(f.readline())
            assert ev["event"] == "property-change"
            assert ev["name"] == "search-radius"
            r = rpc({"command": ["get_property", "bogus"]})
            assert r["error"] != "success"
            c.close()
        finally:
            srv.stop()


class TestResume:
    def test_roundtrip(self, tmp_path):
        d = str(tmp_path / "wl")
        path = resume.save("/media/movie.mkv", 123.456,
                           {"speed": 2.0, "search-radius": 9}, d)
        assert os.path.exists(path)
        state = resume.load("/media/movie.mkv", d)
        assert state["start"] == pytest.approx(123.456)
        assert state["speed"] == 2.0
        assert state["search-radius"] == 9
        p = make_player()
        pos = resume.apply_to_player(p, state)
        assert pos == pytest.approx(123.456)
        assert p.get_property("speed") == 2.0
        assert p.get_property("search-radius") == 9
        resume.forget("/media/movie.mkv", d)
        assert resume.load("/media/movie.mkv", d) is None

    def test_missing_is_none(self, tmp_path):
        assert resume.load("/nope.mkv", str(tmp_path)) is None


class TestAppletServerFifo:
    def test_fifo_roundtrip(self, tmp_path, small_cfg):
        """Drive the applet protocol over real FIFOs like the widget does
        (HopperRenderSettingsApplet.py reads 512-byte status blocks)."""
        import threading
        from mpv_frame_interpolator.control.applet import AppletServer
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)

        e = InterpolationEngine(EngineConfig(scene_detection=False,
                                             auto_quality=False,
                                             measure_timing=False))
        fifo = str(tmp_path / "hopperrender")
        srv = AppletServer(fifo, e, period=0.05)
        srv.start()
        try:
            # widget side: send a command code, then read one status block
            with open(srv.cmd_path, "w") as cmd:
                cmd.write("5\n")   # HSVFlow
                cmd.flush()
            status = b""

            def read_status():
                nonlocal status
                with open(fifo, "rb") as fh:
                    status = fh.read(512)

            t = threading.Thread(target=read_status)
            t.start()
            t.join(timeout=5.0)
            assert not t.is_alive()
            assert len(status) == 512
            text = status.rstrip(b"\0").decode()
            assert text.startswith("Search Radius: ")
            deadline = time.time() + 3.0
            while e.frame_output_mode != 3 and time.time() < deadline:
                time.sleep(0.05)
            assert e.frame_output_mode == 3   # command was applied
        finally:
            srv.stop()


class TestPlaylistQuitSurface:
    def test_playlist_props_single_file(self):
        p = make_player()
        assert p.get_property("playlist-pos") == 0
        assert p.get_property("playlist-count") == 1

    def test_playlist_props_chained(self, tmp_path):
        from mpv_frame_interpolator.io.playlist import ChainedSource
        from mpv_frame_interpolator.io.y4m import Y4MReader, Y4MWriter
        from mpv_frame_interpolator.io.sinks import NullSink
        from mpv_frame_interpolator.pipeline.player import Pipeline
        cfg = synthetic.SyntheticConfig(width=32, height=32)
        for name in ("a", "b", "c"):
            with open(tmp_path / f"{name}.y4m", "wb") as fh:
                w = Y4MWriter(fh, 32, 32, 24.0)
                for f in synthetic.moving_box(cfg, 2):
                    w.write(f)
        src = ChainedSource([str(tmp_path / f"{n}.y4m")
                             for n in ("a", "b", "c")],
                            lambda path: Y4MReader(open(path, "rb")))
        p = make_player()
        pipe = Pipeline(src, p.engine, NullSink(), present=None)
        p.bind_pipeline(pipe)
        assert p.get_property("playlist-count") == 3
        pipe.run()
        assert p.get_property("playlist-pos") == 2

    def test_quit_command(self):
        import threading
        from mpv_frame_interpolator.io.sinks import NullSink
        from mpv_frame_interpolator.pipeline.player import Pipeline
        cfg = synthetic.SyntheticConfig(width=32, height=32)
        p = make_player()
        pipe = Pipeline(synthetic.moving_box(cfg, 100000), p.engine,
                        NullSink(), present=None)
        p.bind_pipeline(pipe)
        runner = threading.Thread(target=pipe.run)
        runner.start()
        time.sleep(0.3)
        p.command("quit")
        runner.join(timeout=60)
        assert not runner.is_alive()

    def test_quit_without_pipeline(self):
        with pytest.raises(PropertyError):
            make_player().command("quit")


class TestModelSwitch:
    def test_runtime_model_switch(self, small_cfg):
        p = make_player()
        outs = list(p.feed_all(synthetic.moving_box(small_cfg, 3)))
        assert p.get_property("model") == "hopper"
        p.set_property("model", "blend")
        frames = [f.with_pts(f.pts + 1.0) for f in
                  synthetic.moving_box(small_cfg, 2)]
        for f in frames:
            f.nominal_fps = 24.0
        outs2 = []
        for f in frames:
            outs2.extend(p.feed(f))
        assert len(outs2) >= 2
        with pytest.raises(Exception):
            p.set_property("model", "bogus")


class TestDisplayFpsRetarget:
    def test_display_fps_change_retargets_cadence(self, small_cfg):
        p = make_player()
        outs = list(p.feed_all(synthetic.moving_box(small_cfg, 3)))
        assert len(outs) == 1 + 3 + 2        # 24->60
        p.set_property("display-fps", 120.0)
        assert p.get_property("display-fps") == pytest.approx(120.0)
        frames = [f.with_pts(f.pts + 1.0) for f in
                  synthetic.moving_box(small_cfg, 2)]
        for f in frames:
            f.nominal_fps = 24.0
        outs2 = []
        for f in frames:
            outs2.extend(p.feed(f))
        # 24->120: 5 outputs per source pair
        assert len(outs2) == 10
        with pytest.raises(ValueError):
            p.set_property("display-fps", 0)


class TestTelemetryProperties:
    def test_telemetry_props(self, small_cfg):
        p = make_player()
        list(p.feed_all(synthetic.moving_box(small_cfg, 3)))
        assert p.get_property("calc-res") == "64x48"
        assert p.get_property("scene-cut-score") >= 0.0
        assert p.get_property("ofc-time") >= 0.0
        for name in ("warp-time", "total-time"):
            assert isinstance(p.get_property(name), float)


class TestMaxCalcRes:
    def test_runtime_flow_resolution_change(self):
        cfg = synthetic.SyntheticConfig(width=256, height=544, fps=24.0)
        p = make_player()
        frames = list(synthetic.gradient_pan(cfg, 3))
        for f in frames:
            p.feed(f)
        assert p.get_property("calc-res") == "64x136"   # 544>>2
        p.set_property("max-calc-res", 544)
        frames2 = [f.with_pts(f.pts + 1.0) for f in
                   synthetic.gradient_pan(cfg, 2)]
        for f in frames2:
            f.nominal_fps = 24.0
            p.feed(f)
        assert p.get_property("calc-res") == "256x544"  # full res flow
        with pytest.raises(ValueError):
            p.set_property("max-calc-res", 8)


class TestIpcPropertyList:
    def test_property_list(self, tmp_path):
        import json as _json
        import socket as _socket
        p = make_player()
        sock_path = str(tmp_path / "pl.sock")
        srv = IPCServer(sock_path, p)
        srv.start()
        try:
            c = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            c.connect(sock_path)
            f = c.makefile("rwb")
            f.write(b'{"command": ["property-list"]}\n')
            f.flush()
            r = _json.loads(f.readline())
            assert r["error"] == "success"
            assert "speed" in r["data"] and "model" in r["data"]
            c.close()
        finally:
            srv.stop()
