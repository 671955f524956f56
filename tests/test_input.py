"""Input layer (control/input.py): input.conf parsing, key decoding,
command dispatch against a live pipeline, terminal reader thread."""

import os
import time

import pytest

from mpv_frame_interpolator.control.input import (
    DEFAULT_BINDINGS, KeyDispatcher, TerminalInput, decode_keys,
    parse_input_conf)


class TestParseInputConf:
    def test_basic_lines(self):
        conf = """
        # a comment
        RIGHT seek 10
        SPACE cycle pause   # trailing comment
        SHARP screenshot
        q quit
        """
        b = parse_input_conf(conf)
        assert b["RIGHT"] == "seek 10"
        assert b["SPACE"] == "cycle pause"
        assert b["#"] == "screenshot"
        assert b["q"] == "quit"

    def test_ignore_unbinds(self):
        b = parse_input_conf("q ignore\n")
        assert b["q"] == "ignore"

    def test_malformed_skipped(self):
        assert parse_input_conf("justakey\n\n") == {}


class TestDecodeKeys:
    def test_plain_and_special(self):
        keys, rest = decode_keys(b"q. s")
        assert keys == ["q", ".", "SPACE", "s"]
        assert rest == b""

    def test_arrows(self):
        keys, rest = decode_keys(b"\x1b[A\x1b[D\x1b[C\x1b[B")
        assert keys == ["UP", "LEFT", "RIGHT", "DOWN"]
        assert rest == b""

    def test_incomplete_escape_kept(self):
        keys, rest = decode_keys(b"q\x1b")
        assert keys == ["q"]
        assert rest == b"\x1b"

    def test_ctrl(self):
        keys, _ = decode_keys(b"\x03")
        assert keys == ["Ctrl+c"]


def _pipeline(n=40):
    from mpv_frame_interpolator.api import Player
    from mpv_frame_interpolator.io import synthetic
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
    return player, pipe


class TestKeyDispatcher:
    def test_speed_multiply(self):
        player, pipe = _pipeline(4)
        d = KeyDispatcher(player, pipe)
        assert d.on_key("]")
        assert float(player.get_property("speed")) == pytest.approx(1.1)
        d.on_key("[")
        assert float(player.get_property("speed")) == pytest.approx(1.0)

    def test_pause_cycle_and_quit(self):
        player, pipe = _pipeline(4)
        d = KeyDispatcher(player, pipe)
        d.on_key("SPACE")
        assert pipe.paused
        d.on_key("SPACE")
        assert not pipe.paused
        d.on_key("q")
        assert pipe._quit

    def test_quit_watch_later_hook(self):
        player, pipe = _pipeline(4)
        calls = []
        d = KeyDispatcher(player, pipe, on_quit=lambda wl: calls.append(wl))
        d.on_key("Q")
        assert calls == [True]

    def test_unbound_key(self):
        player, pipe = _pipeline(4)
        d = KeyDispatcher(player, pipe, default_bindings=False)
        assert not d.on_key("q")
        assert not pipe._quit

    def test_user_override(self):
        player, pipe = _pipeline(4)
        d = KeyDispatcher(player, pipe, bindings={"q": "ignore"})
        assert d.on_key("q")
        assert not pipe._quit

    def test_defaults_mirror_reference(self):
        for key in ("RIGHT", "LEFT", "UP", "DOWN", "SPACE", ".", "s",
                    "q", "Q", "[", "]"):
            assert key in DEFAULT_BINDINGS

    def test_seek_during_playback(self):
        """RIGHT during a run lands a real source seek."""
        import threading
        from mpv_frame_interpolator.io.cache import CachedSource
        from mpv_frame_interpolator.api import Player
        from mpv_frame_interpolator.io import synthetic
        from mpv_frame_interpolator.io.sinks import NullSink
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        from mpv_frame_interpolator.pipeline.player import Pipeline
        cfg = synthetic.SyntheticConfig(width=64, height=48)
        engine = InterpolationEngine(EngineConfig(
            background_precompile=False, measure_timing=False))
        src = CachedSource(synthetic.moving_box(cfg, 200000))
        pipe = Pipeline(src, engine, NullSink(), present=None)
        player = Player(engine=engine)
        player.bind_pipeline(pipe)
        d = KeyDispatcher(player, pipe)
        runner = threading.Thread(target=pipe.run)
        runner.start()
        time.sleep(0.3)
        d.on_key("RIGHT")           # +5s
        deadline = time.time() + 60
        while pipe.seeks < 1 and time.time() < deadline:
            time.sleep(0.05)
        d.on_key("q")
        runner.join(timeout=60)
        assert not runner.is_alive()
        assert pipe.seeks >= 1


class TestTerminalInput:
    def test_pipe_fd_reader(self):
        """Feed keys through a pipe (raw mode silently unavailable)."""
        player, pipe = _pipeline(4)
        d = KeyDispatcher(player, pipe)
        r, w = os.pipe()
        ti = TerminalInput(d, fd=r)
        ti.start()
        os.write(w, b"]")
        time.sleep(0.3)
        os.write(w, b"\x1b[A")      # UP -> seek 60 (unseekable: logged)
        time.sleep(0.3)
        ti.stop()
        os.close(w)
        os.close(r)
        assert d.dispatched >= 2
        assert float(player.get_property("speed")) == pytest.approx(1.1)
