"""Pause + frame-step (mpv core pause / player/command.c frame-step)."""

import threading
import time

import pytest

from mpv_frame_interpolator.api import Player, PropertyError
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator.pipeline.player import Pipeline


def eng():
    return InterpolationEngine(EngineConfig(
        scene_detection=False, auto_quality=False, measure_timing=False,
        background_precompile=False))


class _CountSink:
    def __init__(self):
        self.count = 0

    def write(self, out):
        self.count += 1

    def close(self):
        pass


def run_pipeline_bg(small_cfg, n=200):
    frames = iter(list(synthetic.moving_box(small_cfg, n)))
    engine = eng()
    sink = _CountSink()
    pipe = Pipeline(frames, engine, sink, present=None, stage_uploads=False)
    t = threading.Thread(target=pipe.run, daemon=True)
    return pipe, sink, t


class TestPause:
    def test_pause_halts_and_resume_continues(self, small_cfg):
        pipe, sink, t = run_pipeline_bg(small_cfg, 400)
        pipe.set_pause(True)
        t.start()
        time.sleep(0.5)
        paused_count = sink.count
        assert paused_count <= 12      # prefetch depth + one in flight
        time.sleep(0.3)
        assert sink.count == paused_count      # fully halted
        pipe.set_pause(False)
        t.join(timeout=120)
        assert not t.is_alive()
        assert sink.count > paused_count + 50  # playback resumed

    def test_frame_step_advances_one_source(self, small_cfg):
        pipe, sink, t = run_pipeline_bg(small_cfg, 100)
        pipe.set_pause(True)
        t.start()
        time.sleep(0.4)
        base = sink.count
        pipe.frame_step()
        time.sleep(0.6)
        stepped = sink.count
        assert 0 < stepped - base <= 3         # one source frame's outputs
        time.sleep(0.3)
        assert sink.count == stepped           # still paused after the step
        pipe.set_pause(False)
        t.join(timeout=120)

    def test_seek_while_paused(self, small_cfg):
        import io
        from mpv_frame_interpolator.io import y4m
        from mpv_frame_interpolator.io.ingest import open_y4m
        buf = io.BytesIO()
        w = y4m.Y4MWriter(buf, 64, 48, 24.0)
        for f in synthetic.moving_box(small_cfg, 48):
            w.write(f)
        buf.seek(0)
        rdr = y4m.Y4MReader(buf)
        engine = eng()
        sink = _CountSink()
        pipe = Pipeline(rdr, engine, sink, present=None,
                        stage_uploads=False)
        pipe.set_pause(True)
        t = threading.Thread(target=pipe.run, daemon=True)
        t.start()
        time.sleep(0.3)
        pipe.seek(40 / 24.0)                   # processed while paused
        deadline = time.time() + 30
        while pipe.seeks == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert pipe.seeks == 1
        pipe.set_pause(False)
        t.join(timeout=120)

    def test_player_property_and_command(self, small_cfg):
        pipe, sink, t = run_pipeline_bg(small_cfg, 60)
        player = Player(engine=pipe.engine)
        player.bind_pipeline(pipe)
        assert player.get_property("pause") is False
        player.set_property("pause", True)
        assert pipe.paused
        player.command("frame-step")
        player.set_property("pause", False)
        t.start()
        t.join(timeout=120)
        assert sink.count > 50

    def test_unbound_player_errors(self):
        player = Player(engine=eng())
        assert player.get_property("pause") is False
        with pytest.raises(PropertyError):
            player.set_property("pause", True)
        with pytest.raises(PropertyError):
            player.command("frame-step")
