"""Applet client <-> server round trip over the real FIFOs (the widget
loop the reference implements in HopperRenderSettingsApplet.py)."""

import os
import threading
import time

import pytest

from mpv_frame_interpolator.control.applet import AppletServer
from mpv_frame_interpolator.control.applet_client import (
    main as client_main, read_status, send_code)
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)


@pytest.fixture()
def served_engine(tmp_path):
    engine = InterpolationEngine(EngineConfig(
        scene_detection=False, auto_quality=False, measure_timing=False))
    fifo = str(tmp_path / "hr")
    server = AppletServer(fifo, engine, period=0.05)
    server.start()
    yield engine, fifo
    server.stop()


class TestClientRoundTrip:
    def test_read_status_block(self, served_engine):
        engine, fifo = served_engine
        text = read_status(fifo, timeout=5.0)
        assert "Search Radius: 5" in text
        assert "Target Time:" in text and "OFC Time:" in text

    def test_send_codes_mutate_engine(self, served_engine):
        engine, fifo = served_engine
        send_code(fifo, 4)            # frame output mode -> 2 (blend)
        send_code(fifo, 10)           # levels preset 10/219
        deadline = time.time() + 5.0
        while time.time() < deadline and engine.white_level != 219.0:
            time.sleep(0.02)
        assert engine.frame_output_mode == 2
        assert (engine.black_level, engine.white_level) == (10.0, 219.0)

    def test_cli_once_and_send(self, served_engine, capsys):
        engine, fifo = served_engine
        assert client_main([fifo, "--send", "7"]) == 0
        assert client_main([fifo, "--once"]) == 0
        out = capsys.readouterr().out
        assert "Search Radius" in out
        deadline = time.time() + 5.0
        while time.time() < deadline and engine.frame_output_mode != 5:
            time.sleep(0.02)
        assert engine.frame_output_mode == 5
