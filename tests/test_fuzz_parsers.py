"""Deterministic fuzzing of every untrusted-input parser (VERDICT r1
item 5; reference analog: fuzzers/fuzzer_load.c + meson.build:398-405).

Each parser gets thousands of seeded hostile inputs; the contract is
"typed error or clean result, never an unhandled exception, hang, or
allocation bomb".  Seeds are fixed so failures reproduce.
"""

import io
import json
import random
import string

import numpy as np
import pytest

from mpv_frame_interpolator.io.y4m import (
    MAX_DIMENSION, MAX_PIXELS, Y4MError, Y4MReader, parse_header)


def rng(seed):
    return random.Random(seed)


# ---------------------------------------------------------------------
# y4m stream header
# ---------------------------------------------------------------------

class TestFuzzY4MHeader:
    def test_random_ascii_headers(self):
        r = rng(1234)
        chars = string.printable
        for _ in range(4000):
            s = "".join(r.choice(chars) for _ in range(r.randint(0, 80)))
            try:
                w, h, fps, pix = parse_header(s)
                assert 0 < w <= MAX_DIMENSION and 0 < h <= MAX_DIMENSION
                assert w * h <= MAX_PIXELS and 0 <= fps
            except Y4MError:
                pass

    def test_mutated_valid_headers(self):
        r = rng(99)
        base = "YUV4MPEG2 W1920 H1080 F24:1 Ip A1:1 C420mpeg2"
        for _ in range(4000):
            s = list(base)
            for _ in range(r.randint(1, 6)):
                i = r.randrange(len(s))
                s[i] = r.choice(string.printable)
            try:
                parse_header("".join(s))
            except Y4MError:
                pass

    def test_hostile_numbers(self):
        cases = ["W99999999999 H2", "W-5 H5", "W8 H1e30", "F1:0", "F-2:1",
                 "W16384 H16384", "W0 H0", "F999999999999999:1",
                 "W2 H2 F24:1 C999", "W" + "9" * 500 + " H2"]
        for c in cases:
            try:
                w, h, fps, _ = parse_header("YUV4MPEG2 " + c)
                assert w * h <= MAX_PIXELS and fps <= 1e5
            except Y4MError:
                pass

    def test_frame_stream_random_bytes(self):
        """Random bytes after a valid header: typed error or clean EOF."""
        r = rng(7)
        for _ in range(300):
            junk = bytes(r.randrange(256)
                         for _ in range(r.randint(0, 400)))
            fh = io.BytesIO(b"YUV4MPEG2 W8 H8 F24:1 C420\n" + junk)
            try:
                frames = list(Y4MReader(fh))
                assert len(frames) <= 4
            except Y4MError:
                pass

    def test_truncated_frames(self):
        payload = bytes(range(8 * 8)) + b"\x80" * 32
        stream = b"YUV4MPEG2 W8 H8 F24:1 C420\n"
        stream += (b"FRAME\n" + payload) * 3
        for cut in range(0, len(stream), 7):
            fh = io.BytesIO(stream[:cut])
            try:
                frames = list(Y4MReader(fh))
                assert len(frames) <= 3
            except Y4MError:
                pass


# ---------------------------------------------------------------------
# JSON IPC protocol
# ---------------------------------------------------------------------

class TestFuzzIPC:
    @pytest.fixture()
    def server(self, tmp_path):
        from mpv_frame_interpolator.api import Player
        from mpv_frame_interpolator.control.ipc import IPCServer
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        player = Player(engine=InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False,
            measure_timing=False)))
        return IPCServer(str(tmp_path / "sock"), player)

    def test_random_bytes(self, server):
        r = rng(42)
        replies = []
        for _ in range(3000):
            line = bytes(r.randrange(256) for _ in range(r.randint(0, 120)))
            server.handle_line(line, replies.append)
        for rep in replies:
            json.dumps(rep)      # every reply is serializable

    def test_valid_json_wrong_shapes(self, server):
        r = rng(43)
        shapes = [
            {}, [], 42, None, True, "x",
            {"command": None}, {"command": []}, {"command": 5},
            {"command": [None]}, {"command": [[]]},
            {"command": ["set_property"]},
            {"command": ["set_property", "speed"]},
            {"command": ["set_property", "speed", "NaN"]},
            {"command": ["set_property", "display-fps", -1]},
            {"command": ["set_property", "search-radius", 1e308]},
            {"command": ["get_property", {"a": 1}]},
            {"command": ["get_property", ["speed"]]},
            {"command": ["observe_property"]},
            {"command": ["observe_property", {}, 3]},
            {"command": ["seek", "notanumber"]},
            {"command": ["seek"]},
            {"request_id": {"un": "hashable"}, "command": ["x"]},
            {"command": ["x" * 10000]},
        ]
        replies = []
        for shape in shapes:
            server.handle_line(json.dumps(shape).encode(), replies.append)
        # random property/command names
        for _ in range(2000):
            name = "".join(r.choice(string.printable)
                           for _ in range(r.randint(0, 30)))
            server.handle_line(
                json.dumps({"command": [name, name]}).encode(),
                replies.append)
        for rep in replies:
            json.dumps(rep)

    def test_engine_still_sane_after_fuzzing(self, server):
        r = rng(44)
        for _ in range(1000):
            cmd = [r.choice(["set_property", "get_property", "seek-reset"])]
            cmd += [r.choice(["speed", "search-radius", "display-fps",
                              "frame-output-mode", "zzz"]),
                    r.choice([0, 1, 5.5, -3, "9", None, 1e10])]
            server.handle_line(json.dumps({"command": cmd}).encode(),
                               lambda _: None)
        e = server.player.engine
        # invariants the fuzz must not have broken
        assert e.quality.min_radius <= e.quality.search_radius \
            <= e.quality.max_radius
        assert e.cadence.target_frame_time > 0


# ---------------------------------------------------------------------
# applet code protocol
# ---------------------------------------------------------------------

class TestFuzzApplet:
    def test_code_line_parser(self):
        from mpv_frame_interpolator.control.applet import parse_code_line
        r = rng(5)
        for _ in range(5000):
            line = "".join(r.choice(string.printable)
                           for _ in range(r.randint(0, 40)))
            code = parse_code_line(line)
            assert code is None or isinstance(code, int)

    def test_apply_any_int_code(self):
        from mpv_frame_interpolator.control.applet import (
            apply_command_code)
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        eng = InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False,
            measure_timing=False))
        r = rng(6)
        for _ in range(5000):
            code = r.choice([r.randint(-10, 900), r.randint(-2**62, 2**62)])
            apply_command_code(eng, code)     # must never raise
        assert 0.0 <= eng.black_level <= 255.0
        assert 0.0 <= eng.white_level <= 255.0


# ---------------------------------------------------------------------
# config file + watch-later parsers
# ---------------------------------------------------------------------

class TestFuzzConfig:
    def test_random_config_text(self):
        from mpv_frame_interpolator.options import (
            ConfigError, parse_config_text)
        r = rng(8)
        chars = string.printable
        for _ in range(4000):
            text = "".join(r.choice(chars) for _ in range(r.randint(0, 200)))
            try:
                parse_config_text(text)
            except ConfigError:
                pass

    def test_random_watch_later_files(self, tmp_path):
        from mpv_frame_interpolator.pipeline import resume
        r = rng(9)
        for i in range(500):
            text = "".join(r.choice(string.printable)
                           for _ in range(r.randint(0, 150)))
            d = tmp_path / "wl"
            d.mkdir(exist_ok=True)
            key = resume._key(f"media{i}")
            (d / key).write_text(text)
            state = resume.load(f"media{i}", directory=str(d))
            assert state is None or isinstance(state, dict)
