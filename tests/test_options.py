"""Config files + profiles (m_config_frontend.c:1091 analog).

Precedence contract: CLI > profile (in --profile order) > config-file top
level > built-in defaults.  Unknown keys, bad values, and missing profiles
are hard startup errors, like the reference.
"""

import os

import pytest

from mpv_frame_interpolator.cli import build_parser
from mpv_frame_interpolator.options import (
    ConfigError, parse_config_text, parse_with_config)


def parse(tmp_path, conf_text, argv):
    path = tmp_path / "mfi.conf"
    path.write_text(conf_text)
    return parse_with_config(build_parser(),
                             ["--config", str(path)] + argv)


class TestParseText:
    def test_sections_and_comments(self):
        top, profiles = parse_config_text(
            "# comment\ndisplay-fps=60\n\n[fast]\nsearch-radius=5\n"
            "[hdr]\np010=yes\nmode='hsv'\n")
        assert top == {"display-fps": "60"}
        assert profiles["fast"] == {"search-radius": "5"}
        assert profiles["hdr"] == {"p010": "yes", "mode": "hsv"}

    def test_bad_line_rejected(self):
        with pytest.raises(ConfigError):
            parse_config_text("display-fps 60\n")

    def test_empty_profile_name_rejected(self):
        with pytest.raises(ConfigError):
            parse_config_text("[ ]\n")


class TestPrecedence:
    CONF = ("display-fps=50\nscene-threshold=25\n"
            "[fast]\nsearch-radius=7\ndisplay-fps=72\n"
            "[slow]\nsearch-radius=16\n")

    def test_file_overrides_defaults(self, tmp_path):
        args = parse(tmp_path, self.CONF, ["in.y4m"])
        assert args.display_fps == 50.0
        assert args.scene_threshold == 25.0
        assert args.search_radius == 5          # untouched default

    def test_profile_overrides_file(self, tmp_path):
        args = parse(tmp_path, self.CONF, ["--profile=fast", "in.y4m"])
        assert args.search_radius == 7
        assert args.display_fps == 72.0
        assert args.scene_threshold == 25.0     # file top level survives

    def test_cli_overrides_profile(self, tmp_path):
        args = parse(tmp_path, self.CONF,
                     ["--profile=fast", "--display-fps", "120", "in.y4m"])
        assert args.display_fps == 120.0
        assert args.search_radius == 7

    def test_profiles_apply_in_order(self, tmp_path):
        args = parse(tmp_path, self.CONF,
                     ["--profile=fast", "--profile=slow", "in.y4m"])
        assert args.search_radius == 16         # later profile wins
        assert args.display_fps == 72.0         # earlier profile survives

    def test_no_config_skips_file(self, tmp_path):
        path = tmp_path / "mfi.conf"
        path.write_text(self.CONF)
        env = os.environ.get("MFI_CONF")
        os.environ["MFI_CONF"] = str(path)
        try:
            args = parse_with_config(build_parser(),
                                     ["--no-config", "in.y4m"])
            assert args.display_fps == 60.0     # built-in default
        finally:
            if env is None:
                del os.environ["MFI_CONF"]
            else:
                os.environ["MFI_CONF"] = env


class TestBadInput:
    def test_unknown_key(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "not-an-option=1\n", ["in.y4m"])

    def test_bad_value(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "display-fps=fast\n", ["in.y4m"])

    def test_bad_bool(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "untimed=sometimes\n", ["in.y4m"])

    def test_bool_flag_values(self, tmp_path):
        args = parse(tmp_path, "untimed=yes\np010=no\n", ["in.y4m"])
        assert args.untimed is True
        assert args.p010 is False

    def test_unknown_profile(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "[a]\nuntimed=yes\n",
                  ["--profile=missing", "in.y4m"])

    def test_missing_explicit_config(self, tmp_path):
        with pytest.raises(ConfigError):
            parse_with_config(build_parser(),
                              ["--config", str(tmp_path / "nope.conf"),
                               "in.y4m"])

    def test_choice_key_validated(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "ingest=cuda\n", ["in.y4m"])


class TestShippedExample:
    def test_baseline_profiles_parse(self, tmp_path):
        conf = open(os.path.join(os.path.dirname(__file__), "..",
                                 "examples", "mfi.conf")).read()
        _, profiles = parse_config_text(conf)
        assert {"baseline-1", "baseline-2", "baseline-3", "baseline-4",
                "baseline-5"} <= set(profiles)
        path = tmp_path / "mfi.conf"
        path.write_text(conf)
        # every baseline profile maps cleanly onto the CLI surface
        for name in sorted(profiles):
            args = parse_with_config(
                build_parser(),
                ["--config", str(path), f"--profile={name}", "in.y4m"])
            assert args is not None

    def test_baseline_4_reproduces_config(self, tmp_path):
        conf = open(os.path.join(os.path.dirname(__file__), "..",
                                 "examples", "mfi.conf")).read()
        path = tmp_path / "mfi.conf"
        path.write_text(conf)
        args = parse_with_config(
            build_parser(),
            ["--config", str(path), "--profile=baseline-4", "in.y4m"])
        assert args.p010 is True and args.mode == "hsv"
        assert (args.width, args.height) == (3840, 2160)
