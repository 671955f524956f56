"""Playlist playback (io/playlist.ChainedSource; mp_play_files /
--playlist analog): gapless pts timeline, per-entry autoconvert, CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.playlist import (ChainedSource,
                                                    parse_playlist)
from mpv_frame_interpolator.io.y4m import Y4MReader, Y4MWriter


def write_y4m(path, n=6, w=64, h=48, fps=24.0, seed=1):
    cfg = synthetic.SyntheticConfig(width=w, height=h, fps=fps, seed=seed)
    frames = list(synthetic.moving_box(cfg, n))
    with open(path, "wb") as fh:
        wtr = Y4MWriter(fh, w, h, fps)
        for f in frames:
            wtr.write(f)
    return frames


def opener(path):
    return Y4MReader(open(path, "rb"))


class TestChainedSource:
    def test_gapless_pts(self, tmp_path):
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        write_y4m(a, n=5)
        write_y4m(b, n=4)
        frames = list(ChainedSource([str(a), str(b)], opener))
        assert len(frames) == 9
        pts = [f.pts for f in frames]
        dt = 1 / 24.0
        for i, (x, y) in enumerate(zip(pts, pts[1:])):
            assert y - x == pytest.approx(dt, abs=1e-9), (i, x, y)

    def test_content_in_order(self, tmp_path):
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        fa = write_y4m(a, n=3, seed=1)
        fb = write_y4m(b, n=3, seed=9)
        out = list(ChainedSource([str(a), str(b)], opener))
        np.testing.assert_array_equal(out[2].y, fa[2].y)
        np.testing.assert_array_equal(out[3].y, fb[0].y)

    def test_mixed_geometry_rescaled(self, tmp_path):
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        write_y4m(a, n=3, w=64, h=48)
        write_y4m(b, n=3, w=32, h=24)
        out = list(ChainedSource([str(a), str(b)], opener))
        assert all(f.fmt.width == 64 and f.fmt.height == 48 for f in out)
        assert len(out) == 6

    def test_mixed_rates_keep_entry_cadence(self, tmp_path):
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        write_y4m(a, n=3, fps=24.0)
        write_y4m(b, n=3, fps=30.0)
        pts = [f.pts for f in ChainedSource([str(a), str(b)], opener)]
        assert pts[2] - pts[1] == pytest.approx(1 / 24.0, abs=1e-9)
        assert pts[4] - pts[3] == pytest.approx(1 / 30.0, abs=1e-9)
        # the splice gap carries the OUTGOING entry's interval
        assert pts[3] - pts[2] == pytest.approx(1 / 24.0, abs=1e-9)

    def test_loop_playlist(self, tmp_path):
        a = tmp_path / "a.y4m"
        write_y4m(a, n=2)
        src = ChainedSource([str(a)], opener, loop=2)
        frames = list(src)
        assert len(frames) == 6
        pts = [f.pts for f in frames]
        assert all(b - a == pytest.approx(1 / 24.0, abs=1e-9)
                   for a, b in zip(pts, pts[1:]))

    def test_empty_playlist_rejected(self):
        with pytest.raises(ValueError):
            ChainedSource([], opener)


class TestCLIPlaylist:
    def test_two_files_gapless(self, tmp_path):
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        out = tmp_path / "out.y4m"
        write_y4m(a, n=4)
        write_y4m(b, n=4)
        r = subprocess.run(
            [sys.executable, "-m", "mpv_frame_interpolator",
             str(a), str(b), "--untimed", "--no-resume",
             "--display-fps", "24", "--frames", "0", "-o", str(out)],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ))
        assert r.returncode == 0, r.stderr[-2000:]
        got = list(Y4MReader(open(out, "rb")))
        assert len(got) >= 7        # both files' frames made it out

    def test_playlist_file(self, tmp_path):
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        write_y4m(a, n=3)
        write_y4m(b, n=3)
        lst = tmp_path / "list.txt"
        lst.write_text(f"# comment\n{b}\n")
        out = tmp_path / "out.y4m"
        r = subprocess.run(
            [sys.executable, "-m", "mpv_frame_interpolator",
             str(a), "--playlist", str(lst), "--untimed", "--no-resume",
             "--display-fps", "24", "--frames", "0", "-o", str(out)],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ))
        assert r.returncode == 0, r.stderr[-2000:]
        got = list(Y4MReader(open(out, "rb")))
        assert len(got) >= 5


class TestParsePlaylist:
    """m3u/m3u8 + pls parsing (demux_playlist.c analog; VERDICT r4
    missing #5) with base-directory resolution for relative entries."""

    def test_plain_lines(self, tmp_path):
        lst = tmp_path / "list.txt"
        lst.write_text("# comment\na.y4m\n\n/abs/b.y4m\n")
        got = parse_playlist(str(lst))
        assert got == [str(tmp_path / "a.y4m"), "/abs/b.y4m"]

    def test_m3u(self, tmp_path):
        lst = tmp_path / "list.m3u"
        lst.write_text("#EXTM3U\n#EXTINF:10,Title A\na.y4m\n"
                       "#EXTINF:5,Title B\nsub/b.y4m\n"
                       "synthetic:moving_box\nhttp://h/c.y4m\n")
        got = parse_playlist(str(lst))
        assert got == [str(tmp_path / "a.y4m"),
                       str(tmp_path / "sub" / "b.y4m"),
                       "synthetic:moving_box", "http://h/c.y4m"]

    def test_pls(self, tmp_path):
        lst = tmp_path / "list.pls"
        lst.write_text("[playlist]\nNumberOfEntries=2\n"
                       "File2=b.y4m\nTitle2=B\n"
                       "File1=a.y4m\nTitle1=A\nVersion=2\n")
        got = parse_playlist(str(lst))
        # FileN order, not file order
        assert got == [str(tmp_path / "a.y4m"), str(tmp_path / "b.y4m")]

    def test_pls_detected_by_header_without_extension(self, tmp_path):
        lst = tmp_path / "list.txt"
        lst.write_text("[playlist]\nFile1=a.y4m\n")
        assert parse_playlist(str(lst)) == [str(tmp_path / "a.y4m")]


class TestEDL:
    """mpv EDL v0 timelines (demux/demux_edl.c analog)."""

    def test_parse_positional_and_named(self, tmp_path):
        from mpv_frame_interpolator.io.playlist import (EDLEntry,
                                                            parse_playlist)
        p = tmp_path / "t.edl"
        p.write_text("# mpv EDL v0\n"
                     "a.y4m,1,2\n"
                     "b.y4m,start=0.5,length=1.5\n"
                     "c.y4m\n")
        got = parse_playlist(str(p))
        assert [type(e) for e in got] == [EDLEntry] * 3
        assert got[0].start == 1 and got[0].length == 2
        assert got[1].start == 0.5 and got[1].length == 1.5
        assert got[2].start == 0 and got[2].length is None
        assert got[0].path == str(tmp_path / "a.y4m")

    def test_parse_quoted_filename(self, tmp_path):
        from mpv_frame_interpolator.io.playlist import parse_playlist
        p = tmp_path / "t.edl"
        p.write_text("# mpv EDL v0\n%8%a, b.y4m,2,3\n")
        (e,) = parse_playlist(str(p))
        assert e.path == str(tmp_path / "a, b.y4m")
        assert e.start == 2 and e.length == 3

    def test_suffix_detection_without_header(self, tmp_path):
        from mpv_frame_interpolator.io.playlist import parse_playlist
        p = tmp_path / "t.edl"
        p.write_text("a.y4m,0,1\n")
        (e,) = parse_playlist(str(p))
        assert e.length == 1

    def test_special_headers_rejected(self, tmp_path):
        import pytest
        from mpv_frame_interpolator.io.playlist import parse_playlist
        p = tmp_path / "t.edl"
        p.write_text("# mpv EDL v0\n!no_clip\na.y4m\n")
        with pytest.raises(ValueError, match="no_clip"):
            parse_playlist(str(p))

    def test_bad_segments_rejected(self, tmp_path):
        import pytest
        from mpv_frame_interpolator.io.playlist import parse_playlist
        for body in (",1,2\n", "a.y4m,xx\n", "a.y4m,-1\n", "a.y4m,0,0\n",
                     "# mpv EDL v0\n"):
            p = tmp_path / "t.edl"
            p.write_text("# mpv EDL v0\n" + body
                         if not body.startswith("#") else body)
            with pytest.raises(ValueError):
                parse_playlist(str(p))

    def test_clip_source_bounds_and_rebase(self, tmp_path):
        from mpv_frame_interpolator.io.playlist import ClipSource
        a = tmp_path / "a.y4m"
        frames = write_y4m(a, n=12, fps=24.0)
        # 24fps: start 4/24, length 6/24 -> frames 4..9
        clip = ClipSource(opener(str(a)), start=4 / 24, length=6 / 24)
        got = list(clip)
        assert len(got) == 6
        assert abs(got[0].pts) < 1e-6
        assert np.array_equal(got[0].y, frames[4].y)
        assert np.array_equal(got[-1].y, frames[9].y)
        clip.close()

    def test_clip_source_open_end(self, tmp_path):
        from mpv_frame_interpolator.io.playlist import ClipSource
        a = tmp_path / "a.y4m"
        write_y4m(a, n=8, fps=24.0)
        got = list(ClipSource(opener(str(a)), start=6 / 24))
        assert len(got) == 2

    def test_cli_edl_timeline(self, tmp_path):
        from mpv_frame_interpolator.cli import main
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        write_y4m(a, n=10, seed=1)
        write_y4m(b, n=10, seed=9)
        edl = tmp_path / "cut.edl"
        edl.write_text("# mpv EDL v0\n"
                       f"a.y4m,{2/24},{4/24}\n"
                       f"b.y4m,0,{3/24}\n")
        out = tmp_path / "out.y4m"
        rc = main([str(edl), "--untimed", "--model", "repeat",
                   "-o", str(out), "--display-fps", "24"])
        assert rc == 0
        got = list(Y4MReader(open(out, "rb")))
        assert len(got) == 7            # 4 + 3 segment frames at 24->24
