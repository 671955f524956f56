"""Piped-container ingest (VERDICT r2 missing #4).

A container on stdin cannot be indexed in place (no random access), so
the CLI sniffs the magic bytes, spools the byte stream to a temp file
(the demux cache's make-pipes-seekable move, /root/reference/demux/
cache.c, at the byte layer), and serves it through the indexed container
ingest.  y4m pipes keep their streaming fast path, with the sniffed
bytes replayed through a feeder pipe.
"""

import os
import subprocess
import sys

import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.y4m import Y4MReader

from tests.test_mkv import build_mkv


def run_stdin(data: bytes, out, extra=()):
    return subprocess.run(
        [sys.executable, "-m", "mpv_frame_interpolator", "-",
         "--untimed", "--no-resume", "--display-fps", "48",
         "-o", str(out), *extra],
        input=data, capture_output=True, timeout=600,
        env={**os.environ,
             "MFI_BG_PRECOMPILE": "0"})


@pytest.mark.parametrize("ingest", ["native", "python"])
def test_piped_mkv_plays(tmp_path, small_cfg, ingest):
    frames = list(synthetic.moving_box(small_cfg, 5))
    data = build_mkv(frames, small_cfg.width, small_cfg.height)
    out = tmp_path / "out.y4m"
    r = run_stdin(data, out, ("--ingest", ingest))
    assert r.returncode == 0, r.stderr[-2000:]
    assert b"spooled piped container" in r.stderr
    got = list(Y4MReader(open(out, "rb")))
    assert len(got) >= 9       # 5 source @24 -> 48 display


@pytest.mark.parametrize("ingest", ["native", "python"])
def test_piped_y4m_still_streams(tmp_path, small_cfg, ingest):
    import io

    from mpv_frame_interpolator.io.y4m import Y4MWriter
    buf = io.BytesIO()
    w = Y4MWriter(buf, small_cfg.width, small_cfg.height, 24.0)
    for f in synthetic.moving_box(small_cfg, 5):
        w.write(f)
    out = tmp_path / "out.y4m"
    r = run_stdin(buf.getvalue(), out, ("--ingest", ingest))
    assert r.returncode == 0, r.stderr[-2000:]
    assert b"spooled" not in r.stderr     # no container spool on y4m
    got = list(Y4MReader(open(out, "rb")))
    assert len(got) >= 9
