"""Matroska demuxer (io/mkv.py) against hand-built EBML fixtures.

The test-side muxer writes the same structure `ffmpeg -c:v rawvideo -f
matroska` produces: V_UNCOMPRESSED TrackEntry with ColourSpace fourcc,
clusters of SimpleBlocks.
"""

import io
import random
import struct

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.mkv import MKVError, MKVReader


# -- minimal EBML writer ------------------------------------------------

def vint_id(eid: int) -> bytes:
    out = []
    while eid:
        out.append(eid & 0xFF)
        eid >>= 8
    return bytes(reversed(out))


def vint_size(n: int) -> bytes:
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            val = n | (1 << (7 * length))
            return val.to_bytes(length, "big")
    raise ValueError(n)


def elem(eid: int, payload: bytes) -> bytes:
    return vint_id(eid) + vint_size(len(payload)) + payload


def uint_elem(eid: int, v: int, width: int = 0) -> bytes:
    data = v.to_bytes(max(width, (v.bit_length() + 7) // 8 or 1), "big")
    return elem(eid, data)


def simple_block(track: int, rel_ts: int, data: bytes) -> bytes:
    hdr = vint_size(track) + struct.pack(">h", rel_ts) + b"\x80"
    return elem(0xA3, hdr + data)


def build_mkv(frames, w, h, fps=24.0, codec=b"V_UNCOMPRESSED",
              colour=b"I420", layout="i420", per_cluster=3,
              payloads=None, codec_private=b""):
    ts_scale = 1000000           # 1 ms ticks
    dur_ns = int(1e9 / fps)
    header = elem(0x1A45DFA3, uint_elem(0x4286, 1))      # EBMLVersion 1
    info = elem(0x1549A966, uint_elem(0x2AD7B1, ts_scale))
    video = elem(0xE0, uint_elem(0xB0, w) + uint_elem(0xBA, h)
                 + elem(0x2EB524, colour))
    track = elem(0xAE, uint_elem(0xD7, 1) + uint_elem(0x83, 1)
                 + elem(0x86, codec)
                 + (elem(0x63A2, codec_private) if codec_private else b"")
                 + uint_elem(0x23E383, dur_ns) + video)
    tracks = elem(0x1654AE6B, track)

    def payload(f):
        y = f.y.tobytes()
        if layout == "nv12":
            return y + f.uv.tobytes()
        u, v = f.uv[:, 0::2], f.uv[:, 1::2]
        return (y + np.ascontiguousarray(u).tobytes()
                + np.ascontiguousarray(v).tobytes())

    if payloads is not None:          # pre-encoded samples (e.g. MJPEG)
        frames = payloads
        payload = bytes

    clusters = b""
    for c0 in range(0, len(frames), per_cluster):
        chunk = frames[c0:c0 + per_cluster]
        cluster_ts = int(c0 / fps * 1000)
        body = uint_elem(0xE7, cluster_ts)
        for k, f in enumerate(chunk):
            abs_ms = int((c0 + k) / fps * 1000)
            body += simple_block(1, abs_ms - cluster_ts, payload(f))
        clusters += elem(0x1F43B675, body)

    segment = elem(0x18538067, info + tracks + clusters)
    return header + segment


@pytest.fixture()
def frames(small_cfg):
    return list(synthetic.moving_box(small_cfg, 7))


def write_tmp(tmp_path, data, name="t.mkv"):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


class TestMKVReader:
    @pytest.mark.parametrize("colour,layout", [(b"I420", "i420"),
                                               (b"NV12", "nv12")])
    def test_roundtrip(self, tmp_path, frames, colour, layout):
        path = write_tmp(tmp_path, build_mkv(frames, 64, 48, colour=colour,
                                             layout=layout))
        rdr = MKVReader(path)
        assert (rdr.width, rdr.height) == (64, 48)
        assert rdr.fps == pytest.approx(24.0, rel=1e-3)
        got = list(rdr)
        assert len(got) == 7
        for a, b in zip(frames, got):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.uv, b.uv)
        # pts on the 24 fps grid (ms-quantized container ticks)
        for i, f in enumerate(got):
            assert f.pts == pytest.approx(i / 24.0, abs=2e-3)
        rdr.close()

    def test_seek(self, tmp_path, frames):
        path = write_tmp(tmp_path, build_mkv(frames, 64, 48))
        rdr = MKVReader(path)
        assert rdr.seekable() and rdr.n_frames() == 7
        rdr.seek_pts(5 / 24.0)
        got = list(rdr)
        assert len(got) == 2
        np.testing.assert_array_equal(got[0].y, frames[5].y)
        rdr.seek_frame(0)
        assert len(list(rdr)) == 7
        rdr.close()

    def test_compressed_codec_rejected(self, tmp_path, frames):
        path = write_tmp(tmp_path, build_mkv(frames[:1], 64, 48,
                                             codec=b"V_MPEG4/ISO/AVC"))
        with pytest.raises(MKVError, match="V_MPEG4/ISO/AVC"):
            MKVReader(path)

    def test_not_mkv_rejected(self, tmp_path):
        path = write_tmp(tmp_path, b"YUV4MPEG2 W2 H2\n" + b"x" * 64)
        with pytest.raises(MKVError):
            MKVReader(path)

    def test_fuzz_truncations_and_mutations(self, tmp_path, frames):
        """Hostile container bytes: typed error or clean result, never an
        unhandled exception (fuzzer_load.c analog for the demuxer)."""
        data = build_mkv(frames[:3], 64, 48)
        r = random.Random(11)
        for cut in range(0, len(data), max(len(data) // 60, 1)):
            path = write_tmp(tmp_path, data[:cut], "fz.mkv")
            try:
                list(MKVReader(path))
            except (MKVError, struct.error):
                pass
        for _ in range(300):
            mutated = bytearray(data)
            for _ in range(r.randint(1, 8)):
                mutated[r.randrange(len(mutated))] = r.randrange(256)
            path = write_tmp(tmp_path, bytes(mutated), "fz2.mkv")
            try:
                frames_out = list(MKVReader(path))
                assert len(frames_out) <= 3
            except (MKVError, struct.error):
                pass


class TestPipelineIntegration:
    def test_cli_source_resolution(self, tmp_path, frames):
        from mpv_frame_interpolator.cli import make_source, build_parser
        from mpv_frame_interpolator.options import parse_with_config
        path = write_tmp(tmp_path, build_mkv(frames, 64, 48))
        args = parse_with_config(build_parser(), ["--no-config", path])
        src, w, h = make_source(args)
        assert (w, h) == (64, 48)
        assert len(list(src)) == 7
