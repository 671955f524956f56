"""ISO-BMFF demuxer (io/mp4.py) against hand-built box fixtures.

The test-side muxer writes the structure `ffmpeg -c:v rawvideo -f mov`
produces: a VisualSampleEntry with an uncompressed fourcc, mdat chunks,
and full stts/stsz/stsc/stco sample tables.
"""

import random
import struct

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.mp4 import MP4Error, MP4Reader


def box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def full(btype: bytes, payload: bytes) -> bytes:
    return box(btype, b"\x00\x00\x00\x00" + payload)


def build_mp4(frames, w, h, fps=24.0, fourcc=b"I420", layout="i420",
              timescale=12288, per_chunk=2, payloads=None):
    def payload(f):
        y = f.y.tobytes()
        if layout == "nv12":
            return y + f.uv.tobytes()
        u, v = f.uv[:, 0::2], f.uv[:, 1::2]
        return (y + np.ascontiguousarray(u).tobytes()
                + np.ascontiguousarray(v).tobytes())

    samples = payloads if payloads is not None \
        else [payload(f) for f in frames]
    delta = int(round(timescale / fps))

    ftyp = box(b"ftyp", b"isom\x00\x00\x02\x00isomiso2")
    # mdat with all samples; chunk offsets computed after sizing moov
    mdat_payload = b"".join(samples)

    entry = (struct.pack(">I", 86) + fourcc + b"\x00" * 6
             + struct.pack(">H", 1)                 # data_reference_index
             + b"\x00" * 16
             + struct.pack(">HH", w, h)
             + b"\x00" * 50)
    stsd = full(b"stsd", struct.pack(">I", 1) + entry)
    stts = full(b"stts", struct.pack(">III", 1, len(samples), delta))
    stsz = full(b"stsz", struct.pack(">II", 0, len(samples))
                + b"".join(struct.pack(">I", len(s)) for s in samples))
    n_chunks = (len(samples) + per_chunk - 1) // per_chunk
    stsc = full(b"stsc", struct.pack(">I", 1)
                + struct.pack(">III", 1, per_chunk, 1))

    def build(chunk_offsets):
        stco = full(b"stco", struct.pack(">I", n_chunks)
                    + b"".join(struct.pack(">I", o) for o in chunk_offsets))
        stbl = box(b"stbl", stsd + stts + stsz + stsc + stco)
        minf = box(b"minf", stbl)
        mdhd = full(b"mdhd", struct.pack(">IIII", 0, 0, timescale, 0)
                    + struct.pack(">HH", 0x55C4, 0))
        hdlr = full(b"hdlr", b"\x00" * 4 + b"vide" + b"\x00" * 12)
        mdia = box(b"mdia", mdhd + hdlr + minf)
        trak = box(b"trak", mdia)
        mvhd = full(b"mvhd", b"\x00" * 96)
        moov = box(b"moov", mvhd + trak)
        return moov

    moov = build([0] * n_chunks)          # size it first
    base = len(ftyp) + len(moov) + 8      # mdat payload start
    offsets = []
    off = base
    for ci in range(n_chunks):
        offsets.append(off)
        for s in samples[ci * per_chunk:(ci + 1) * per_chunk]:
            off += len(s)
    moov = build(offsets)
    return ftyp + moov + box(b"mdat", mdat_payload)


@pytest.fixture()
def frames(small_cfg):
    return list(synthetic.moving_box(small_cfg, 7))


def write_tmp(tmp_path, data, name="t.mp4"):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


class TestMP4Reader:
    @pytest.mark.parametrize("fourcc,layout", [(b"I420", "i420"),
                                               (b"NV12", "nv12")])
    def test_roundtrip(self, tmp_path, frames, fourcc, layout):
        path = write_tmp(tmp_path, build_mp4(frames, 64, 48, fourcc=fourcc,
                                             layout=layout))
        rdr = MP4Reader(path)
        assert (rdr.width, rdr.height) == (64, 48)
        assert rdr.fps == pytest.approx(24.0, rel=1e-3)
        got = list(rdr)
        assert len(got) == 7
        for a, b in zip(frames, got):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.uv, b.uv)
        for i, f in enumerate(got):
            assert f.pts == pytest.approx(i / 24.0, abs=1e-3)
        rdr.close()

    def test_seek(self, tmp_path, frames):
        path = write_tmp(tmp_path, build_mp4(frames, 64, 48))
        rdr = MP4Reader(path)
        assert rdr.seekable() and rdr.n_frames() == 7
        rdr.seek_pts(5 / 24.0)
        got = list(rdr)
        assert len(got) == 2
        np.testing.assert_array_equal(got[0].y, frames[5].y)
        rdr.close()

    def test_single_sample_chunks(self, tmp_path, frames):
        path = write_tmp(tmp_path, build_mp4(frames, 64, 48, per_chunk=1))
        assert len(list(MP4Reader(path))) == 7

    def test_compressed_codec_rejected(self, tmp_path, frames):
        path = write_tmp(tmp_path, build_mp4(frames[:1], 64, 48,
                                             fourcc=b"avc1"))
        with pytest.raises(MP4Error, match="avc1"):
            MP4Reader(path)

    def test_not_mp4_rejected(self, tmp_path):
        path = write_tmp(tmp_path, b"\x1aE\xdf\xa3" + b"x" * 64)
        with pytest.raises(MP4Error):
            MP4Reader(path)

    def test_fuzz_truncations_and_mutations(self, tmp_path, frames):
        data = build_mp4(frames[:3], 64, 48)
        r = random.Random(13)
        for cut in range(0, len(data), max(len(data) // 50, 1)):
            path = write_tmp(tmp_path, data[:cut], "fz.mp4")
            try:
                list(MP4Reader(path))
            except (MP4Error, struct.error):
                pass
        for _ in range(300):
            mutated = bytearray(data)
            for _ in range(r.randint(1, 8)):
                mutated[r.randrange(len(mutated))] = r.randrange(256)
            path = write_tmp(tmp_path, bytes(mutated), "fz2.mp4")
            try:
                out = list(MP4Reader(path))
                assert len(out) <= 3
            except (MP4Error, struct.error):
                pass


class TestCLIIntegration:
    def test_cli_source_resolution(self, tmp_path, frames):
        from mpv_frame_interpolator.cli import make_source, build_parser
        from mpv_frame_interpolator.options import parse_with_config
        path = write_tmp(tmp_path, build_mp4(frames, 64, 48))
        args = parse_with_config(build_parser(), ["--no-config", path])
        src, w, h = make_source(args)
        assert (w, h) == (64, 48)
        assert len(list(src)) == 7
