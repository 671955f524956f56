"""Ut Video codec (io/utvideo.py + native/utvideo.cpp) and its AVI/MKV
integration.

The reference decodes Ut Video via libavcodec (vd_lavc.c:1157-1388);
the rebuild carries its own implementation.  No reference encoder
exists in this environment, so compliance is proven structurally: the
pure-Python codec is the oracle (round-trip over every prediction mode
/ slice count / fourcc), the native C++ decoder must match it
bit-exactly, and both must reject arbitrary corruption with ValueError
(never crash)."""

import random
import struct

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic, utvideo as ut


def _planes(fourcc, w, h, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, (pw, ph) in enumerate(ut.plane_dims(fourcc, w, h)):
        if i == 0:   # realistic luma: smooth gradient + noise
            base = np.add.outer(np.arange(ph), np.arange(pw)) % 256
            out.append(((base + rng.integers(0, 8, (ph, pw))) % 256
                        ).astype(np.uint8))
        else:
            out.append(rng.integers(100, 160, (ph, pw)).astype(np.uint8))
    return out


class TestPythonCodec:
    @pytest.mark.parametrize("fourcc,w,h", [("ULY0", 64, 48),
                                            ("ULY2", 62, 47),
                                            ("ULH0", 32, 32)])
    @pytest.mark.parametrize("pred", [ut.PRED_NONE, ut.PRED_LEFT,
                                      ut.PRED_GRADIENT, ut.PRED_MEDIAN])
    def test_roundtrip(self, fourcc, w, h, pred):
        planes = _planes(fourcc, w, h)
        for slices in (1, 3):
            pkt = ut.encode_frame(planes, slices=slices, pred=pred)
            got = ut.decode_frame(pkt, fourcc, w, h, slices)
            for a, b in zip(planes, got):
                np.testing.assert_array_equal(a, b)

    def test_single_symbol_plane(self):
        planes = _planes("ULY0", 64, 48)
        planes[1][:] = 128
        pkt = ut.encode_frame(planes, slices=4, pred=ut.PRED_MEDIAN)
        got = ut.decode_frame(pkt, "ULY0", 64, 48, 4)
        for a, b in zip(planes, got):
            np.testing.assert_array_equal(a, b)

    def test_extradata_roundtrip(self):
        xd = ut.make_extradata(8)
        assert ut.parse_extradata(xd) == (8, False)
        with pytest.raises(ut.UtVideoError):
            ut.parse_extradata(xd[:12])
        # interlaced flag (bit 11)
        flags = struct.unpack_from("<I", xd, 8)[0] | 0x800
        xd2 = xd[:8] + struct.pack("<I", flags) + xd[12:]
        assert ut.parse_extradata(xd2) == (8, True)

    def test_decode_to_nv12_422_averages_chroma(self):
        planes = _planes("ULY2", 64, 48)
        pkt = ut.encode_frame(planes, slices=2, pred=ut.PRED_LEFT)
        y, uv = ut.decode_to_nv12(pkt, "ULY2", 64, 48, 2)
        assert y.shape == (48, 64) and uv.shape == (24, 64)
        up = planes[1].astype(np.uint16)
        want_u = ((up[0::2] + up[1::2] + 1) >> 1).astype(np.uint8)
        np.testing.assert_array_equal(uv[:, 0::2], want_u)


class TestNativeParity:
    @pytest.fixture(autouse=True)
    def _need_native(self):
        if not ut.have_native():
            pytest.skip("native extension not built")

    @pytest.mark.parametrize("fourcc,w,h", [("ULY0", 96, 64),
                                            ("ULY2", 96, 63)])
    def test_matches_python_oracle(self, fourcc, w, h):
        from mpv_frame_interpolator.native import _native
        planes = _planes(fourcc, w, h, seed=5)
        for pred in (0, 1, 2, 3):
            for slices in (1, 5):
                pkt = ut.encode_frame(planes, slices=slices, pred=pred)
                ref = ut.decode_frame(pkt, fourcc, w, h, slices)
                got = _native.decode_utvideo(pkt, fourcc, w, h, slices)
                for a, b in zip(ref, got):
                    np.testing.assert_array_equal(
                        a, np.frombuffer(b, np.uint8).reshape(a.shape))

    def test_fuzz_never_crashes(self):
        from mpv_frame_interpolator.native import _native
        planes = _planes("ULY0", 64, 48, seed=9)
        pkt = bytearray(ut.encode_frame(planes, slices=3,
                                        pred=ut.PRED_MEDIAN))
        rng = random.Random(4)
        for _ in range(1500):
            b = bytearray(pkt)
            if rng.random() < 0.5:
                b = b[:rng.randrange(len(b))]
            else:
                for _ in range(rng.randrange(1, 6)):
                    b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
            try:
                _native.decode_utvideo(bytes(b), "ULY0", 64, 48, 3)
            except ValueError:
                pass


def _nv12_frames(n=5, w=64, h=48):
    cfg = synthetic.SyntheticConfig(width=w, height=h, fps=24.0)
    return list(synthetic.moving_box(cfg, n))


def _ut_payload(frame, slices=2, pred=ut.PRED_MEDIAN):
    u, v = frame.uv[:, 0::2], frame.uv[:, 1::2]
    return ut.encode_frame([frame.y, np.ascontiguousarray(u),
                            np.ascontiguousarray(v)],
                           slices=slices, pred=pred)


class TestAVIIntegration:
    def test_uly0_avi_plays(self, tmp_path):
        from tests.test_jpeg import build_avi
        from mpv_frame_interpolator.io.avi import AVIReader
        frames = _nv12_frames()
        samples = [_ut_payload(f) for f in frames]
        data = build_avi(samples, 64, 48, fourcc=b"ULY0",
                         extradata=ut.make_extradata(2))
        p = tmp_path / "ut.avi"
        p.write_bytes(data)
        rdr = AVIReader(str(p))
        got = list(rdr)
        assert len(got) == len(frames)
        for a, b in zip(frames, got):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.uv, b.uv)
        rdr.close()

    def test_missing_extradata_rejected(self, tmp_path):
        from tests.test_jpeg import build_avi
        from mpv_frame_interpolator.io.avi import AVIError, AVIReader
        frames = _nv12_frames(2)
        data = build_avi([_ut_payload(f) for f in frames], 64, 48,
                         fourcc=b"ULY0")
        p = tmp_path / "bad.avi"
        p.write_bytes(data)
        with pytest.raises(AVIError, match="stream header"):
            AVIReader(str(p))

    def test_interlaced_rejected(self, tmp_path):
        from tests.test_jpeg import build_avi
        from mpv_frame_interpolator.io.avi import AVIError, AVIReader
        xd = bytearray(ut.make_extradata(2))
        xd[9] |= 0x08                 # flags bit 11
        frames = _nv12_frames(2)
        data = build_avi([_ut_payload(f) for f in frames], 64, 48,
                         fourcc=b"ULY0", extradata=bytes(xd))
        p = tmp_path / "il.avi"
        p.write_bytes(data)
        with pytest.raises(AVIError, match="interlaced"):
            AVIReader(str(p))


class TestMKVIntegration:
    def test_vfw_utvideo_plays(self, tmp_path):
        from tests.test_mkv import build_mkv
        from mpv_frame_interpolator.io.mkv import MKVReader
        frames = _nv12_frames()
        payloads = [_ut_payload(f, slices=3) for f in frames]
        bih = struct.pack("<iiiHH4sIiiII", 40 + 16, 64, 48, 1, 24,
                          b"ULY0", 64 * 48 * 3, 0, 0, 0, 0)
        private = bih + ut.make_extradata(3)
        data = build_mkv(None, 64, 48, codec=b"V_MS/VFW/FOURCC",
                         payloads=payloads, codec_private=private)
        p = tmp_path / "ut.mkv"
        p.write_bytes(data)
        rdr = MKVReader(str(p))
        got = list(rdr)
        assert len(got) == len(frames)
        for a, b in zip(frames, got):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.uv, b.uv)
        rdr.close()

    def test_unknown_vfw_codec_rejected(self, tmp_path):
        from tests.test_mkv import build_mkv
        from mpv_frame_interpolator.io.mkv import MKVError, MKVReader
        bih = struct.pack("<iiiHH4sIiiII", 40, 64, 48, 1, 24,
                          b"XVID", 64 * 48 * 3, 0, 0, 0, 0)
        data = build_mkv(None, 64, 48, codec=b"V_MS/VFW/FOURCC",
                         payloads=[b"x"], codec_private=bih)
        p = tmp_path / "xvid.mkv"
        p.write_bytes(data)
        with pytest.raises(MKVError, match="XVID"):
            MKVReader(str(p))


class TestPythonFuzz:
    def test_python_decoder_fuzz(self):
        planes = _planes("ULY0", 32, 32, seed=11)
        pkt = bytearray(ut.encode_frame(planes, slices=2,
                                        pred=ut.PRED_LEFT))
        rng = random.Random(8)
        for _ in range(200):          # python path is slow: small corpus
            b = bytearray(pkt)
            if rng.random() < 0.5:
                b = b[:rng.randrange(len(b))]
            else:
                for _ in range(rng.randrange(1, 6)):
                    b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
            try:
                ut.decode_frame(bytes(b), "ULY0", 32, 32, 2)
            except ValueError:
                pass
