"""JPEG decoder (native/jpeg.cpp + io/jpeg.py) and the MJPEG media paths.

Golden model: Pillow/libjpeg.  JPEG decoding is not bit-exact across
conforming decoders (T.81 only bounds IDCT error), so luma is compared
with a small absolute tolerance; chroma strictly only where no upsample
filter is involved (4:4:4, uniform images).

Container tests: MKV V_MJPEG, MP4 'jpeg', and AVI 'MJPG' (io/avi.py)
fixtures are built in-test, mirroring what ffmpeg-muxed capture files
look like.  Reference analog for all of it: vd_lavc.c delegating to
libavcodec's MJPEG decoder.
"""

import io as _io
import struct

import numpy as np
import pytest

from mpv_frame_interpolator.io import jpeg as jpeg_mod
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.avi import AVIError, AVIReader
from mpv_frame_interpolator.io.jpeg import (decode_jpeg_frame,
                                                decode_jpeg_planes,
                                                mjpeg_source,
                                                split_jpeg_stream)

PIL = pytest.importorskip("PIL.Image")


def pil_jpeg(arr_rgb: np.ndarray, quality=90, subsampling=2, **kw) -> bytes:
    img = PIL.fromarray(arr_rgb, "RGB")
    buf = _io.BytesIO()
    img.save(buf, "JPEG", quality=quality, subsampling=subsampling, **kw)
    return buf.getvalue()


def pil_ycc(data: bytes) -> np.ndarray:
    return np.asarray(PIL.open(_io.BytesIO(data)).convert("YCbCr"))


def smooth_rgb(w, h, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (max(h // 8, 1) + 1, max(w // 8, 1) + 1, 3),
                        dtype=np.uint8)
    return np.asarray(PIL.fromarray(base, "RGB").resize((w, h),
                                                        PIL.BILINEAR))


class TestDecodeJpeg:
    @pytest.mark.parametrize("w,h,subs,q", [
        (64, 48, 2, 90),     # 4:2:0
        (65, 47, 2, 75),     # odd dims
        (128, 96, 0, 95),    # 4:4:4
        (32, 32, 1, 85),     # 4:2:2
        (63, 33, 2, 50),     # low quality, odd
        (8, 8, 0, 95),       # single block
    ])
    def test_luma_matches_libjpeg(self, w, h, subs, q):
        data = pil_jpeg(smooth_rgb(w, h), quality=q, subsampling=subs)
        y, u, v = decode_jpeg_planes(data)
        assert y.shape == (h, w)
        ref = pil_ycc(data)
        dy = np.abs(ref[:, :, 0].astype(int) - y.astype(int))
        # independent-IDCT tolerance: coarser quantization (lower q)
        # scales the dequantized coefficients and with them the
        # float-vs-islow rounding divergence
        assert dy.max() <= (5 if q <= 50 else 3)
        assert dy.mean() < 1.0
        assert np.percentile(dy, 99) <= 2

    def test_chroma_444_strict(self):
        # 4:4:4: PIL's YCbCr has no upsample filter, so our 2x2 box
        # downsample is directly comparable
        data = pil_jpeg(smooth_rgb(64, 48, 3), quality=95, subsampling=0)
        _, u, v = decode_jpeg_planes(data)
        ref = pil_ycc(data).astype(np.uint16)

        def ds(p):
            return ((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                     + p[1::2, 1::2] + 2) >> 2).astype(int)

        assert np.abs(ds(ref[:, :, 1]) - u.astype(int)).max() <= 3
        assert np.abs(ds(ref[:, :, 2]) - v.astype(int)).max() <= 3

    def test_uniform_420_chroma_exact(self):
        img = PIL.new("RGB", (64, 48), (200, 30, 90))
        buf = _io.BytesIO()
        img.save(buf, "JPEG", quality=90, subsampling=2)
        y, u, v = decode_jpeg_planes(buf.getvalue())
        ref = pil_ycc(buf.getvalue())
        assert abs(int(y.mean()) - int(ref[:, :, 0].mean())) <= 1
        assert u.max() - u.min() == 0 and v.max() - v.min() == 0
        assert abs(int(u[0, 0]) - int(ref[:, :, 1].mean())) <= 1
        assert abs(int(v[0, 0]) - int(ref[:, :, 2].mean())) <= 1

    def test_grayscale(self):
        rng = np.random.default_rng(1)
        arr = rng.integers(0, 255, (40, 56), dtype=np.uint8)
        buf = _io.BytesIO()
        PIL.fromarray(arr, "L").save(buf, "JPEG", quality=90)
        y, u, v = decode_jpeg_planes(buf.getvalue())
        ref = np.asarray(PIL.open(_io.BytesIO(buf.getvalue())))
        assert np.abs(y.astype(int) - ref.astype(int)).max() <= 3
        assert (u == 128).all() and (v == 128).all()

    def test_missing_dht_uses_annex_k_defaults(self):
        # the AVI "MJPG" convention: strip every DHT segment; the
        # Annex K default tables must reproduce the identical image
        # (libjpeg writes exactly those tables at quality encode)
        full = pil_jpeg(smooth_rgb(48, 32, 2), quality=85)
        stripped = bytearray(full[:2])
        i = 2
        while i < len(full):
            assert full[i] == 0xFF
            m = full[i + 1]
            if m in (0xD9, 0xDA):
                stripped += full[i:]
                break
            ln = (full[i + 2] << 8) | full[i + 3]
            if m != 0xC4:
                stripped += full[i:i + 2 + ln]
            i += 2 + ln
        a = decode_jpeg_planes(full)
        b = decode_jpeg_planes(bytes(stripped))
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)

    def test_restart_markers(self):
        rgb = smooth_rgb(128, 96, 4)
        try:
            with_dri = pil_jpeg(rgb, quality=90, restart_marker_blocks=2)
        except TypeError:
            pytest.skip("Pillow without restart_marker_blocks")
        assert b"\xff\xdd" in with_dri
        plain = pil_jpeg(rgb, quality=90)
        a = decode_jpeg_planes(with_dri)
        b = decode_jpeg_planes(plain)
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)

    def test_progressive_rejected(self):
        """The NATIVE baseline decoder must refuse SOF2 rather than
        silently mis-decode; the Pillow fallback decodes progressive
        correctly via libjpeg, so rejection only applies when the
        extension is built."""
        from mpv_frame_interpolator.native import HAVE_NATIVE, _native
        if not (HAVE_NATIVE and hasattr(_native, "decode_jpeg")):
            pytest.skip("native decoder absent; Pillow fallback "
                        "legitimately decodes progressive JPEG")
        data = pil_jpeg(smooth_rgb(32, 32), quality=90, progressive=True)
        with pytest.raises(ValueError):
            decode_jpeg_planes(data)

    def test_garbage_raises_not_crashes(self):
        rng = np.random.default_rng(7)
        good = pil_jpeg(smooth_rgb(32, 24), quality=80)
        for i in range(300):
            b = bytearray(good[: rng.integers(4, len(good))])
            for _ in range(rng.integers(0, 5)):
                b[rng.integers(0, len(b))] = rng.integers(0, 256)
            try:
                decode_jpeg_planes(bytes(b))
            except ValueError:
                pass

    def test_frame_pads_odd_dims_to_even_nv12(self):
        data = pil_jpeg(smooth_rgb(65, 47), quality=90)
        f = decode_jpeg_frame(data, pts=1.25, nominal_fps=24.0)
        assert (f.fmt.width, f.fmt.height) == (66, 48)
        assert f.y.shape == (48, 66) and f.uv.shape == (24, 66)
        assert f.pts == 1.25 and f.nominal_fps == 24.0

    def test_pil_fallback_close_to_native(self, monkeypatch):
        if not jpeg_mod.HAVE_NATIVE:
            pytest.skip("native extension not built")
        data = pil_jpeg(smooth_rgb(64, 48, 5), quality=90)
        y_n, u_n, v_n = decode_jpeg_planes(data)
        monkeypatch.setattr(jpeg_mod, "HAVE_NATIVE", False)
        y_p, u_p, v_p = jpeg_mod.decode_jpeg_planes(data)
        assert np.abs(y_n.astype(int) - y_p.astype(int)).max() <= 3
        # chroma goes through different upsample/downsample filters;
        # bound the mean, not the per-pixel max
        assert np.abs(u_n.astype(int) - u_p.astype(int)).mean() < 4
        assert np.abs(v_n.astype(int) - v_p.astype(int)).mean() < 4


class TestMJPEGStream:
    def test_split_and_source(self, tmp_path):
        datas = [pil_jpeg(smooth_rgb(48, 32, s), quality=85)
                 for s in range(5)]
        blob = b"".join(datas)
        got = list(split_jpeg_stream(_io.BytesIO(blob).read))
        assert got == datas
        p = tmp_path / "cam.mjpeg"
        p.write_bytes(blob)
        frames = list(mjpeg_source(str(p), fps=10.0))
        assert len(frames) == 5
        assert frames[0].y.shape == (32, 48)
        assert frames[3].pts == pytest.approx(0.3)
        assert frames[0].nominal_fps == 10.0

    def test_split_skips_leading_garbage(self):
        data = pil_jpeg(smooth_rgb(16, 16), quality=85)
        got = list(split_jpeg_stream(_io.BytesIO(b"junk" * 7 + data).read))
        assert got == [data]


class TestMKVMJPEG:
    def test_v_mjpeg_track(self, tmp_path):
        from test_mkv import build_mkv
        datas = [pil_jpeg(smooth_rgb(64, 48, s), quality=90)
                 for s in range(4)]
        mkv = build_mkv(None, 64, 48, codec=b"V_MJPEG", payloads=datas)
        p = tmp_path / "m.mkv"
        p.write_bytes(mkv)
        from mpv_frame_interpolator.io.mkv import MKVReader
        rdr = MKVReader(str(p))
        assert (rdr.width, rdr.height) == (64, 48)
        frames = list(rdr)
        assert len(frames) == 4
        for i, (f, data) in enumerate(zip(frames, datas)):
            y, _, _ = decode_jpeg_planes(data)
            np.testing.assert_array_equal(f.y, y)
            assert f.pts == pytest.approx(i / 24.0, abs=2e-3)
        rdr.close()


class TestMP4MJPEG:
    def test_jpeg_sample_entry(self, tmp_path):
        from test_mp4 import build_mp4
        datas = [pil_jpeg(smooth_rgb(64, 48, s), quality=90)
                 for s in range(4)]
        mp4 = build_mp4(None, 64, 48, fourcc=b"jpeg", payloads=datas)
        p = tmp_path / "m.mp4"
        p.write_bytes(mp4)
        from mpv_frame_interpolator.io.mp4 import MP4Reader
        rdr = MP4Reader(str(p))
        frames = list(rdr)
        assert len(frames) == 4
        y, _, _ = decode_jpeg_planes(datas[2])
        np.testing.assert_array_equal(frames[2].y, y)
        rdr.close()


# -- AVI ------------------------------------------------------------------

def build_avi(samples, w, h, fps=24.0, fourcc=b"MJPG", with_idx1=True,
              abs_offsets=False, handler=None, extradata=b""):
    """Minimal AVI muxer: one video stream, 00dc chunks, optional idx1.
    `extradata` is appended after the 40-byte BITMAPINFOHEADER (the VfW
    codec-private convention, e.g. Ut Video's 16-byte stream config)."""
    def chunk(four, payload):
        return four + struct.pack("<I", len(payload)) + payload \
            + (b"\x00" if len(payload) & 1 else b"")

    def lst(ltype, payload):
        return chunk(b"LIST", ltype + payload)

    avih = struct.pack("<IIIIIIIIII", int(1e6 / fps), 0, 0, 0x10,
                       len(samples), 0, 1, 0, w, h) + b"\x00" * 16
    strh = (b"vids" + (handler or fourcc)
            + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1000,
                          int(fps * 1000), 0, len(samples), 0, 0, 0)
            + struct.pack("<HHHH", 0, 0, w, h))
    strf = struct.pack("<iiiHH4sIiiII", 40 + len(extradata), w, h, 1, 24,
                       fourcc, w * h * 3, 0, 0, 0, 0) + extradata
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi_payload = b"movi"
    offsets = []        # offset of each chunk header relative to 'movi'
    for s in samples:
        offsets.append(len(movi_payload))
        movi_payload += chunk(b"00dc", s)
    movi = chunk(b"LIST", movi_payload)
    body = hdrl + movi
    if with_idx1:
        movi_hdr_pos = 12 + len(hdrl)       # file offset of movi LIST hdr
        idx = b""
        for off, s in zip(offsets, samples):
            o = (movi_hdr_pos + 8 + off) if abs_offsets else off
            idx += b"00dc" + struct.pack("<III", 0x10, o, len(s))
        body += chunk(b"idx1", idx)
    riff = b"RIFF" + struct.pack("<I", len(body) + 4) + b"AVI " + body
    return riff


def raw_i420(f):
    u, v = f.uv[:, 0::2], f.uv[:, 1::2]
    return (f.y.tobytes() + np.ascontiguousarray(u).tobytes()
            + np.ascontiguousarray(v).tobytes())


class TestAVI:
    @pytest.mark.parametrize("with_idx1,abs_offsets", [
        (True, False), (True, True), (False, False)])
    def test_mjpeg_roundtrip(self, tmp_path, with_idx1, abs_offsets):
        datas = [pil_jpeg(smooth_rgb(64, 48, s), quality=90)
                 for s in range(5)]
        p = tmp_path / "a.avi"
        p.write_bytes(build_avi(datas, 64, 48, with_idx1=with_idx1,
                                abs_offsets=abs_offsets))
        rdr = AVIReader(str(p))
        assert (rdr.width, rdr.height) == (64, 48)
        assert rdr.fps == pytest.approx(24.0, rel=1e-3)
        frames = list(rdr)
        assert len(frames) == 5
        for i, (f, data) in enumerate(zip(frames, datas)):
            y, _, _ = decode_jpeg_planes(data)
            np.testing.assert_array_equal(f.y, y)
            assert f.pts == pytest.approx(i / 24.0)
        rdr.close()

    def test_raw_i420(self, tmp_path, small_cfg):
        frames = list(synthetic.moving_box(small_cfg, 4))
        p = tmp_path / "raw.avi"
        p.write_bytes(build_avi([raw_i420(f) for f in frames], 64, 48,
                                fourcc=b"I420"))
        rdr = AVIReader(str(p))
        got = list(rdr)
        assert len(got) == 4
        for a, b in zip(frames, got):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.uv, b.uv)
        rdr.close()

    def test_seek(self, tmp_path):
        datas = [pil_jpeg(smooth_rgb(32, 32, s), quality=85)
                 for s in range(6)]
        p = tmp_path / "s.avi"
        p.write_bytes(build_avi(datas, 32, 32))
        rdr = AVIReader(str(p))
        assert rdr.seekable() and rdr.n_frames() == 6
        pts = rdr.seek_pts(4 / 24.0)
        assert pts == pytest.approx(4 / 24.0)
        got = list(rdr)
        assert len(got) == 2
        y, _, _ = decode_jpeg_planes(datas[4])
        np.testing.assert_array_equal(got[0].y, y)
        rdr.close()

    def test_zero_size_chunk_repeats_previous(self, tmp_path):
        datas = [pil_jpeg(smooth_rgb(32, 32, s), quality=85)
                 for s in range(2)]
        samples = [datas[0], b"", datas[1]]
        p = tmp_path / "r.avi"
        p.write_bytes(build_avi(samples, 32, 32))
        rdr = AVIReader(str(p))
        got = list(rdr)
        assert len(got) == 3
        np.testing.assert_array_equal(got[0].y, got[1].y)
        assert got[1].pts == pytest.approx(1 / 24.0)
        rdr.close()

    def test_unknown_codec_raises(self, tmp_path):
        p = tmp_path / "x.avi"
        p.write_bytes(build_avi([b"\x00" * 64], 32, 32, fourcc=b"H264"))
        with pytest.raises(AVIError, match="external decoder"):
            AVIReader(str(p))

    def test_not_avi_raises(self, tmp_path):
        p = tmp_path / "n.avi"
        p.write_bytes(b"RIFF\x10\x00\x00\x00WAVEdata")
        with pytest.raises(AVIError):
            AVIReader(str(p))
