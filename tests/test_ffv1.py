"""FFV1 (RFC 9043 v0/1) codec tests: coder roundtrips, format features,
malformed-input rejection, deterministic fuzz, and container playback
(AVI fourcc FFV1, MKV V_FFV1).  The reference plays FFV1 via libavcodec
(video/decode/vd_lavc.c:1157-1388); here io/ffv1.py is both sides of the
contract (no ffmpeg exists in this image to cross-check against --
documented in docs/DEVIATIONS.md)."""

import numpy as np
import pytest

from mpv_frame_interpolator.io import ffv1


def _planes(w, h, seed=0, smooth=True):
    rng = np.random.default_rng(seed)
    if smooth:
        y = (np.arange(h)[:, None] * 3 + np.arange(w)[None, :] * 2
             ).astype(np.uint8)
        ph, pw = h // 2 - h // 4, w // 2 - w // 4
        y[h // 4:h // 2, w // 4:w // 2] += rng.integers(
            0, 50, (ph, pw), dtype=np.uint8)
    else:
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    u = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
    v = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
    return y, u, v


class TestRangeCoder:
    def test_bit_roundtrip(self):
        rng = np.random.default_rng(1)
        bits = rng.integers(0, 2, 2000).tolist()
        enc = ffv1.RangeEncoder()
        st = bytearray([128] * 8)
        for i, b in enumerate(bits):
            enc.put(st, i % 8, int(b))
        data = enc.finish()
        dec = ffv1.RangeDecoder(data)
        st = bytearray([128] * 8)
        got = [dec.get(st, i % 8) for i in range(len(bits))]
        assert got == bits

    def test_symbol_roundtrip(self):
        rng = np.random.default_rng(2)
        vals = [0, 1, -1, 5, -127, 128, 65535, -65536] + \
            rng.integers(-10**6, 10**6, 100).tolist()
        enc = ffv1.RangeEncoder()
        st = bytearray([128] * ffv1.CONTEXT_SIZE)
        for v in vals:
            ffv1._put_symbol(enc, st, 0, int(v), True)
        dec = ffv1.RangeDecoder(enc.finish())
        st = bytearray([128] * ffv1.CONTEXT_SIZE)
        assert [ffv1._get_symbol(dec, st, 0, True) for _ in vals] == \
            [int(v) for v in vals]

    def test_unsigned_symbols(self):
        enc = ffv1.RangeEncoder()
        st = bytearray([128] * ffv1.CONTEXT_SIZE)
        for v in (0, 1, 9, 500):
            ffv1._put_symbol(enc, st, 0, v, False)
        dec = ffv1.RangeDecoder(enc.finish())
        st = bytearray([128] * ffv1.CONTEXT_SIZE)
        assert [ffv1._get_symbol(dec, st, 0, False)
                for _ in range(4)] == [0, 1, 9, 500]

    def test_short_packet_rejected(self):
        with pytest.raises(ffv1.FFV1Error):
            ffv1.RangeDecoder(b"\x00")


class TestQuantTables:
    def test_default_table_symmetry(self):
        qt = ffv1.default_quant_table(6)
        for d in range(1, 128):
            assert qt[256 - d] == -qt[d]
        assert qt[0] == 0 and qt[127] == 5

    def test_write_read_roundtrip(self):
        for levels in (2, 4, 6, 9):
            qt = ffv1.default_quant_table(levels)
            enc = ffv1.RangeEncoder()
            ffv1._write_quant_table(enc, qt)
            dec = ffv1.RangeDecoder(enc.finish())
            got = ffv1._read_quant_table(dec)
            assert np.array_equal(got, qt)

    def test_all_zero_table(self):
        qt = np.zeros(256, np.int16)
        enc = ffv1.RangeEncoder()
        ffv1._write_quant_table(enc, qt)
        dec = ffv1.RangeDecoder(enc.finish())
        assert np.array_equal(ffv1._read_quant_table(dec), qt)


class TestFrameRoundtrip:
    @pytest.mark.parametrize("w,h", [(48, 32), (36, 22), (2, 2), (64, 2)])
    def test_keyframes(self, w, h):
        y, u, v = _planes(w, h)
        pkt = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        ry, ru, rv = ffv1.FFV1Decoder(w, h).decode(pkt)
        assert np.array_equal(ry, y)
        assert np.array_equal(ru, u)
        assert np.array_equal(rv, v)

    def test_noise_frame(self):
        y, u, v = _planes(48, 32, seed=3, smooth=False)
        pkt = ffv1.FFV1Encoder(48, 32).encode([y, u, v])
        ry, ru, rv = ffv1.FFV1Decoder(48, 32).decode(pkt)
        assert np.array_equal(ry, y) and np.array_equal(ru, u) \
            and np.array_equal(rv, v)

    def test_inter_frames_chain_states(self):
        w, h = 48, 32
        frames = [_planes(w, h, seed=s) for s in range(4)]
        pkts = ffv1.encode_frames_i420(frames, w, h, all_keyframes=False)
        dec = ffv1.FFV1Decoder(w, h)
        for (y, u, v), pkt in zip(frames, pkts):
            ry, ru, rv = dec.decode(pkt)
            assert np.array_equal(ry, y) and np.array_equal(ru, u) \
                and np.array_equal(rv, v)
        # inter packets are smaller than re-keyframing the same content
        kpkts = ffv1.encode_frames_i420(frames, w, h, all_keyframes=True)
        assert sum(len(p) for p in pkts[1:]) < sum(
            len(p) for p in kpkts[1:])

    def test_inter_without_keyframe_rejected(self):
        w, h = 32, 16
        frames = [_planes(w, h, seed=s) for s in range(2)]
        pkts = ffv1.encode_frames_i420(frames, w, h, all_keyframes=False)
        dec = ffv1.FFV1Decoder(w, h)
        with pytest.raises(ffv1.FFV1Error, match="keyframe"):
            dec.decode(pkts[1])
        # reset() after a seek behaves the same as a fresh decoder
        dec2 = ffv1.FFV1Decoder(w, h)
        dec2.decode(pkts[0])
        dec2.reset()
        with pytest.raises(ffv1.FFV1Error, match="keyframe"):
            dec2.decode(pkts[1])

    def test_gray(self):
        w, h = 40, 24
        y, _, _ = _planes(w, h)
        p = ffv1.FFV1Params(chroma_planes=False)
        pkt = ffv1.FFV1Encoder(w, h, p).encode([y])
        (ry,) = ffv1.FFV1Decoder(w, h).decode(pkt)
        assert np.array_equal(ry, y)

    @pytest.mark.parametrize("hs,vs", [(1, 0), (0, 0), (2, 2)])
    def test_chroma_geometries(self, hs, vs):
        w, h = 40, 24
        y, _, _ = _planes(w, h)
        cw = (w + (1 << hs) - 1) >> hs
        ch = (h + (1 << vs) - 1) >> vs
        rng = np.random.default_rng(7)
        u = rng.integers(0, 256, (ch, cw), dtype=np.uint8)
        v = rng.integers(0, 256, (ch, cw), dtype=np.uint8)
        p = ffv1.FFV1Params(h_shift=hs, v_shift=vs)
        pkt = ffv1.FFV1Encoder(w, h, p).encode([y, u, v])
        ry, ru, rv = ffv1.FFV1Decoder(w, h).decode(pkt)
        assert np.array_equal(ry, y) and np.array_equal(ru, u) \
            and np.array_equal(rv, v)

    def test_odd_dimensions(self):
        w, h = 33, 21
        y, u, v = _planes(w, h, seed=5)
        pkt = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        ry, ru, rv = ffv1.FFV1Decoder(w, h).decode(pkt)
        assert np.array_equal(ry, y) and np.array_equal(ru, u)

    def test_five_context_model(self):
        w, h = 40, 24
        qt = ffv1.default_quant_table(6)
        q3 = ffv1.default_quant_table(3)
        p = ffv1.FFV1Params(quant_tables=[qt, qt, qt, q3, q3])
        assert p.five_context and p.context_count == 16638
        y, u, v = _planes(w, h, seed=6)
        pkt = ffv1.FFV1Encoder(w, h, p).encode([y, u, v])
        ry, ru, rv = ffv1.FFV1Decoder(w, h).decode(pkt)
        assert np.array_equal(ry, y) and np.array_equal(ru, u) \
            and np.array_equal(rv, v)

    def test_custom_state_transition(self):
        one = ffv1._ONE_STATE.astype(np.int32).copy()
        one[one == 0] = 1
        one[10:200] = np.clip(one[10:200] + 3, 1, 255)
        zero = np.zeros(256, np.int32)
        for i in range(1, 256):
            zero[256 - i] = 256 - one[i]
        p = ffv1.FFV1Params(coder_type=2, state_transition=(
            one.astype(np.uint8), zero.astype(np.uint8)))
        w, h = 40, 24
        frames = [_planes(w, h, seed=s) for s in range(2)]
        enc = ffv1.FFV1Encoder(w, h, p)
        pkts = [enc.encode(list(frames[0])),
                enc.encode(list(frames[1]), keyframe=False)]
        dec = ffv1.FFV1Decoder(w, h)
        for (y, u, v), pkt in zip(frames, pkts):
            ry, ru, rv = dec.decode(pkt)
            assert np.array_equal(ry, y) and np.array_equal(ru, u)

    def test_compresses_smooth_content(self):
        w, h = 64, 48
        y = np.tile(np.arange(w, dtype=np.uint8), (h, 1))
        u = np.full((h // 2, w // 2), 100, np.uint8)
        v = np.full((h // 2, w // 2), 200, np.uint8)
        pkt = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        assert len(pkt) < w * h * 3 // 2 // 4   # >4x on trivial content


class TestMalformed:
    def test_transparency_rejected(self):
        p = ffv1.FFV1Params(transparency=True)
        enc = ffv1.RangeEncoder()
        ffv1._write_params(enc, p)
        c = ffv1.RangeDecoder(enc.finish())
        with pytest.raises(ffv1.FFV1Error, match="transparency"):
            ffv1._read_params(c)

    def test_v2_inline_params_rejected(self):
        p = ffv1.FFV1Params(version=2)
        enc = ffv1.RangeEncoder()
        ffv1._write_params(enc, p)
        c = ffv1.RangeDecoder(enc.finish())
        with pytest.raises(ffv1.FFV1Error, match="version"):
            ffv1._read_params(c)

    def test_out_of_range_bits_rejected(self):
        with pytest.raises(ffv1.FFV1Error):
            ffv1.FFV1Params(bits=17)
        # wire-level: version=1, coder=1, colorspace=0, bits=17
        enc = ffv1.RangeEncoder()
        st = bytearray([128] * ffv1.CONTEXT_SIZE)
        for v in (1, 1, 0, 17):
            ffv1._put_symbol(enc, st, 0, v, False)
        c = ffv1.RangeDecoder(enc.finish())
        with pytest.raises(ffv1.FFV1Error, match="bit"):
            ffv1._read_params(c)

    def test_truncated_packet(self):
        w, h = 32, 16
        y, u, v = _planes(w, h)
        pkt = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        with pytest.raises(ffv1.FFV1Error):
            ffv1.FFV1Decoder(w, h).decode(pkt[:len(pkt) // 3])

    def test_fuzz_never_crashes(self):
        w, h = 32, 16
        y, u, v = _planes(w, h, seed=9)
        base = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        rng = np.random.default_rng(11)
        rejected = 0
        for _ in range(200):
            ba = bytearray(base)
            for _ in range(int(rng.integers(1, 6))):
                ba[int(rng.integers(0, len(ba)))] = int(
                    rng.integers(0, 256))
            try:
                ffv1.FFV1Decoder(w, h).decode(bytes(ba))
            except ffv1.FFV1Error:
                rejected += 1
        assert rejected > 0  # mutations overwhelmingly detected

    def test_truncation_fuzz(self):
        w, h = 32, 16
        y, u, v = _planes(w, h, seed=10)
        base = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        for cut in range(0, len(base), max(1, len(base) // 40)):
            try:
                ffv1.FFV1Decoder(w, h).decode(base[:cut])
            except ffv1.FFV1Error:
                pass


class TestNV12Glue:
    def test_420_passthrough(self):
        w, h = 40, 24
        y, u, v = _planes(w, h, seed=12)
        pkt = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        ry, ruv = ffv1.decode_to_nv12(ffv1.FFV1Decoder(w, h), pkt)
        assert np.array_equal(ry, y)
        assert np.array_equal(ruv[:, 0::2], u)
        assert np.array_equal(ruv[:, 1::2], v)

    def test_422_averages_vertically(self):
        w, h = 8, 4
        y = np.zeros((h, w), np.uint8)
        u = np.repeat(np.arange(h, dtype=np.uint8)[:, None] * 10, 4,
                      axis=1)
        v = u + 1
        p = ffv1.FFV1Params(h_shift=1, v_shift=0)
        pkt = ffv1.FFV1Encoder(w, h, p).encode([y, u, v])
        _, ruv = ffv1.decode_to_nv12(ffv1.FFV1Decoder(w, h), pkt)
        assert np.array_equal(ruv[:, 0::2],
                              np.array([[5] * 4, [25] * 4], np.uint8))

    def test_gray_neutral_chroma(self):
        w, h = 16, 8
        y, _, _ = _planes(w, h)
        p = ffv1.FFV1Params(chroma_planes=False)
        pkt = ffv1.FFV1Encoder(w, h, p).encode([y])
        ry, ruv = ffv1.decode_to_nv12(ffv1.FFV1Decoder(w, h), pkt)
        assert np.array_equal(ry, y) and (ruv == 128).all()

    def test_odd_dims_padded(self):
        w, h = 33, 21
        y, u, v = _planes(w, h, seed=13)
        pkt = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        ry, ruv = ffv1.decode_to_nv12(ffv1.FFV1Decoder(w, h), pkt)
        assert ry.shape == (22, 34) and ruv.shape == (11, 34)
        assert np.array_equal(ry[:h, :w], y)


class TestNative:
    """native/ffv1.cpp vs the Python oracle (skipped when not built)."""

    def _need_native(self):
        if not ffv1.have_native():
            pytest.skip("native extension not built")

    def test_matches_python_oracle(self):
        self._need_native()
        w, h = 48, 32
        frames = [_planes(w, h, seed=s, smooth=s % 2 == 0)
                  for s in range(4)]
        pkts = ffv1.encode_frames_i420(frames, w, h, all_keyframes=False)
        dn = ffv1.FFV1Decoder(w, h, use_native=True)
        dp = ffv1.FFV1Decoder(w, h, use_native=False)
        assert dn._native is not None and dp._native is None
        for (y, u, v), pkt in zip(frames, pkts):
            pn, pp = dn.decode(pkt), dp.decode(pkt)
            for a, b, ref in zip(pn, pp, (y, u, v)):
                assert np.array_equal(a, b) and np.array_equal(a, ref)
        assert (dn.h_shift, dn.v_shift) == (dp.h_shift, dp.v_shift)

    @pytest.mark.parametrize("hs,vs,chroma", [(1, 0, True), (0, 0, True),
                                              (1, 1, False)])
    def test_native_geometries(self, hs, vs, chroma):
        self._need_native()
        w, h = 36, 22
        y, _, _ = _planes(w, h, seed=3)
        p = ffv1.FFV1Params(chroma_planes=chroma, h_shift=hs, v_shift=vs)
        planes = [y]
        if chroma:
            rng = np.random.default_rng(4)
            cw = (w + (1 << hs) - 1) >> hs
            ch = (h + (1 << vs) - 1) >> vs
            planes += [rng.integers(0, 256, (ch, cw), dtype=np.uint8),
                       rng.integers(0, 256, (ch, cw), dtype=np.uint8)]
        pkt = ffv1.FFV1Encoder(w, h, p).encode(planes)
        got = ffv1.FFV1Decoder(w, h, use_native=True).decode(pkt)
        for a, ref in zip(got, planes):
            assert np.array_equal(a, ref)

    def test_native_reset_and_failed_decode_rollback(self):
        self._need_native()
        w, h = 32, 16
        frames = [_planes(w, h, seed=s) for s in range(3)]
        pkts = ffv1.encode_frames_i420(frames, w, h, all_keyframes=False)
        d = ffv1.FFV1Decoder(w, h, use_native=True)
        d.decode(pkts[0])
        # a truncated inter packet fails cleanly AND leaves the chain
        # state intact for the real packet
        with pytest.raises(ffv1.FFV1Error):
            d.decode(pkts[1][:10])
        got = d.decode(pkts[1])
        assert np.array_equal(got[0], frames[1][0])
        d.reset()
        with pytest.raises(ffv1.FFV1Error, match="keyframe"):
            d.decode(pkts[2])

    def test_native_fuzz_never_crashes(self):
        self._need_native()
        w, h = 32, 16
        y, u, v = _planes(w, h, seed=9)
        base = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        rng = np.random.default_rng(21)
        for _ in range(300):
            ba = bytearray(base)
            for _ in range(int(rng.integers(1, 8))):
                ba[int(rng.integers(0, len(ba)))] = int(
                    rng.integers(0, 256))
            d = ffv1.FFV1Decoder(w, h, use_native=True)
            try:
                d.decode(bytes(ba))
            except ffv1.FFV1Error:
                pass

    def test_native_truncation_fuzz(self):
        self._need_native()
        w, h = 32, 16
        y, u, v = _planes(w, h, seed=10)
        base = ffv1.FFV1Encoder(w, h).encode([y, u, v])
        for cut in range(0, len(base), max(1, len(base) // 60)):
            try:
                ffv1.FFV1Decoder(w, h, use_native=True).decode(base[:cut])
            except ffv1.FFV1Error:
                pass


class TestDeepBits:
    """bits_per_raw_sample > 8 (the P010 pipeline's archival input)."""

    @pytest.mark.parametrize("bits", [10, 12, 16])
    def test_roundtrip(self, bits):
        rng = np.random.default_rng(bits)
        w, h = 36, 22
        top = 1 << bits
        y = rng.integers(0, top, (h, w), dtype=np.uint16)
        u = rng.integers(0, top, (h // 2, w // 2), dtype=np.uint16)
        v = rng.integers(0, top, (h // 2, w // 2), dtype=np.uint16)
        p = ffv1.FFV1Params(bits=bits)
        enc = ffv1.FFV1Encoder(w, h, p)
        y2 = ((y.astype(np.uint32) + 3) % top).astype(np.uint16)
        pkts = [enc.encode([y, u, v]),
                enc.encode([y2, u, v], keyframe=False)]
        for nat in ([False, True] if ffv1.have_native() else [False]):
            d = ffv1.FFV1Decoder(w, h, use_native=nat)
            ry, ru, rv = d.decode(pkts[0])
            assert ry.dtype == np.uint16 and d.bits == bits
            assert np.array_equal(ry, y) and np.array_equal(ru, u) \
                and np.array_equal(rv, v)
            ry2, _, _ = d.decode(pkts[1])
            assert np.array_equal(ry2, y2)

    def test_probe_params(self):
        w, h = 16, 8
        rng = np.random.default_rng(1)
        y = rng.integers(0, 1024, (h, w), dtype=np.uint16)
        u = rng.integers(0, 1024, (h // 2, w // 2), dtype=np.uint16)
        pkt = ffv1.FFV1Encoder(w, h, ffv1.FFV1Params(bits=10)).encode(
            [y, u, u.copy()])
        p = ffv1.probe_params(pkt)
        assert p.bits == 10 and p.chroma_planes
        with pytest.raises(ffv1.FFV1Error):
            ffv1.probe_params(b"\x00\x00\x00\x00")

    def test_p010_glue(self):
        w, h = 16, 8
        rng = np.random.default_rng(2)
        y = rng.integers(0, 1024, (h, w), dtype=np.uint16)
        u = rng.integers(0, 1024, (h // 2, w // 2), dtype=np.uint16)
        v = rng.integers(0, 1024, (h // 2, w // 2), dtype=np.uint16)
        pkt = ffv1.FFV1Encoder(w, h, ffv1.FFV1Params(bits=10)).encode(
            [y, u, v])
        yp, uvp = ffv1.decode_to_p010(ffv1.FFV1Decoder(w, h), pkt)
        assert yp.dtype == np.uint16
        assert np.array_equal(yp, y << 6)        # payload high-aligned
        assert np.array_equal(uvp[:, 1::2], v << 6)
        # 8-bit streams upshift by 8 on the P010 path
        y8, u8, v8 = _planes(w, h, seed=3)
        pkt8 = ffv1.FFV1Encoder(w, h).encode([y8, u8, v8])
        yp8, _ = ffv1.decode_to_p010(ffv1.FFV1Decoder(w, h), pkt8)
        assert np.array_equal(yp8, y8.astype(np.uint16) << 8)

    def test_nv12_glue_rounds(self):
        w, h = 16, 8
        rng = np.random.default_rng(4)
        y = rng.integers(0, 1024, (h, w), dtype=np.uint16)
        u = rng.integers(0, 1024, (h // 2, w // 2), dtype=np.uint16)
        pkt = ffv1.FFV1Encoder(w, h, ffv1.FFV1Params(bits=10)).encode(
            [y, u, u.copy()])
        yn, _ = ffv1.decode_to_nv12(ffv1.FFV1Decoder(w, h), pkt)
        assert yn.dtype == np.uint8
        want = (np.minimum(y.astype(np.uint32) + 2, 1023) >> 2
                ).astype(np.uint8)
        assert np.array_equal(yn, want)

    def test_mkv_10bit_plays_as_p010(self, tmp_path):
        from tests.test_mkv import build_mkv
        from mpv_frame_interpolator.frame import P010
        from mpv_frame_interpolator.io.mkv import MKVReader
        w, h = 32, 16
        rng = np.random.default_rng(5)
        p = ffv1.FFV1Params(bits=10)
        enc = ffv1.FFV1Encoder(w, h, p)
        ys = [rng.integers(0, 1024, (h, w), dtype=np.uint16)
              for _ in range(3)]
        us = [rng.integers(0, 1024, (h // 2, w // 2), dtype=np.uint16)
              for _ in range(3)]
        pkts = [enc.encode([y, u, u.copy()]) for y, u in zip(ys, us)]
        f = tmp_path / "deep.mkv"
        f.write_bytes(build_mkv(None, w, h, codec=b"V_FFV1",
                                payloads=pkts))
        rd = MKVReader(str(f))
        assert rd.fmt.pixfmt == P010
        got = list(rd)
        assert len(got) == 3
        assert got[1].y.dtype == np.uint16
        assert np.array_equal(got[1].y, ys[1] << 6)


def _vector_packets(n=4, w=48, h=32, all_keyframes=True):
    frames = [_planes(w, h, seed=s) for s in range(n)]
    return frames, ffv1.encode_frames_i420(frames, w, h,
                                           all_keyframes=all_keyframes)


class TestContainers:
    def test_avi_ffv1_plays(self, tmp_path):
        from tests.test_jpeg import build_avi
        from mpv_frame_interpolator.io.avi import AVIReader
        frames, pkts = _vector_packets()
        data = build_avi(pkts, 48, 32, fourcc=b"FFV1")
        p = tmp_path / "f.avi"
        p.write_bytes(data)
        rd = AVIReader(str(p))
        got = list(rd)
        assert len(got) == 4
        for f, (y, u, v) in zip(got, frames):
            assert np.array_equal(f.y, y)
            assert np.array_equal(f.uv[:, 0::2], u)

    def test_avi_ffv1_seek_all_keyframes(self, tmp_path):
        from tests.test_jpeg import build_avi
        from mpv_frame_interpolator.io.avi import AVIReader
        frames, pkts = _vector_packets()
        p = tmp_path / "f.avi"
        p.write_bytes(build_avi(pkts, 48, 32, fourcc=b"FFV1"))
        rd = AVIReader(str(p))
        rd.seek_frame(2)
        f = next(iter(rd))
        assert np.array_equal(f.y, frames[2][0])
        rd.seek_frame(0)               # backward seek resets states
        f = next(iter(rd))
        assert np.array_equal(f.y, frames[0][0])

    def test_avi_ffv1_seek_into_gop_rejected(self, tmp_path):
        from tests.test_jpeg import build_avi
        from mpv_frame_interpolator.io.avi import AVIError, AVIReader
        frames, pkts = _vector_packets(all_keyframes=False)
        p = tmp_path / "g.avi"
        p.write_bytes(build_avi(pkts, 48, 32, fourcc=b"FFV1"))
        rd = AVIReader(str(p))
        rd.seek_frame(2)
        with pytest.raises(AVIError, match="keyframe"):
            next(iter(rd))

    def test_mkv_ffv1_plays(self, tmp_path):
        from tests.test_mkv import build_mkv
        from mpv_frame_interpolator.io.mkv import MKVReader
        frames, pkts = _vector_packets()
        data = build_mkv(None, 48, 32, codec=b"V_FFV1", payloads=pkts)
        p = tmp_path / "f.mkv"
        p.write_bytes(data)
        rd = MKVReader(str(p))
        got = list(rd)
        assert len(got) == 4
        for f, (y, u, v) in zip(got, frames):
            assert np.array_equal(f.y, y)
            assert np.array_equal(f.uv[:, 1::2], v)

    def test_mkv_ffv1_inter_frames_play_sequentially(self, tmp_path):
        from tests.test_mkv import build_mkv
        from mpv_frame_interpolator.io.mkv import MKVReader
        frames, pkts = _vector_packets(all_keyframes=False)
        p = tmp_path / "g.mkv"
        p.write_bytes(build_mkv(None, 48, 32, codec=b"V_FFV1",
                                payloads=pkts))
        got = list(MKVReader(str(p)))
        assert len(got) == 4
        assert np.array_equal(got[3].y, frames[3][0])

    def test_mkv_v3_configuration_record_rejected(self, tmp_path):
        from tests.test_mkv import build_mkv
        from mpv_frame_interpolator.io.mkv import MKVError, MKVReader
        # author a ConfigurationRecord-style blob whose first symbol is 3
        enc = ffv1.RangeEncoder()
        st = bytearray([128] * ffv1.CONTEXT_SIZE)
        ffv1._put_symbol(enc, st, 0, 3, False)
        record = enc.finish() + b"\x00" * 8
        _, pkts = _vector_packets()
        data = build_mkv(None, 48, 32, codec=b"V_FFV1", payloads=pkts,
                         codec_private=record)
        p = tmp_path / "v3.mkv"
        p.write_bytes(data)
        with pytest.raises(MKVError, match="version 3"):
            MKVReader(str(p))

    def test_cli_transcodes_ffv1_avi(self, tmp_path):
        from tests.test_jpeg import build_avi
        from mpv_frame_interpolator.cli import main
        _, pkts = _vector_packets()
        src = tmp_path / "in.avi"
        src.write_bytes(build_avi(pkts, 48, 32, fourcc=b"FFV1"))
        out = tmp_path / "out.y4m"
        rc = main([str(src), "--untimed", "--model", "repeat",
                   "-o", str(out)])
        assert rc == 0 and out.stat().st_size > 0


class TestEncodeSink:
    """FFV1-in-MKV encode path: MKVWriter + FFV1MKVSink + CLI -o .mkv."""

    def test_mkv_writer_roundtrip(self, tmp_path):
        from mpv_frame_interpolator.io.mkv import MKVReader, MKVWriter
        frames, pkts = _vector_packets()
        p = tmp_path / "w.mkv"
        with open(p, "wb") as fh:
            w = MKVWriter(fh, 48, 32, 24.0, cluster_frames=2)
            for i, pkt in enumerate(pkts):
                w.add(pkt, keyframe=True, pts=i / 24.0)
            w.close()
        rd = MKVReader(str(p))
        assert (rd.width, rd.height) == (48, 32)
        assert abs(rd.fps - 24.0) < 1e-6
        got = list(rd)
        assert len(got) == 4
        for f, (y, u, v) in zip(got, frames):
            assert np.array_equal(f.y, y)
        assert abs(got[3].pts - 3 / 24.0) < 2e-3   # ms-grid timestamps

    def test_native_encoder_matches_python_bytes(self):
        if not ffv1.have_native():
            pytest.skip("native extension not built")
        from mpv_frame_interpolator.native import _native
        w, h = 48, 32
        frames = [_planes(w, h, seed=s) for s in range(3)]
        enc = ffv1.FFV1Encoder(w, h)
        cap = _native.ffv1_enc_create(w, h, 8)
        for i, (y, u, v) in enumerate(frames):
            py = enc.encode([y, u, v], keyframe=i != 1)
            nat = _native.ffv1_encode(cap, y.tobytes(), u.tobytes(),
                                      v.tobytes(), i != 1)
            assert py == nat       # byte-identical incl. inter frames

    def test_cli_lossless_transcode_loop(self, tmp_path):
        """y4m -> FFV1 MKV -> y4m must be bit-exact (lossless loop)."""
        from mpv_frame_interpolator.cli import main
        from mpv_frame_interpolator.io.y4m import Y4MReader
        from tests.test_playlist import write_y4m
        src = tmp_path / "in.y4m"
        write_y4m(src, n=5, w=48, h=32)
        mkv = tmp_path / "arch.mkv"
        rc = main([str(src), "--untimed", "--model", "repeat",
                   "--display-fps", "24", "-o", str(mkv)])
        assert rc == 0
        back = tmp_path / "back.y4m"
        rc = main([str(mkv), "--untimed", "--model", "repeat",
                   "--display-fps", "24", "-o", str(back)])
        assert rc == 0
        a = list(Y4MReader(open(src, "rb")))
        b = list(Y4MReader(open(back, "rb")))
        assert len(a) == len(b) == 5
        for fa, fb in zip(a, b):
            assert np.array_equal(fa.y, fb.y)
            assert np.array_equal(fa.uv, fb.uv)

    def test_p010_sink_writes_10bit(self, tmp_path):
        from mpv_frame_interpolator.frame import (FrameFormat, P010,
                                                      VideoFrame)
        from mpv_frame_interpolator.io.mkv import MKVReader
        from mpv_frame_interpolator.io.sinks import FFV1MKVSink
        from mpv_frame_interpolator.pipeline.engine import OutputFrame
        w, h = 32, 16
        rng = np.random.default_rng(6)
        fmt = FrameFormat(w, h, P010)
        sink = FFV1MKVSink(str(tmp_path / "deep.mkv"), w, h, 24.0,
                           pixfmt=P010)
        ys = []
        for i in range(3):
            y = (rng.integers(0, 1024, (h, w), dtype=np.uint16) << 6)
            uv = (rng.integers(0, 1024, (h // 2, w), dtype=np.uint16) << 6)
            ys.append(y)
            sink.write(OutputFrame(i / 24.0, fmt, y, uv, host=True))
        sink.close()
        rd = MKVReader(str(tmp_path / "deep.mkv"))
        assert rd.fmt.pixfmt == P010
        got = list(rd)
        assert len(got) == 3
        assert got[2].y.dtype == np.uint16
        assert np.array_equal(got[2].y, ys[2])   # lossless at 10 bits
