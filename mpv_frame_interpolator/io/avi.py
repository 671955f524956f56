"""Minimal AVI (RIFF) demuxer: MJPEG and raw-YUV video -> VideoFrame.

The reference demuxes AVI through libavformat (demux/demux_lavf.c); this
is an original reader built from the public RIFF/AVI layout covering the
codec set the rebuild can decode in-process: 'MJPG' (baseline Motion-JPEG,
io/jpeg.py -- the canonical AVI payload) and raw 'I420'/'IYUV'/'NV12'.

Index: the optional 'idx1' chunk gives O(1) seek; files without one get a
single linear 'movi' scan at open (still O(1) per subsequent seek).  The
AVI convention of zero-length frame chunks meaning "repeat the previous
frame" is honored by re-yielding the last decoded frame at the new pts
(what libavformat reports as a duplicate frame).

Same reader surface as io/mkv.MKVReader / io/mp4.MP4Reader: width /
height / fps / fmt / n_frames / seekable / seek_frame / seek_pts /
__iter__ / close.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from mpv_frame_interpolator.frame import (FrameFormat, NV12, P010,
                                              VideoFrame,
                                              interleave_chroma)
from mpv_frame_interpolator.native import interleave_chroma_into
from mpv_frame_interpolator.utils import get_logger

log = get_logger("avi")

_MAX_DIM = 1 << 15
_MAX_PIXELS = 1 << 27

RAW_FOURCCS = {"I420": "i420", "IYUV": "i420", "NV12": "nv12"}
MJPEG_FOURCCS = {"MJPG", "mjpg", "dmb1", "jpeg", "AVRn"}
UTVIDEO_FOURCCS = {"ULY0", "ULY2", "ULH0", "ULH2"}


class AVIError(ValueError):
    pass


class AVIReader:
    """AVI demuxer for MJPEG / raw-YUV video streams."""

    def __init__(self, path, start_pts: float = 0.0):
        self._fh: BinaryIO = open(path, "rb") if isinstance(path, str) \
            else path
        self._start_pts = start_pts
        self.width = 0
        self.height = 0
        self.fps = 0.0
        self._stream_no: Optional[int] = None
        self._fourcc = ""
        self._extradata = b""
        self._movi: Optional[Tuple[int, int]] = None  # (payload off, size)
        self._idx1: Optional[Tuple[int, int]] = None
        # (payload offset, payload size, pts seconds); size 0 = repeat
        self._index: List[Tuple[int, int, float]] = []
        self._pos = 0
        self._last: Optional[VideoFrame] = None
        self._parse()
        if self._stream_no is None:
            raise AVIError("no video stream found")
        if self._fourcc in MJPEG_FOURCCS:
            self._layout = "mjpeg"
        elif self._fourcc in RAW_FOURCCS:
            self._layout = RAW_FOURCCS[self._fourcc]
        elif self._fourcc in UTVIDEO_FOURCCS:
            from mpv_frame_interpolator.io import utvideo as _ut
            self._layout = "utvideo"
            try:
                self._ut_slices, interlaced = _ut.parse_extradata(
                    self._extradata)
            except _ut.UtVideoError as e:
                raise AVIError(f"bad Ut Video stream header: {e}") \
                    from None
            if interlaced:
                raise AVIError("interlaced Ut Video is not supported")
        elif self._fourcc == "FFV1":
            from mpv_frame_interpolator.io import ffv1 as _ffv1
            self._layout = "ffv1"
            self._ffv1: Optional[_ffv1.FFV1Decoder] = None
            self._ffv1_expect = -1   # next index position the states match
        else:
            raise AVIError(
                f"stream codec {self._fourcc!r} needs an external decoder "
                f"(MJPG, FFV1, Ut Video {sorted(UTVIDEO_FOURCCS)} and raw "
                f"{sorted(RAW_FOURCCS)} decode natively)")
        if not (0 < self.width <= _MAX_DIM and 0 < self.height <= _MAX_DIM
                and self.width * self.height <= _MAX_PIXELS):
            raise AVIError(f"bad video dimensions "
                           f"{self.width}x{self.height}")
        if (self.width % 2 or self.height % 2) \
                and self._layout not in ("mjpeg", "utvideo", "ffv1"):
            raise AVIError("4:2:0 requires even dimensions")
        if self.fps <= 0:
            self.fps = 25.0
        self._build_index()
        if not self._index:
            raise AVIError("no video frames in movi list")
        self._ffv1_bits = 8
        if self._layout == "ffv1":   # probe depth: params ride keyframe 0
            from mpv_frame_interpolator.io import ffv1 as _ffv1
            off, size, _ = self._index[0]
            self._fh.seek(off)
            try:
                self._ffv1_bits = _ffv1.probe_params(
                    self._fh.read(min(size, 4096))).bits
            except _ffv1.FFV1Error as e:
                raise AVIError(f"bad FFV1 stream: {e}") from None
        pixfmt = P010 if self._ffv1_bits > 8 else NV12
        self.fmt = FrameFormat(self.width + self.width % 2,
                               self.height + self.height % 2, pixfmt)
        self._expected = self.width * self.height * 3 // 2

    # -- parsing ----------------------------------------------------------

    def _u32(self, data: bytes, off: int) -> int:
        if off + 4 > len(data):
            raise AVIError("truncated header")
        return struct.unpack_from("<I", data, off)[0]

    def _chunks(self, start: int, end: int):
        """Iterate (fourcc, payload offset, payload size) with RIFF word
        alignment; LIST chunks yield ('LIST:<type>', ...) of the body."""
        fh = self._fh
        pos = start
        while pos + 8 <= end:
            fh.seek(pos)
            hdr = fh.read(8)
            if len(hdr) < 8:
                return
            four = hdr[:4].decode("latin1")
            size = struct.unpack("<I", hdr[4:])[0]
            if size > end - pos - 8:
                size = max(end - pos - 8, 0)  # clamp damaged sizes
            yield four, pos + 8, size
            pos += 8 + size + (size & 1)

    def _parse(self):
        fh = self._fh
        fh.seek(0, 2)
        file_end = fh.tell()
        fh.seek(0)
        hdr = fh.read(12)
        if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"AVI ":
            raise AVIError("not an AVI (RIFF/'AVI ') file")
        riff_end = min(12 + struct.unpack("<I", hdr[4:8])[0] - 4, file_end)
        for four, off, size in self._chunks(12, riff_end):
            if four == "LIST":
                fh.seek(off)
                ltype = fh.read(4).decode("latin1")
                if ltype == "hdrl":
                    self._parse_hdrl(off + 4, off + size)
                elif ltype == "movi":
                    self._movi = (off + 4, size - 4)
            elif four == "idx1":
                self._idx1 = (off, size)

    def _parse_hdrl(self, start: int, end: int):
        stream_no = -1
        fh = self._fh
        for four, off, size in self._chunks(start, end):
            if four != "LIST":
                continue
            fh.seek(off)
            if fh.read(4) != b"strl":
                continue
            stream_no += 1
            fcc_type = fcc_handler = ""
            scale = rate = 0
            bi_fourcc = ""
            w = h = 0
            extradata = b""
            for c4, coff, csize in self._chunks(off + 4, off + size):
                fh.seek(coff)
                data = fh.read(min(csize, 256))
                if c4 == "strh" and len(data) >= 32:
                    fcc_type = data[:4].decode("latin1")
                    fcc_handler = data[4:8].decode("latin1")
                    scale = self._u32(data, 20)
                    rate = self._u32(data, 24)
                elif c4 == "strf" and len(data) >= 24:
                    # BITMAPINFOHEADER (+ codec private data beyond the
                    # 40 fixed bytes -- Ut Video parks its stream config
                    # there, the VfW convention libavformat follows too)
                    w = struct.unpack_from("<i", data, 4)[0]
                    h = abs(struct.unpack_from("<i", data, 8)[0])
                    compression = data[16:20]
                    bi_fourcc = compression.decode("latin1")
                    extradata = data[40:]
            if fcc_type == "vids" and self._stream_no is None:
                self._stream_no = stream_no
                self.width, self.height = w, h
                self.fps = rate / scale if scale else 0.0
                # handler fourcc wins when strf compression is 0/DIB-ish
                self._fourcc = bi_fourcc if bi_fourcc.strip("\0 ") \
                    else fcc_handler
                self._extradata = extradata

    def _build_index(self):
        if self._movi is None:
            raise AVIError("no movi list")
        movi_off, movi_size = self._movi
        want = b"%02d" % self._stream_no
        dt = 1.0 / self.fps
        entries: List[Tuple[int, int]] = []       # (payload off, size)
        if self._idx1 is not None:
            entries = self._read_idx1(want, movi_off)
        if not entries:                            # no/garbage idx1: scan
            for four, off, size in self._chunks(movi_off,
                                                movi_off + movi_size):
                f4 = four.encode("latin1")
                if f4[:2] == want and f4[2:4] in (b"dc", b"db"):
                    entries.append((off, size))
        self._index = [(off, size, i * dt)
                       for i, (off, size) in enumerate(entries)]

    def _read_idx1(self, want: bytes, movi_off: int):
        off, size = self._idx1
        fh = self._fh
        fh.seek(off)
        data = fh.read(size)
        n = len(data) // 16
        if n == 0:
            return []
        # idx1 offsets are usually relative to the 'movi' fourcc (first
        # chunk at offset 4); some muxers store absolute file offsets.
        # Detect with the first entry: the bytes at the candidate
        # position must be its own ckid.
        first_ck = data[0:4]
        rel_base = movi_off - 4      # position of the 'movi' fourcc
        first_off = struct.unpack_from("<I", data, 8)[0]
        base = None
        for cand in (rel_base, 0):
            fh.seek(cand + first_off)
            if fh.read(4) == first_ck:
                base = cand
                break
        if base is None:
            return []
        out = []
        for i in range(n):
            ck = data[i * 16:i * 16 + 4]
            if ck[:2] != want or ck[2:4] not in (b"dc", b"db"):
                continue
            coff = struct.unpack_from("<I", data, i * 16 + 8)[0]
            csize = struct.unpack_from("<I", data, i * 16 + 12)[0]
            out.append((base + coff + 8, csize))
        return out

    # -- reading ----------------------------------------------------------

    def n_frames(self) -> int:
        return len(self._index)

    def seekable(self) -> bool:
        return True

    def seek_frame(self, n: int):
        self._pos = max(min(int(n), len(self._index)), 0)
        self._last = None

    def seek_pts(self, pts: float) -> float:
        import bisect
        target = pts - self._start_pts
        keys = [t for _, _, t in self._index]
        lo = max(bisect.bisect_right(keys, target + 1e-9) - 1, 0)
        self._pos = lo
        self._last = None
        return (self._start_pts + self._index[lo][2]) if self._index else 0.0

    def _decode_payload(self, data: bytes) -> VideoFrame:
        w, h = self.width, self.height
        if self._layout == "mjpeg":
            from mpv_frame_interpolator.io.jpeg import decode_jpeg_frame
            try:
                frame = decode_jpeg_frame(data, nominal_fps=self.fps)
            except ValueError as e:
                raise AVIError(f"bad MJPEG frame: {e}") from None
            if (frame.fmt.width, frame.fmt.height) != (self.fmt.width,
                                                       self.fmt.height):
                raise AVIError(
                    f"MJPEG frame geometry {frame.fmt.width}x"
                    f"{frame.fmt.height} != stream {w}x{h}")
            return frame
        if self._layout == "utvideo":
            from mpv_frame_interpolator.io import utvideo as _ut
            try:
                y, uv = _ut.decode_to_nv12(data, self._fourcc, w, h,
                                           self._ut_slices)
            except ValueError as e:
                raise AVIError(f"bad Ut Video frame: {e}") from None
            return VideoFrame(y, uv, self.fmt, nominal_fps=self.fps)
        if self._layout == "ffv1":
            from mpv_frame_interpolator.io import ffv1 as _ffv1
            if self._ffv1 is None:
                self._ffv1 = _ffv1.FFV1Decoder(w, h)
            if self._pos - 1 != self._ffv1_expect:
                self._ffv1.reset()     # seek: re-enter at a keyframe
            deep = self.fmt.pixfmt == P010
            try:
                y, uv = (_ffv1.decode_to_p010 if deep
                         else _ffv1.decode_to_nv12)(self._ffv1, data)
            except ValueError as e:
                raise AVIError(f"bad FFV1 frame: {e}") from None
            self._ffv1_expect = self._pos
            return VideoFrame(y, uv, self.fmt, nominal_fps=self.fps)
        if len(data) < self._expected:
            raise AVIError(f"short frame payload ({len(data)} bytes, "
                           f"need {self._expected})")
        y = np.frombuffer(data, np.uint8, w * h).reshape(h, w)
        if self._layout == "nv12":
            uv = np.ascontiguousarray(
                np.frombuffer(data, np.uint8, (h // 2) * w,
                              w * h).reshape(h // 2, w))
        else:
            csz = (w // 2) * (h // 2)
            u = np.frombuffer(data, np.uint8, csz,
                              w * h).reshape(h // 2, w // 2)
            v = np.frombuffer(data, np.uint8, csz,
                              w * h + csz).reshape(h // 2, w // 2)
            uv = np.empty((h // 2, w), np.uint8)
            interleave_chroma_into(u, v, uv)
        return VideoFrame(np.ascontiguousarray(y), uv, self.fmt,
                          nominal_fps=self.fps)

    def __iter__(self) -> Iterator[VideoFrame]:
        while self._pos < len(self._index):
            off, size, ts = self._index[self._pos]
            self._pos += 1
            if size == 0:
                # AVI dropped-frame convention: repeat the previous frame
                if self._last is None:
                    continue
                frame = self._last.copy()
            else:
                self._fh.seek(off)
                frame = self._decode_payload(self._fh.read(size))
                self._last = frame
            frame.pts = self._start_pts + ts
            yield frame

    def close(self):
        self._fh.close()
