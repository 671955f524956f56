"""Minimal ISO-BMFF (MP4/MOV container) demuxer for uncompressed video.

Companion to io/mkv.py (together they cover the codec-free container
paths the reference handles through demux_lavf.c): raw I420/NV12 video
samples in an MP4/MOV box structure, the format `ffmpeg -c:v rawvideo`
produces with `-f mov` (sample entry fourcc 'I420'/'NV12'/'raw ').
Compressed codecs raise with the codec name so the CLI can fall back to
an external decoder.

Box layout walked (ISO/IEC 14496-12):
  ftyp; moov > trak > mdia > { mdhd (timescale), hdlr (vide), minf >
  stbl > { stsd (sample entry), stts (durations), stsz (sizes),
  stsc (samples per chunk), stco/co64 (chunk offsets) } }
The sample tables compose into a complete frame index at open, so reads
and seeks are O(1) afterwards, same contract as the MKV reader.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from mpv_frame_interpolator.frame import FrameFormat, NV12, VideoFrame
from mpv_frame_interpolator.native import interleave_chroma_into
from mpv_frame_interpolator.utils import get_logger

log = get_logger("mp4")

_MAX_DIM = 16384
_MAX_PIXELS = 1 << 27

RAW_FOURCCS = {"I420": "i420", "IYUV": "i420", "NV12": "nv12",
               "raw ": "i420", "j420": "i420",
               # Motion-JPEG sample entries: decoded in-process by
               # io/jpeg.py (QuickTime 'jpeg'/'mjpa'; 'MJPG' from
               # remuxed AVI streams)
               "jpeg": "mjpeg", "mjpa": "mjpeg", "MJPG": "mjpeg",
               "mjpg": "mjpeg"}


class MP4Error(ValueError):
    pass


@dataclasses.dataclass
class _Track:
    timescale: int = 0
    is_video: bool = False
    fourcc: str = ""
    width: int = 0
    height: int = 0
    durations: list = dataclasses.field(default_factory=list)  # (count, delta)
    sizes: List[int] = dataclasses.field(default_factory=list)
    chunk_offsets: List[int] = dataclasses.field(default_factory=list)
    stsc: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # (first_chunk, samples_per_chunk)


def _read_boxes(fh: BinaryIO, start: int, end: int):
    """Iterate (type, payload offset, payload size) between start/end."""
    pos = start
    while pos + 8 <= end:
        fh.seek(pos)
        hdr = fh.read(8)
        if len(hdr) < 8:
            return
        size = struct.unpack(">I", hdr[:4])[0]
        btype = hdr[4:8].decode("latin1")
        payload = pos + 8
        if size == 1:                       # 64-bit largesize
            big = fh.read(8)
            if len(big) < 8:
                return
            size = struct.unpack(">Q", big)[0]
            payload = pos + 16
        elif size == 0:                     # to end of file
            size = end - pos
        if size < 8 or pos + size > end + 1:
            raise MP4Error(f"bad box size {size} for {btype!r}")
        yield btype, payload, pos + size - payload
        pos += size


class MP4Reader:
    """ISO-BMFF demuxer for uncompressed video -> VideoFrame."""

    def __init__(self, path, start_pts: float = 0.0):
        # path or any seekable binary file-like (e.g. stream.HttpFile)
        self._fh = open(path, "rb") if isinstance(path, str) else path
        self._start_pts = start_pts
        self.track: Optional[_Track] = None
        self._index: List[Tuple[int, int, float]] = []  # (off, size, pts)
        self._pos = 0
        self._parse()
        t = self.track
        if t is None:
            raise MP4Error("no video track found")
        layout = RAW_FOURCCS.get(t.fourcc)
        if layout is None:
            raise MP4Error(
                f"track codec {t.fourcc!r} needs an external decoder "
                f"(only raw {sorted(RAW_FOURCCS)} are demuxed natively)")
        self._layout = layout
        if not (0 < t.width <= _MAX_DIM and 0 < t.height <= _MAX_DIM
                and t.width * t.height <= _MAX_PIXELS):
            raise MP4Error(f"bad video dimensions {t.width}x{t.height}")
        if (t.width % 2 or t.height % 2) and layout != "mjpeg":
            raise MP4Error("4:2:0 requires even dimensions")
        self.width, self.height = t.width, t.height
        self._build_index()
        self.fps = self._infer_fps()
        self.fmt = FrameFormat(self.width + self.width % 2,
                               self.height + self.height % 2, NV12)
        self._expected = self.width * self.height * 3 // 2

    # -- parsing ----------------------------------------------------------

    def _parse(self):
        end = self._fh.seek(0, 2)
        found = False
        for btype, off, size in list(_read_boxes(self._fh, 0, end)):
            if btype == "moov":
                self._parse_moov(off, size)
                found = True
        if not found:
            raise MP4Error("not an ISO-BMFF file (no moov box)")

    def _parse_moov(self, start, size):
        for btype, off, bsize in list(_read_boxes(self._fh, start,
                                                  start + size)):
            if btype == "trak":
                t = self._parse_trak(off, bsize)
                if t.is_video and self.track is None and t.sizes:
                    self.track = t

    def _parse_trak(self, start, size):
        t = _Track()
        for btype, off, bsize in list(_read_boxes(self._fh, start,
                                                  start + size)):
            if btype == "mdia":
                self._parse_mdia(t, off, bsize)
        return t

    def _parse_mdia(self, t: _Track, start, size):
        for btype, off, bsize in list(_read_boxes(self._fh, start,
                                                  start + size)):
            self._fh.seek(off)
            if btype == "mdhd":
                data = self._fh.read(min(bsize, 32))
                version = data[0]
                t.timescale = struct.unpack(
                    ">I", data[20:24] if version == 1 else data[12:16])[0]
            elif btype == "hdlr":
                data = self._fh.read(min(bsize, 12))
                t.is_video = data[8:12] == b"vide"
            elif btype == "minf":
                self._parse_minf(t, off, bsize)

    def _parse_minf(self, t: _Track, start, size):
        for btype, off, bsize in list(_read_boxes(self._fh, start,
                                                  start + size)):
            if btype == "stbl":
                self._parse_stbl(t, off, bsize)

    def _parse_stbl(self, t: _Track, start, size):
        for btype, off, bsize in list(_read_boxes(self._fh, start,
                                                  start + size)):
            self._fh.seek(off)
            data = self._fh.read(bsize)
            if btype == "stsd" and len(data) >= 16:
                # first sample entry: size(4) fourcc(4) ... width/height
                # at fixed offsets inside a VisualSampleEntry
                t.fourcc = data[12:16].decode("latin1")
                if len(data) >= 16 + 28 + 4:
                    t.width, t.height = struct.unpack(
                        ">HH", data[16 + 24:16 + 28])
            elif btype == "stts":
                n = struct.unpack(">I", data[4:8])[0]
                for i in range(min(n, (len(data) - 8) // 8)):
                    cnt, delta = struct.unpack_from(">II", data, 8 + i * 8)
                    t.durations.append((cnt, delta))
            elif btype == "stsz":
                uniform, n = struct.unpack(">II", data[4:12])
                if n > 1 << 24:              # hostile count: not a video
                    raise MP4Error(f"implausible sample count {n}")
                if uniform:
                    t.sizes = [uniform] * n
                else:
                    t.sizes = list(struct.unpack_from(
                        f">{min(n, (len(data) - 12) // 4)}I", data, 12))
            elif btype == "stsc":
                n = struct.unpack(">I", data[4:8])[0]
                for i in range(min(n, (len(data) - 8) // 12)):
                    first, per, _ = struct.unpack_from(">III", data,
                                                       8 + i * 12)
                    t.stsc.append((first, per))
            elif btype == "stco":
                n = struct.unpack(">I", data[4:8])[0]
                t.chunk_offsets = list(struct.unpack_from(
                    f">{min(n, (len(data) - 8) // 4)}I", data, 8))
            elif btype == "co64":
                n = struct.unpack(">I", data[4:8])[0]
                t.chunk_offsets = list(struct.unpack_from(
                    f">{min(n, (len(data) - 8) // 8)}Q", data, 8))

    def _build_index(self):
        """Compose stsc/stco/stsz/stts into (offset, size, pts) triples."""
        t = self.track
        if not t.chunk_offsets or not t.sizes or not t.timescale:
            raise MP4Error("incomplete sample tables")
        # samples per chunk, expanded per chunk index
        per_chunk = []
        stsc = t.stsc or [(1, 1)]
        for i, (first, per) in enumerate(stsc):
            last = (stsc[i + 1][0] - 1 if i + 1 < len(stsc)
                    else len(t.chunk_offsets))
            per_chunk.extend([per] * max(last - first + 1, 0))
        # sample timestamps from stts
        deltas = []
        for cnt, delta in t.durations:
            deltas.extend([delta] * min(cnt, len(t.sizes) - len(deltas)))
        while len(deltas) < len(t.sizes):
            deltas.append(deltas[-1] if deltas else t.timescale)
        ts = 0
        sample = 0
        for ci, chunk_off in enumerate(t.chunk_offsets):
            n = per_chunk[ci] if ci < len(per_chunk) else 1
            off = chunk_off
            for _ in range(n):
                if sample >= len(t.sizes):
                    break
                size = t.sizes[sample]
                self._index.append((off, size, ts / t.timescale))
                off += size
                ts += deltas[sample]
                sample += 1

    def _infer_fps(self) -> float:
        t = self.track
        if t.durations:
            delta = t.durations[0][1]
            if delta > 0:
                return t.timescale / delta
        return 0.0

    # -- reading (same surface as MKVReader) ------------------------------

    def n_frames(self) -> int:
        return len(self._index)

    def seekable(self) -> bool:
        return True

    def seek_frame(self, n: int):
        self._pos = max(min(int(n), len(self._index)), 0)

    def seek_pts(self, pts: float) -> float:
        target = pts - self._start_pts
        lo = 0
        for i, (_, _, ts) in enumerate(self._index):
            if ts <= target + 1e-9:
                lo = i
            else:
                break
        self._pos = lo
        return (self._start_pts + self._index[lo][2]) if self._index else 0.0

    def _decode_payload(self, data: bytes) -> VideoFrame:
        w, h = self.width, self.height
        if self._layout == "mjpeg":
            from mpv_frame_interpolator.io.jpeg import decode_jpeg_frame
            try:
                frame = decode_jpeg_frame(data, nominal_fps=self.fps)
            except ValueError as e:
                raise MP4Error(f"bad MJPEG frame: {e}") from None
            if (frame.fmt.width, frame.fmt.height) != (self.fmt.width,
                                                       self.fmt.height):
                raise MP4Error(
                    f"MJPEG frame geometry {frame.fmt.width}x"
                    f"{frame.fmt.height} != track {w}x{h}")
            return frame
        if len(data) < self._expected:
            raise MP4Error(f"short frame payload ({len(data)} bytes, "
                           f"need {self._expected})")
        y = np.frombuffer(data, np.uint8, w * h).reshape(h, w)
        if self._layout == "nv12":
            uv = np.ascontiguousarray(
                np.frombuffer(data, np.uint8, (h // 2) * w,
                              w * h).reshape(h // 2, w))
        else:
            csz = (w // 2) * (h // 2)
            u = np.frombuffer(data, np.uint8, csz, w * h).reshape(h // 2, w // 2)
            v = np.frombuffer(data, np.uint8, csz, w * h + csz).reshape(h // 2, w // 2)
            uv = np.empty((h // 2, w), np.uint8)
            interleave_chroma_into(u, v, uv)
        return VideoFrame(np.ascontiguousarray(y), uv, self.fmt,
                          nominal_fps=self.fps)

    def __iter__(self) -> Iterator[VideoFrame]:
        while self._pos < len(self._index):
            off, size, ts = self._index[self._pos]
            self._pos += 1
            self._fh.seek(off)
            frame = self._decode_payload(self._fh.read(size))
            frame.pts = self._start_pts + ts
            yield frame

    def close(self):
        self._fh.close()
