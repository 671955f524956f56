"""YUV4MPEG2 (.y4m) reader/writer and raw YUV reader.

The host-side media boundary.  The build image has no FFmpeg/PyAV, so the
framework speaks the simplest interchange formats every tool understands:
y4m (ffmpeg's `-f yuv4mpegpipe`) and raw planar I420/I420-10LE.  The decode
layer (io/decode.py) shells out to ffmpeg into this pipe format when a real
decoder is present on the system.

Replaces, for the rebuild's scope, the reference's demux/decode stack
(demux/demux.c, video/decode/vd_lavc.c) whose output HopperRender consumes
as NV12 frames with pts + nominal_fps (vf_HopperRender.c:416-428).
"""

from __future__ import annotations

from typing import Iterator, BinaryIO

import numpy as np

from mpv_frame_interpolator.frame import (
    FrameFormat, VideoFrame, NV12, P010, interleave_chroma, split_chroma)
from mpv_frame_interpolator.native import interleave_chroma_into


class Y4MError(ValueError):
    pass


_COLORSPACE_8 = {"420", "420jpeg", "420mpeg2", "420paldv"}
_COLORSPACE_10 = {"420p10"}


def _parse_ratio(s: str) -> float:
    num, den = s.split(":")
    den = int(den)
    return int(num) / den if den else 0.0


# sanity caps: a hostile header must not become an allocation bomb or a
# numeric blow-up (the reference's fuzzers cover its demuxer entry points,
# fuzzers/fuzzer_load.c)
MAX_DIMENSION = 16384
MAX_PIXELS = 1 << 27     # ~134 MP, comfortably past 16K video
MAX_FPS = 100000.0


def parse_header(header: str):
    """Parse a YUV4MPEG2 stream header line.

    Returns (width, height, fps, pixfmt).  Raises Y4MError on anything
    malformed, out of range, or outside the supported 4:2:0 colorspaces.
    """
    if not header.startswith("YUV4MPEG2"):
        raise Y4MError("not a YUV4MPEG2 stream")
    width = height = 0
    fps = 0.0
    cs = "420mpeg2"
    for tok in header.split()[1:]:
        key, val = tok[0], tok[1:]
        try:
            if key == "W":
                width = int(val)
            elif key == "H":
                height = int(val)
            elif key == "F":
                fps = _parse_ratio(val)
            elif key == "C":
                cs = val
        except (ValueError, ZeroDivisionError) as e:
            raise Y4MError(f"bad header token {tok!r}: {e}") from None
    if not (0 < width <= MAX_DIMENSION and 0 < height <= MAX_DIMENSION
            and width * height <= MAX_PIXELS):
        raise Y4MError(f"bad dimensions in header: {header!r}")
    if not (0.0 <= fps <= MAX_FPS) or fps != fps:
        raise Y4MError(f"bad frame rate in header: {header!r}")
    if cs in _COLORSPACE_8:
        pixfmt = NV12
    elif cs in _COLORSPACE_10:
        pixfmt = P010
    else:
        raise Y4MError(f"unsupported colorspace C{cs} (need 4:2:0)")
    return width, height, fps, pixfmt


class Y4MReader:
    """Streaming y4m demuxer -> VideoFrame (NV12 or P010 planes).

    Frame buffers are drawn from a recycling FramePool (mp_image_pool
    analog): frames carry a `recycle` hook, and consumers that copy the
    planes off-host (the pipeline's staging path) call it so steady-state
    reading allocates nothing.  Unrecycled frames simply cost a fresh
    allocation, never corruption.  For maximum ingest throughput use the
    C++ demuxer ring instead (io/ingest.py)."""

    def __init__(self, fh: BinaryIO, start_pts: float = 0.0, pool=None):
        self._fh = fh
        header = fh.readline(4096).decode("ascii", "replace").strip()
        self.width, self.height, self.fps, self.pixfmt = parse_header(header)
        if pool is None:
            from mpv_frame_interpolator.native import FramePool
            pool = FramePool(max_entries=8)
        self.pool = pool
        self._scratch = None
        # 4:2:0 y4m streams always carry even dimensions, but be defensive:
        # crop odd sizes down (the engine requires even geometry)
        self._crop_w = self.width & ~1
        self._crop_h = self.height & ~1
        self.fmt = FrameFormat(self._crop_w, self._crop_h, self.pixfmt)
        self._pts = start_pts
        self._start_pts = start_pts
        self._dt = 1.0 / self.fps if self.fps > 0 else 1.0 / 24.0
        # seek support (demux_seek analog): y4m frames are fixed-size
        # records after the stream header, so frame n lives at a computable
        # byte offset (the reference's demuxers keep a seek index,
        # demux/demux_mkv.c; y4m needs none)
        itemsize = self.fmt.dtype().itemsize
        self._payload = (self.width * self.height
                         + 2 * (self.width // 2) * (self.height // 2)) * itemsize
        self._marker_len: int | None = None
        try:
            self._data_start = fh.tell()
            self._seekable = bool(fh.seekable())
        except (OSError, AttributeError):
            self._data_start = 0
            self._seekable = False

    # -- seeking ----------------------------------------------------------

    def seekable(self) -> bool:
        return self._seekable

    def _ensure_marker_len(self):
        """Learn the FRAME marker line length from the first frame (markers
        may carry parameters; virtually all streams use a constant line)."""
        if self._marker_len is not None:
            return
        pos = self._fh.tell()
        self._fh.seek(self._data_start)
        line = self._fh.readline()
        if not line.startswith(b"FRAME"):
            raise Y4MError(f"bad frame marker at stream start: {line[:20]!r}")
        self._marker_len = len(line)
        self._fh.seek(pos)

    def n_frames(self) -> int:
        """Total frame count (only for seekable streams)."""
        if not self._seekable:
            raise Y4MError("stream is not seekable")
        self._ensure_marker_len()
        pos = self._fh.tell()
        end = self._fh.seek(0, 2)
        self._fh.seek(pos)
        rec = self._marker_len + self._payload
        return max((end - self._data_start) // rec, 0)

    def seek_frame(self, n: int):
        """O(1) byte seek to frame n (falls back to a linear marker scan if
        the stream uses variable-length FRAME lines)."""
        if not self._seekable:
            raise Y4MError("stream is not seekable")
        self._ensure_marker_len()
        n = max(int(n), 0)
        rec = self._marker_len + self._payload
        target = self._data_start + n * rec
        self._fh.seek(target)
        line = self._fh.readline()
        if line and not line.startswith(b"FRAME"):
            # variable-length markers: scan forward from the data start
            self._fh.seek(self._data_start)
            for _ in range(n):
                marker = self._fh.readline()
                if not marker.startswith(b"FRAME"):
                    break          # seeked past EOF; iteration just ends
                self._fh.seek(self._payload, 1)
        else:
            self._fh.seek(target)
        self._pts = self._start_pts + n * self._dt

    def seek_pts(self, pts: float) -> float:
        """Seek to the frame covering `pts`; returns the actual frame pts."""
        n = int(max(pts - self._start_pts, 0.0) / self._dt + 1e-6)
        self.seek_frame(n)
        return self._pts

    def _read_into(self, arr: np.ndarray) -> bool:
        """Fill `arr` (contiguous) from the stream; False on short read."""
        mv = memoryview(arr).cast("B")
        readinto = getattr(self._fh, "readinto", None)
        if readinto is not None:
            filled = 0
            while filled < len(mv):
                got = readinto(mv[filled:])
                if not got:
                    return False
                filled += got
            return True
        data = self._fh.read(len(mv))
        if len(data) < len(mv):
            return False
        mv[:] = data
        return True

    def __iter__(self) -> Iterator[VideoFrame]:
        w, h = self.width, self.height
        cw, ch = self._crop_w, self._crop_h
        dtype = self.fmt.dtype
        cropped = (cw, ch) != (w, h)
        if self._scratch is None:
            # planar U,V staging, reused every frame
            self._scratch = np.empty((2, h // 2, w // 2), dtype)
        u_s, v_s = self._scratch[0], self._scratch[1]
        while True:
            line = self._fh.readline(4096)
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise Y4MError(f"bad frame marker: {line[:20]!r}")
            y = self.pool.get((h, w), dtype)
            uv = self.pool.get((h // 2, w), dtype)
            if not (self._read_into(y) and self._read_into(u_s)
                    and self._read_into(v_s)):
                self.pool.give_back(y)
                self.pool.give_back(uv)
                return
            interleave_chroma_into(u_s, v_s, uv)
            if self.pixfmt == P010:
                # y4m 420p10 carries 10-bit values; P010 uses the top bits
                np.left_shift(y, 6, out=y)
                np.left_shift(uv, 6, out=uv)
            pool = self.pool

            def recycle(y=y, uv=uv, pool=pool):
                pool.give_back(y)
                pool.give_back(uv)

            if cropped:
                frame = VideoFrame(np.ascontiguousarray(y[:ch, :cw]),
                                   np.ascontiguousarray(uv[:ch // 2, :cw]),
                                   self.fmt, pts=self._pts,
                                   nominal_fps=self.fps)
                recycle()      # the cropped copies own their storage
            else:
                frame = VideoFrame(y, uv, self.fmt, pts=self._pts,
                                   nominal_fps=self.fps, recycle=recycle)
            self._pts += self._dt
            yield frame


class Y4MWriter:
    """VideoFrame -> y4m stream (planar I420 / I420p10)."""

    def __init__(self, fh: BinaryIO, width: int, height: int, fps: float,
                 pixfmt: str = NV12):
        self._fh = fh
        self.pixfmt = pixfmt
        if abs(fps - round(fps)) < 1e-9:
            ratio = f"{int(round(fps))}:1"
        else:
            num = int(round(fps * 1001))
            if abs(num / 1001 - fps) < 1e-6:
                ratio = f"{num}:1001"      # NTSC rates (23.976, 29.97, ...)
            else:
                ratio = f"{int(round(fps * 1000))}:1000"
        cs = "C420mpeg2" if pixfmt == NV12 else "C420p10"
        fh.write(f"YUV4MPEG2 W{width} H{height} F{ratio} Ip A1:1 {cs}\n"
                 .encode("ascii"))
        self._n = 0
        # persistent repack scratch: the write path allocates nothing per
        # frame (the reference recycles output images through
        # mp_image_pool; our sink equivalent is reused scratch planes)
        self._u = self._v = self._ybuf = None

    def write(self, frame: VideoFrame):
        from mpv_frame_interpolator import native
        self._fh.write(b"FRAME\n")
        w = frame.fmt.width
        y = frame.y[:, :w]
        h, hc = y.shape[0], frame.uv.shape[0]
        if self._u is None:
            dt = frame.y.dtype
            self._u = np.empty((hc, w // 2), dt)
            self._v = np.empty((hc, w // 2), dt)
            self._ybuf = np.empty((h, w), dt)
        native.deinterleave_chroma_into(frame.uv[:, :w], self._u, self._v)
        if self.pixfmt == P010:
            np.right_shift(y, 6, out=self._ybuf)
            y = self._ybuf
            np.right_shift(self._u, 6, out=self._u)
            np.right_shift(self._v, 6, out=self._v)
        elif not y.flags.c_contiguous:
            np.copyto(self._ybuf, y)
            y = self._ybuf
        self._fh.write(y)
        self._fh.write(self._u)
        self._fh.write(self._v)
        self._n += 1

    def close(self):
        self._fh.flush()


class RawYUVReader:
    """Raw planar I420 (8-bit) or I420 10LE reader; geometry supplied by the
    caller (like mpv's demux_raw --demuxer-rawvideo-*)."""

    def __init__(self, fh: BinaryIO, width: int, height: int, fps: float,
                 pixfmt: str = NV12, start_pts: float = 0.0):
        self.fmt = FrameFormat(width, height, pixfmt)
        self._fh = fh
        self.fps = fps
        self._pts = start_pts
        self._start_pts = start_pts
        itemsize = self.fmt.dtype().itemsize
        self._payload = (width * height
                         + 2 * (width // 2) * (height // 2)) * itemsize
        try:
            self._data_start = fh.tell()
            self._seekable = bool(fh.seekable())
        except (OSError, AttributeError):
            self._data_start = 0
            self._seekable = False

    def seekable(self) -> bool:
        return self._seekable

    def n_frames(self) -> int:
        if not self._seekable:
            raise ValueError("stream is not seekable")
        pos = self._fh.tell()
        end = self._fh.seek(0, 2)
        self._fh.seek(pos)
        return max((end - self._data_start) // self._payload, 0)

    def seek_frame(self, n: int):
        """O(1) byte seek (raw streams are pure fixed-size records)."""
        if not self._seekable:
            raise ValueError("stream is not seekable")
        n = max(int(n), 0)
        self._fh.seek(self._data_start + n * self._payload)
        self._pts = self._start_pts + n / self.fps

    def seek_pts(self, pts: float) -> float:
        n = int(max(pts - self._start_pts, 0.0) * self.fps + 1e-6)
        self.seek_frame(n)
        return self._pts

    def __iter__(self) -> Iterator[VideoFrame]:
        w, h = self.fmt.width, self.fmt.height
        dtype = self.fmt.dtype
        itemsize = dtype().itemsize
        ysz, csz = w * h * itemsize, (w // 2) * (h // 2) * itemsize
        while True:
            buf = self._fh.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                return
            y = np.frombuffer(buf, dtype, w * h, 0).reshape(h, w)
            u = np.frombuffer(buf, dtype, (w // 2) * (h // 2), ysz).reshape(h // 2, w // 2)
            v = np.frombuffer(buf, dtype, (w // 2) * (h // 2), ysz + csz).reshape(h // 2, w // 2)
            if self.fmt.pixfmt == P010:
                y, u, v = (y.astype(np.uint16) << 6), (u.astype(np.uint16) << 6), (v.astype(np.uint16) << 6)
            yield VideoFrame(np.ascontiguousarray(y), interleave_chroma(u, v),
                             self.fmt, pts=self._pts, nominal_fps=self.fps)
            self._pts += 1.0 / self.fps


def open_source(path: str, **kw) -> Iterator[VideoFrame]:
    """Open a media path: .y4m natively; anything else via ffmpeg if
    available (io/decode.py)."""
    if path.endswith(".y4m"):
        return iter(Y4MReader(open(path, "rb"), **kw))
    from mpv_frame_interpolator.io.decode import ffmpeg_source
    return ffmpeg_source(path, **kw)
