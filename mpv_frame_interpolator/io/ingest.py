"""Native streaming ingest: C++ demuxer thread + recycled frame buffers.

The reference's ingest is a demux thread filling a packet cache
(demux/demux.c:2549,1187) and a frame pool recycling every image buffer
(video/mp_image_pool.c, drawn from at vf_HopperRender.c:385).  This module
is the rebuild's host ingest for its interchange format:

* `_mfi_native.Y4MRing` runs a C++ reader thread (no GIL) that reads each
  y4m FRAME record straight into a registered luma buffer and repacks the
  planar U,V planes into the interleaved NV12/P010 chroma buffer -- read
  and repack are fused, and the P010 << 6 shift rides the same pass.
* A fixed set of frame buffers rotates between Python and the ring: pop()
  yields a filled frame; once the engine has staged it to HBM the frame's
  `recycle` hook re-registers the buffers.  Steady-state ingest therefore
  allocates NOTHING per frame.
* Backpressure is natural: the C++ thread blocks when every buffer is in
  flight, exactly like the reference's bounded packet queue.

Falls back to the pure-Python Y4MReader (io/y4m.py) when the native
extension isn't built.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from mpv_frame_interpolator.frame import FrameFormat, P010, VideoFrame
from mpv_frame_interpolator.io import y4m as y4m_mod
from mpv_frame_interpolator.native import HAVE_NATIVE, _native
from mpv_frame_interpolator.utils import get_logger

log = get_logger("ingest")


def have_native_ingest() -> bool:
    return HAVE_NATIVE and hasattr(_native, "Y4MRing")


class NativeY4MSource:
    """Seekable y4m source backed by the C++ demuxer ring.

    Iterates VideoFrames whose buffers are recycled via `frame.recycle`;
    a frame's planes are valid until that hook is called (the pipeline's
    staging path calls it right after the host->HBM copy completes)."""

    def __init__(self, path, ring_depth: int = 4,
                 start_pts: float = 0.0):
        """`path` is a filesystem path, or an unbuffered binary file
        object / raw fd for pipe ingest (stdin): the C++ ring reads any
        fd; only byte-seeking needs a real file."""
        if not have_native_ingest():
            raise RuntimeError("native extension not built; use Y4MReader")
        if isinstance(path, str):
            self._fh = open(path, "rb", buffering=0)
        elif isinstance(path, int):
            self._fh = os.fdopen(path, "rb", buffering=0, closefd=False)
        else:
            self._fh = path           # unbuffered binary file object
        header = self._read_line()
        (self.width, self.height, self.fps,
         self.pixfmt) = y4m_mod.parse_header(header.decode("ascii", "replace").strip())
        if self.width % 2 or self.height % 2:
            raise y4m_mod.Y4MError(
                "native ingest requires even dimensions; "
                "use the Python reader for odd-sized streams")
        self.fmt = FrameFormat(self.width, self.height, self.pixfmt)
        self._dtype = self.fmt.dtype
        self._itemsize = self._dtype().itemsize
        self._shift = 6 if self.pixfmt == P010 else 0
        self._dt = 1.0 / self.fps if self.fps > 0 else 1.0 / 24.0
        self._start_pts = start_pts
        self._frame_index = 0
        self._payload = (self.width * self.height
                         + 2 * (self.width // 2) * (self.height // 2)
                         ) * self._itemsize
        # learn the FRAME marker length for O(1) seeks (constant-marker
        # streams; every common producer emits a fixed line).  Pipes
        # cannot rewind: they stream fine but report seekable()=False.
        self._marker_len = 0
        try:
            self._data_start = self._fh.tell()
            if self._fh.seekable():
                marker = self._read_line()
                if marker.startswith(b"FRAME"):
                    self._marker_len = len(marker)
                self._fh.seek(self._data_start)
        except OSError:
            self._data_start = -1

        self._ring_depth = ring_depth
        self._frames = {}        # tag -> (y, uv) buffer pair, stable forever
        self._outstanding = set()  # tags currently owned by consumers
        self._recycled = 0
        self._ring = None
        self._open_ring()

    def _read_line(self) -> bytes:
        out = bytearray()
        while True:
            b = self._fh.read(1)
            if not b:
                break
            out += b
            if b == b"\n" or len(out) > 4096:
                break
        return bytes(out)

    def _open_ring(self):
        self._ring = _native.Y4MRing(self._fh.fileno(), self.width,
                                     self.height, self._itemsize,
                                     self._shift)
        hc, wc = self.height // 2, self.width
        while len(self._frames) < self._ring_depth:
            tag = len(self._frames)
            self._frames[tag] = (
                np.empty((self.height, self.width), self._dtype),
                np.empty((hc, wc), self._dtype))
        for tag, (y, uv) in self._frames.items():
            if tag not in self._outstanding:
                self._ring.push_free(tag, y, uv)

    def _recycle(self, tag: int):
        if tag not in self._outstanding:
            return
        self._outstanding.discard(tag)
        self._recycled += 1
        y, uv = self._frames[tag]
        try:
            self._ring.push_free(tag, y, uv)
        except RuntimeError:
            pass                     # ring stopped mid-recycle (teardown)

    def _grow_if_starved(self, dtype):
        """mp_image_pool semantics (video/mp_image_pool.c): when the
        consumer still holds every buffer (e.g. collecting frames without
        recycling), allocate one more pair instead of deadlocking the
        reader thread.  The prompt-recycle hot path never triggers this."""
        if len(self._outstanding) >= len(self._frames):
            tag = len(self._frames)
            pair = (np.empty((self.height, self.width), dtype),
                    np.empty((self.height // 2, self.width), dtype))
            self._frames[tag] = pair
            self._ring.push_free(tag, *pair)

    def __iter__(self) -> Iterator[VideoFrame]:
        while True:
            self._grow_if_starved(self._dtype)
            tag = self._ring.pop()
            if tag is None:
                return
            self._outstanding.add(tag)
            y, uv = self._frames[tag]
            pts = self._start_pts + self._frame_index * self._dt
            self._frame_index += 1
            yield VideoFrame(
                y, uv, self.fmt, pts=pts, nominal_fps=self.fps,
                recycle=(lambda t=tag: self._recycle(t)))

    # -- seek (demux_seek analog; O(1) byte repositioning) ----------------

    def seekable(self) -> bool:
        return self._marker_len > 0

    def n_frames(self) -> int:
        end = os.fstat(self._fh.fileno()).st_size
        rec = self._marker_len + self._payload
        return max((end - self._data_start) // rec, 0)

    def seek_frame(self, n: int):
        if not self.seekable():
            raise y4m_mod.Y4MError("stream is not seekable")
        n = max(int(n), 0)
        self._ring.stop()
        rec = self._marker_len + self._payload
        self._fh.seek(self._data_start + n * rec)
        self._frame_index = n
        self._open_ring()

    def seek_pts(self, pts: float) -> float:
        n = int(max(pts - self._start_pts, 0.0) / self._dt + 1e-6)
        self.seek_frame(n)
        return self._start_pts + n * self._dt

    def stats(self) -> dict:
        s = self._ring.stats()
        s["recycled"] = self._recycled
        s["outstanding"] = len(self._outstanding)
        return s

    def close(self):
        if self._ring is not None:
            self._ring.stop()
        self._fh.close()


class NativeIndexedSource:
    """Container-indexed native ingest: MKV (V_UNCOMPRESSED) / MP4 raw
    video streamed by the C++ IndexedRing into recycled buffers.

    Python parses the container ONCE (io/mkv.py / io/mp4.py build the
    frame-offset index); the C++ thread preads each payload at its indexed
    offset into a registered luma buffer and interleaves I420 chroma into
    NV12 on the same pass.  Same zero-alloc recycling contract as
    NativeY4MSource; seek is O(1) (restart the ring at index n)."""

    def __init__(self, reader, ring_depth: int = 4):
        """`reader` is an already-constructed MKVReader or MP4Reader (both
        expose _index [(offset, size, pts)], _layout 'i420'|'nv12', and an
        open file)."""
        if not have_native_ingest() or not hasattr(_native, "IndexedRing"):
            raise RuntimeError("native extension not built; iterate the "
                               "container reader directly")
        self._reader = reader
        self.width, self.height = reader.width, reader.height
        self.fps = reader.fps
        self.fmt = reader.fmt
        self.pixfmt = reader.fmt.pixfmt
        self._layout = reader._layout
        if self._layout not in ("i420", "nv12"):
            # compressed payloads (e.g. MJPEG) decode in the Python
            # reader; the pread ring only repacks raw planes
            raise ValueError(f"indexed ring handles raw layouts only, "
                             f"not {self._layout!r}")
        self._start_pts = getattr(reader, "_start_pts", 0.0)
        expected = self.width * self.height * 3 // 2
        index = reader._index
        for off, size, _ in index:
            if size < expected:
                raise ValueError(
                    f"short frame payload in index ({size} < {expected}); "
                    f"use the Python reader")
        self._offsets = np.ascontiguousarray(
            [off for off, _, _ in index], np.int64)
        self._pts = [pts for _, _, pts in index]
        self._fd = reader._fh.fileno()
        self._frame_index = 0
        self._ring_depth = ring_depth
        self._frames = {}
        self._outstanding = set()
        self._recycled = 0
        self._ring = None
        self._open_ring(0)

    def _open_ring(self, start: int):
        self._ring = _native.IndexedRing(self._fd, self.width, self.height,
                                         self._layout,
                                         self._offsets[start:])
        hc, wc = self.height // 2, self.width
        while len(self._frames) < self._ring_depth:
            tag = len(self._frames)
            self._frames[tag] = (
                np.empty((self.height, self.width), np.uint8),
                np.empty((hc, wc), np.uint8))
        for tag, (y, uv) in self._frames.items():
            if tag not in self._outstanding:
                self._ring.push_free(tag, y, uv)

    def _recycle(self, tag: int):
        if tag not in self._outstanding:
            return
        self._outstanding.discard(tag)
        self._recycled += 1
        y, uv = self._frames[tag]
        try:
            self._ring.push_free(tag, y, uv)
        except RuntimeError:
            pass                     # ring stopped mid-recycle (teardown)

    _grow_if_starved = NativeY4MSource._grow_if_starved

    def __iter__(self) -> Iterator[VideoFrame]:
        while True:
            self._grow_if_starved(np.uint8)
            tag = self._ring.pop()
            if tag is None:
                return
            self._outstanding.add(tag)
            y, uv = self._frames[tag]
            pts = self._start_pts + self._pts[self._frame_index]
            self._frame_index += 1
            yield VideoFrame(
                y, uv, self.fmt, pts=pts, nominal_fps=self.fps,
                recycle=(lambda t=tag: self._recycle(t)))

    # -- seek (index lookup + ring restart; O(1) in stream length) --------

    def seekable(self) -> bool:
        return True

    def n_frames(self) -> int:
        return len(self._pts)

    def seek_frame(self, n: int):
        n = max(min(int(n), len(self._pts)), 0)
        self._ring.stop()
        self._frame_index = n
        self._open_ring(n)

    def seek_pts(self, pts: float) -> float:
        if not self._pts:
            return 0.0
        import bisect
        target = pts - self._start_pts
        # _pts is sorted: last frame with pts <= target, O(log n)
        lo = max(bisect.bisect_right(self._pts, target + 1e-9) - 1, 0)
        self.seek_frame(lo)
        return self._start_pts + self._pts[lo]

    def stats(self) -> dict:
        s = self._ring.stats()
        s["recycled"] = self._recycled
        s["outstanding"] = len(self._outstanding)
        return s

    def close(self):
        if self._ring is not None:
            self._ring.stop()
        self._reader.close()


def open_container(path: str, prefer_native: bool = True, ring_depth: int = 4,
                   start_pts: float = 0.0):
    """Best MKV/MP4 raw-video source for `path`: the native indexed ring
    when built, the pure-Python reader otherwise.  Raises the reader's
    error type for compressed codecs (callers fall back to io/decode.py)."""
    if path.endswith((".mp4", ".mov", ".m4v")):
        from mpv_frame_interpolator.io.mp4 import MP4Reader as cls
    elif path.endswith(".avi"):
        from mpv_frame_interpolator.io.avi import AVIReader as cls
    else:
        from mpv_frame_interpolator.io.mkv import MKVReader as cls
    reader = cls(path, start_pts=start_pts)
    if prefer_native and have_native_ingest() \
            and hasattr(_native, "IndexedRing"):
        try:
            return NativeIndexedSource(reader, ring_depth=ring_depth)
        except (RuntimeError, ValueError) as e:
            log.info("native indexed ingest unavailable for %s (%s); "
                     "using Python reader", path, e)
    return reader


def open_y4m(path: str, prefer_native: bool = True, ring_depth: int = 4,
             start_pts: float = 0.0):
    """Best y4m source for `path`: the native ring when built, the Python
    reader otherwise (or for odd geometries)."""
    if prefer_native and have_native_ingest():
        try:
            return NativeY4MSource(path, ring_depth=ring_depth,
                                   start_pts=start_pts)
        except y4m_mod.Y4MError as e:
            log.info("native ingest unavailable for %s (%s); "
                     "falling back to Python reader", path, e)
    return y4m_mod.Y4MReader(open(path, "rb"), start_pts=start_pts)
