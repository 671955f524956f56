"""Image-sequence source: the reference's demux_mf analog.

mpv plays still-image sequences as video via ``mf://`` URLs
(/root/reference/demux/demux_mf.c): glob patterns, printf-style ``%d``
sequence patterns, comma-separated filename lists, and ``@listfile``
indirection, paced by ``--mf-fps`` (default 1).  This module is that
demuxer for the formats this image can decode without FFmpeg:

  * JPEG  (.jpg/.jpeg/.jpe) -- native baseline decoder (io/jpeg.py)
  * PNG   (.png)            -- stdlib-zlib decoder (utils/png.py)
  * PNM   (.pgm/.ppm/.pnm)  -- parsed here (P5 gray / P6 RGB, maxval 255)

Every frame list is fully resolved up front (demux_mf does the same --
``mf_add_filename`` builds the complete play list before playback), so
seeking is O(1) by index.  RGB/gray inputs ride the BT.709
limited-range conversion in io/convert.py; odd geometries are edge-
padded to the even NV12 grid exactly like the MJPEG path.

Geometry is pinned by the first image (the engine compiles per
geometry); later images that differ are scaled to match via
io/filters.scale -- mpv instead reconfigures the chain per size change
(demux_mf emits per-file codec packets), which a fixed-geometry
compiled pipeline cannot do mid-stream.
"""

from __future__ import annotations

import glob as _glob
import os
import re
from typing import Iterator, List

import numpy as np

from mpv_frame_interpolator.frame import NV12, VideoFrame
from mpv_frame_interpolator.io.convert import rgb_to_frame
from mpv_frame_interpolator.utils.logging import get_logger

log = get_logger("mf")

_IMAGE_EXTS = (".jpg", ".jpeg", ".jpe", ".png", ".pgm", ".ppm", ".pnm")


class MFError(ValueError):
    pass


def is_image_path(name: str) -> bool:
    return name.lower().endswith(_IMAGE_EXTS)


def _natural_key(name: str):
    """Numeric-run-aware sort key (demux_mf sorts with strverscmp via
    versort so frame_9 < frame_10; plain lexical sort would not)."""
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", os.path.basename(name))] + [name]


def expand_mf_pattern(spec: str, max_probe: int = 100000) -> List[str]:
    """``mf://`` pattern -> ordered filename list (demux_mf.c:parse_mf).

    Forms, tried in this order exactly like the reference:
      @list.txt        one filename per line (# comments skipped)
      a.png,b.png      explicit comma-separated list
      frame_%04d.png   printf sequence -- probed from index 0, tolerating
                       up to 5 cumulative missing indices like the
                       reference (demux_mf.c: ``error_count < 5`` without
                       reset, so sequences starting at 2-4 and single
                       mid-sequence gaps both work; bounded by
                       ``max_probe``).  Exactly one ``%[.][NUM]d``
                       specifier is allowed (``%%`` escapes a literal).
      frame_*.png      glob, natural-sorted
      prefix           no glob magic and the file doesn't exist: globbed
                       as ``prefix*`` (the reference appends ``*``)
      single.png       one existing file
    """
    spec = spec[5:] if spec.startswith("mf://") else spec
    if not spec:
        raise MFError("empty mf:// pattern")
    if spec.startswith("@"):
        try:
            with open(spec[1:], "r") as fh:
                names = [ln.strip() for ln in fh]
        except OSError as e:
            raise MFError(f"cannot read mf list {spec[1:]!r}: {e}") from None
        base = os.path.dirname(spec[1:])
        out = []
        for n in names:
            if not n or n.startswith("#"):
                continue
            out.append(n if os.path.isabs(n) else os.path.join(base, n))
        return out
    if "," in spec:
        return [n for n in (s.strip() for s in spec.split(",")) if n]
    if re.search(r"%\.?\d*d", spec):
        # validate: exactly one %[.][NUM]d conversion, %% escapes allowed,
        # nothing else (demux_mf.c rejects other specifiers gracefully
        # instead of crashing in the formatter)
        n_conv, i = 0, 0
        while i < len(spec):
            if spec[i] != "%":
                i += 1
                continue
            m = re.match(r"%(?:%|\.?\d*d)", spec[i:])
            if m is None:
                raise MFError(
                    f"mf pattern {spec!r}: only a single %%[.][NUM]d "
                    f"specifier is supported")
            if m.group(0) != "%%":
                n_conv += 1
            i += m.end()
        if n_conv != 1:
            raise MFError(f"mf pattern {spec!r} has {n_conv} %d "
                          f"specifiers; exactly one is supported")
        out, misses = [], 0
        for k in range(max_probe):
            name = spec % k
            if os.path.exists(name):
                out.append(name)
            else:
                # reference behavior: up to 5 CUMULATIVE misses without
                # reset (sequences starting at 2-4 are found; one
                # mid-sequence gap doesn't end playback)
                misses += 1
                if misses >= 5:
                    break
        return out
    if _glob.has_magic(spec):
        return sorted(_glob.glob(spec), key=_natural_key)
    if not os.path.exists(spec):
        # reference behavior: a magicless, %-less pattern gets '*'
        # appended, so mf://dir/prefix expands to prefix*
        hits = sorted(_glob.glob(_glob.escape(spec) + "*"),
                      key=_natural_key)
        if hits:
            return hits
    return [spec]


def _read_pnm(data: bytes) -> np.ndarray:
    """P5 (gray) / P6 (RGB) binary PNM, maxval <= 255."""
    toks, pos = [], 2
    if data[:2] not in (b"P5", b"P6"):
        raise MFError("not a binary PNM (P5/P6)")
    while len(toks) < 3 and pos < len(data):
        c = data[pos:pos + 1]
        if c == b"#":
            nl = data.find(b"\n", pos)
            pos = len(data) if nl < 0 else nl + 1
        elif c.isspace():
            pos += 1
        else:
            end = pos
            while end < len(data) and not data[end:end + 1].isspace():
                end += 1
            toks.append(data[pos:end])
            pos = end
    if len(toks) < 3:
        raise MFError("truncated PNM header")
    try:
        w, h, maxval = (int(t) for t in toks)
    except ValueError:
        raise MFError("bad PNM header") from None
    if maxval > 255 or maxval <= 0 or w <= 0 or h <= 0:
        raise MFError(f"unsupported PNM geometry/maxval {w}x{h}/{maxval}")
    pos += 1  # single whitespace after maxval
    ch = 3 if data[:2] == b"P6" else 1
    need = w * h * ch
    px = np.frombuffer(data, np.uint8, count=min(need, len(data) - pos),
                       offset=pos)
    if px.size != need:
        raise MFError("truncated PNM pixel data")
    return px.reshape(h, w, 3) if ch == 3 else px.reshape(h, w)


def decode_image_frame(path: str, pts: float = 0.0,
                       nominal_fps: float = 0.0,
                       pixfmt: str = NV12) -> VideoFrame:
    """One image file -> 4:2:0 VideoFrame (even-padded, BT.709 for RGB)."""
    low = path.lower()
    if low.endswith((".jpg", ".jpeg", ".jpe")):
        from mpv_frame_interpolator.io.jpeg import decode_jpeg_frame
        with open(path, "rb") as fh:
            frame = decode_jpeg_frame(fh.read(), pts=pts,
                                      nominal_fps=nominal_fps)
        if pixfmt != frame.fmt.pixfmt:
            from mpv_frame_interpolator.io.convert import convert_frame
            frame = convert_frame(frame, pixfmt)
            frame.pts, frame.nominal_fps = pts, nominal_fps
        return frame
    if low.endswith(".png"):
        from mpv_frame_interpolator.utils.png import decode_png
        with open(path, "rb") as fh:
            arr = decode_png(fh.read())
    elif low.endswith((".pgm", ".ppm", ".pnm")):
        with open(path, "rb") as fh:
            arr = _read_pnm(fh.read())
    else:
        raise MFError(f"unsupported image type: {path!r}")
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    h, w = arr.shape[:2]
    if (h % 2) or (w % 2):  # NV12 requires even geometry
        arr = np.pad(arr, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    return rgb_to_frame(arr, pixfmt, pts=pts, nominal_fps=nominal_fps)


class MFReader:
    """Sequence-of-images video source with the container-reader surface
    (width/height/fps, iteration, O(1) seek) shared by the y4m/MKV/MP4/AVI
    readers, so the player/engine/CLI treat it like any demuxer."""

    def __init__(self, spec: str, fps: float = 1.0, start_pts: float = 0.0,
                 pixfmt: str = NV12):
        if fps <= 0:
            raise MFError(f"bad --mf-fps {fps}")
        self._files = expand_mf_pattern(spec)
        if not self._files:
            raise MFError(f"mf pattern {spec!r} matched no files")
        missing = [f for f in self._files if not os.path.exists(f)]
        if missing:
            raise MFError(f"mf entries missing: {missing[:3]}")
        self.fps = float(fps)
        self.pixfmt = pixfmt
        self._start_pts = start_pts
        self._pos = 0
        first = decode_image_frame(self._files[0], pixfmt=pixfmt)
        self.fmt = first.fmt
        self.width, self.height = first.fmt.width, first.fmt.height
        self._first = first

    @property
    def files(self) -> List[str]:
        return list(self._files)

    def n_frames(self) -> int:
        return len(self._files)

    def seekable(self) -> bool:
        return True

    def seek_frame(self, n: int):
        self._pos = max(min(int(n), len(self._files)), 0)

    def seek_pts(self, pts: float) -> float:
        n = int(max(pts - self._start_pts, 0.0) * self.fps + 1e-6)
        self.seek_frame(min(n, len(self._files) - 1))
        return self._start_pts + self._pos / self.fps

    def _frame_at(self, n: int) -> VideoFrame:
        pts = self._start_pts + n / self.fps
        if n == 0 and self._first is not None:
            frame = self._first
            frame.pts, frame.nominal_fps = pts, self.fps
            return frame
        frame = decode_image_frame(self._files[n], pts=pts,
                                   nominal_fps=self.fps, pixfmt=self.pixfmt)
        if (frame.fmt.width, frame.fmt.height) != (self.width, self.height):
            # fixed-geometry pipeline: scale stragglers to the first
            # image's grid (mpv reconfigures instead; see module docstring)
            from mpv_frame_interpolator.io.filters import scale
            frame = scale(self.width, self.height)(frame)
            frame.pts, frame.nominal_fps = pts, self.fps
        return frame

    def __iter__(self) -> Iterator[VideoFrame]:
        while self._pos < len(self._files):
            n = self._pos
            self._pos += 1
            try:
                yield self._frame_at(n)
            except (MFError, ValueError) as e:
                log.warning("skipping undecodable image %r: %s",
                            self._files[n], e)

    def close(self):
        self._first = None
