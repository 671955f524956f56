"""Frame sinks: where output frames go after interpolation.

The reference hands frames to the VO thread (video/out/vo.c) or, offline,
to an encoder (video/out/vo_lavc.c).  The rebuild's sinks:

  NullSink   -- swallow frames, optionally forcing device sync (vo_null
                analog, video/out/vo_null.c)
  Y4MFileSink-- write a .y4m file (vo_lavc/--o analog, the offline
                ground-truth path)
  PsnrSink   -- compare each frame against a caller-supplied reference
                generator (the rebuild's screenshot/PSNR verification
                analog, player/screenshot.c)
  PgmDumpSink-- dump luma planes as PGM images for eyeballing
"""

from __future__ import annotations

import os
from typing import Callable, List

import numpy as np

from mpv_frame_interpolator.frame import VideoFrame, psnr_arrays
from mpv_frame_interpolator.io.y4m import Y4MWriter
from mpv_frame_interpolator.pipeline.engine import OutputFrame


class NullSink:
    def __init__(self, block: bool = True):
        self.block = block
        self.count = 0
        self.last_pts = None

    def write(self, frame: OutputFrame):
        if self.block:
            frame.block()
        self.count += 1
        self.last_pts = frame.pts

    def close(self):
        pass


class Y4MFileSink:
    def __init__(self, path: str, width: int, height: int, fps: float,
                 pixfmt: str = "nv12"):
        self._fh = open(path, "wb")
        self._writer = Y4MWriter(self._fh, width, height, fps, pixfmt)
        self.count = 0

    def write(self, frame: OutputFrame):
        self._writer.write(frame.to_video_frame())
        self.count += 1

    def close(self):
        self._writer.close()
        self._fh.close()


class PsnrSink:
    """Measures PSNR of every written frame against reference frames
    produced by `reference_fn(index, pts)` (or a list)."""

    def __init__(self, reference_fn: Callable[[int, float], VideoFrame],
                 plane: str = "y"):
        self.reference_fn = reference_fn
        self.plane = plane
        self.values: List[float] = []

    def write(self, frame: OutputFrame):
        vf = frame.to_video_frame()
        ref = self.reference_fn(len(self.values), frame.pts)
        w = min(vf.fmt.width, ref.fmt.width)
        if self.plane == "y":
            a, b = vf.y[:, :w], ref.y[:, :w]
        else:
            a, b = vf.uv[:, :w], ref.uv[:, :w]
        self.values.append(psnr_arrays(a, b, vf.fmt.max_value))

    @property
    def min(self) -> float:
        return min(self.values) if self.values else 0.0

    @property
    def mean(self) -> float:
        finite = [v for v in self.values if v != float("inf")]
        return sum(finite) / len(finite) if finite else float("inf")

    def close(self):
        pass


class OsdSink:
    """Burns a stats line into each frame's luma before forwarding to an
    inner sink (the headless analog of the player OSD stats overlay,
    sub/osd.c + player OSD level 3).  Reads live engine telemetry when an
    engine is attached."""

    def __init__(self, inner, engine=None, scale: int = 2):
        self.inner = inner
        self.engine = engine
        self.scale = scale
        self.count = 0

    def _text(self, frame: OutputFrame) -> str:
        if self.engine is None:
            return f"pts {frame.pts:8.3f}"
        e = self.engine
        ms = e.stats.last("source_frame_time") * 1e3
        return (f"{frame.pts:7.2f}s r{e.quality.search_radius} "
                f"{e.cadence.state.name} {ms:5.2f}ms")

    def write(self, frame: OutputFrame):
        from mpv_frame_interpolator.utils.osd import draw_text
        vf = frame.to_video_frame()
        y = np.ascontiguousarray(vf.y)
        draw_text(y, self._text(frame), scale=self.scale)
        self.count += 1
        self.inner.write(OutputFrame(frame.pts, vf.fmt, y, vf.uv,
                                     host=True))

    def close(self):
        self.inner.close()


class PngDumpSink:
    """Dump every output as a COLOR PNG (BT.709 YUV->RGB) -- the
    image-file half of the screenshot subsystem (player/screenshot.c ->
    image_writer.c; PNG encoded in-repo, utils/png.py, since FFmpeg may
    be absent)."""

    def __init__(self, directory: str, prefix: str = "frame"):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.prefix = prefix
        self.count = 0

    def write(self, frame: OutputFrame):
        from mpv_frame_interpolator.io.convert import frame_to_rgb
        from mpv_frame_interpolator.utils.png import write_png
        path = os.path.join(self.directory,
                            f"{self.prefix}_{self.count:06d}.png")
        write_png(path, frame_to_rgb(frame.to_video_frame()))
        self.count += 1

    def close(self):
        pass


class PgmDumpSink:
    def __init__(self, directory: str, prefix: str = "frame"):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.prefix = prefix
        self.count = 0

    def write(self, frame: OutputFrame):
        vf = frame.to_video_frame()
        w = vf.fmt.width
        y = vf.y[:, :w]
        if y.dtype == np.uint16:
            y = (y >> 8).astype(np.uint8)
        path = os.path.join(self.directory,
                            f"{self.prefix}_{self.count:06d}.pgm")
        with open(path, "wb") as fh:
            fh.write(f"P5\n{w} {y.shape[0]}\n255\n".encode())
            fh.write(np.ascontiguousarray(y).tobytes())
        self.count += 1

    def close(self):
        pass


class FFV1MKVSink:
    """Encode output frames to FFV1 in Matroska (`-o out.mkv`): the
    lossless archival encode path (vo_lavc/--o with -c:v ffv1 analog;
    the reference feeds its encoder through video/out/vo_lavc.c).  NV12
    frames encode as 8-bit 4:2:0 FFV1 v1, P010 as 10-bit (payload
    down-aligned from the high bits).  Uses the native encoder
    (native/ffv1.cpp) when built -- the Python oracle encoder is
    test-vector speed only -- and writes honest per-block keyframe
    flags (all frames are keyframes: every packet is independently
    seekable, ffmpeg -g 1 style)."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 pixfmt: str = "nv12"):
        from mpv_frame_interpolator.io.ffv1 import have_native
        from mpv_frame_interpolator.io.mkv import MKVWriter
        self._deep = pixfmt == "p010"
        self._bits = 10 if self._deep else 8
        self._w, self._h = width, height
        self._fh = open(path, "wb")
        self._writer = MKVWriter(self._fh, width, height, fps,
                                 codec_id="V_FFV1")
        self._native = None
        if have_native():
            from mpv_frame_interpolator.native import _native
            self._native = _native.ffv1_enc_create(width, height,
                                                   self._bits)
        else:
            from mpv_frame_interpolator.io import ffv1 as _ffv1
            self._enc = _ffv1.FFV1Encoder(
                width, height, _ffv1.FFV1Params(bits=self._bits))
        self.count = 0

    def write(self, frame: OutputFrame):
        from mpv_frame_interpolator.frame import split_chroma
        vf = frame.to_video_frame()
        y, (u, v) = vf.y, split_chroma(vf.uv)
        if self._deep:      # P010 payload rides the high bits
            sh = 16 - self._bits
            y = (y >> sh).astype(np.uint16)
            u = (u >> sh).astype(np.uint16)
            v = (v >> sh).astype(np.uint16)
        if self._native is not None:
            from mpv_frame_interpolator.native import _native
            pkt = _native.ffv1_encode(
                self._native, np.ascontiguousarray(y).tobytes(),
                np.ascontiguousarray(u).tobytes(),
                np.ascontiguousarray(v).tobytes(), True)
        else:
            pkt = self._enc.encode([y, u, v])
        self._writer.add(pkt, keyframe=True, pts=vf.pts)
        self.count += 1

    def close(self):
        self._writer.close()
        self._fh.close()
