"""Frame containers: NV12 (8-bit) and P010 (10-bit) biplanar YUV 4:2:0.

Replaces the reference's mp_image (reference: video/mp_image.h:86-131) for the
slice of metadata HopperRender actually consumes: planes + stride, pts,
nominal_fps (video/mp_image.h:105, set by the decoder at
filters/f_decoder_wrapper.c:853) and width-vs-stride distinction
(vf_HopperRender.c:446 passes img->stride[0] as frameWidth and img->w as
actualWidth).

Host frames are NumPy arrays; device-resident state lives in the engine's
pytree (see pipeline/engine.py), not here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

# Pixel formats (reference: video/img_format.h:235 IMGFMT_NV12, :237 IMGFMT_P010)
NV12 = "nv12"
P010 = "p010"

_DTYPES = {NV12: np.uint8, P010: np.uint16}


@dataclasses.dataclass(frozen=True)
class FrameFormat:
    """Geometry + sample format of a biplanar 4:2:0 frame.

    ``stride`` is the luma row length in samples (not bytes); the chroma plane
    shares it (interleaved U,V pairs at half vertical resolution).  The
    reference distinguishes the encoded width from the allocation stride
    (opticalFlowCalc.h:13-15 frameWidth/actualWidth); we reproduce that so
    golden tests can run against strided layouts.
    """

    width: int                 # encoded ("actual") width in pixels
    height: int                # frame height in pixels (must be even)
    pixfmt: str = NV12         # NV12 | P010
    stride: Optional[int] = None  # luma samples per row; None -> width
    # colorimetry tags, passed through untouched (the reference copies
    # mp_image params across the filter, video/mp_image.c:538; the
    # interpolator itself is colorspace-agnostic).  HDR10 content is
    # typically primaries=bt.2020 transfer=pq.
    primaries: str = "bt.709"   # bt.709 | bt.2020 | ...
    transfer: str = "bt.1886"   # bt.1886 | pq | hlg | ...
    matrix: str = "bt.709"      # YUV matrix coefficient tag

    def __post_init__(self):
        if self.pixfmt not in _DTYPES:
            raise ValueError(f"unsupported pixfmt {self.pixfmt!r}")
        if self.height % 2 or self.width % 2:
            raise ValueError("4:2:0 requires even dimensions")
        if self.stride is None:
            object.__setattr__(self, "stride", self.width)
        if self.stride < self.width:
            raise ValueError("stride must be >= width")

    @property
    def dtype(self):
        return _DTYPES[self.pixfmt]

    @property
    def bit_depth(self) -> int:
        return 8 if self.pixfmt == NV12 else 10

    @property
    def max_value(self) -> int:
        # P010 carries 10-bit payload in the upper bits of 16-bit words.
        return 255 if self.pixfmt == NV12 else 65535

    def luma_shape(self):
        return (self.height, self.stride)

    def chroma_shape(self):
        return (self.height // 2, self.stride)


@dataclasses.dataclass
class VideoFrame:
    """One decoded frame: luma plane, interleaved-chroma plane, timing."""

    y: np.ndarray              # (H, stride) uint8|uint16
    uv: np.ndarray             # (H//2, stride) interleaved U,V
    fmt: FrameFormat
    pts: float = 0.0           # presentation timestamp, seconds
    nominal_fps: float = 0.0   # container/decoder frame rate (0 = unknown)
    # buffer-recycling hook (mp_image_pool unref analog): when set, the
    # consumer that copies the planes off-host (engine.stage) calls it once
    # the copy is complete so the source can reuse the buffers.  The planes
    # MUST NOT be touched after calling it.
    recycle: Optional[Callable[[], None]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        assert self.y.shape == self.fmt.luma_shape(), (self.y.shape, self.fmt)
        assert self.uv.shape == self.fmt.chroma_shape()
        assert self.y.dtype == self.fmt.dtype and self.uv.dtype == self.fmt.dtype

    @classmethod
    def blank(cls, fmt: FrameFormat, pts: float = 0.0, nominal_fps: float = 0.0):
        neutral = 128 if fmt.pixfmt == NV12 else 128 << 8
        return cls(
            y=np.zeros(fmt.luma_shape(), fmt.dtype),
            uv=np.full(fmt.chroma_shape(), neutral, fmt.dtype),
            fmt=fmt,
            pts=pts,
            nominal_fps=nominal_fps,
        )

    def copy(self) -> "VideoFrame":
        return VideoFrame(self.y.copy(), self.uv.copy(), self.fmt, self.pts, self.nominal_fps)

    def with_pts(self, pts: float) -> "VideoFrame":
        return VideoFrame(self.y, self.uv, self.fmt, pts, self.nominal_fps)


def split_chroma(uv: np.ndarray):
    """NV12 interleaved UV -> planar (u, v), each (H/2, stride/2)."""
    return uv[:, 0::2], uv[:, 1::2]


def interleave_chroma(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Planar (u, v) -> NV12 interleaved UV plane (native repack when the
    _mfi_native extension is built)."""
    from mpv_frame_interpolator import native
    uv = np.empty((u.shape[0], u.shape[1] * 2), u.dtype)
    return native.interleave_chroma_into(np.ascontiguousarray(u),
                                         np.ascontiguousarray(v), uv)


def psnr(a: VideoFrame, b: VideoFrame, plane: str = "y") -> float:
    """PSNR between two frames' planes (over the encoded width only)."""
    assert a.fmt.pixfmt == b.fmt.pixfmt
    w = min(a.fmt.width, b.fmt.width)
    if plane == "y":
        pa, pb = a.y[:, :w], b.y[:, :w]
    else:
        pa, pb = a.uv[:, :w], b.uv[:, :w]
    return psnr_arrays(pa, pb, a.fmt.max_value)


def psnr_arrays(pa: np.ndarray, pb: np.ndarray, peak: float) -> float:
    mse = np.mean((pa.astype(np.float64) - pb.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
