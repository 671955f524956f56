"""Native host data path (_mfi_native C++ extension) with pure-Python
fallbacks.

Build with:  python setup.py build_ext --inplace
"""

from __future__ import annotations

import numpy as np

try:
    from mpv_frame_interpolator import _mfi_native as _native
    HAVE_NATIVE = True
except ImportError:  # pragma: no cover - build-dependent
    _native = None
    HAVE_NATIVE = False


def interleave_chroma_into(u: np.ndarray, v: np.ndarray,
                           out: np.ndarray) -> np.ndarray:
    """out[:, 0::2] = u; out[:, 1::2] = v -- native when available."""
    if HAVE_NATIVE and u.dtype.itemsize in (1, 2):
        _native.interleave_chroma(u, v, out)
        return out
    out[:, 0::2] = u
    out[:, 1::2] = v
    return out


def deinterleave_chroma_into(uv: np.ndarray, u: np.ndarray,
                             v: np.ndarray):
    if HAVE_NATIVE and uv.dtype.itemsize in (1, 2):
        _native.deinterleave_chroma(uv, u, v)
        return u, v
    u[:] = uv[:, 0::2]
    v[:] = uv[:, 1::2]
    return u, v


class FramePool:
    """Recycling frame-buffer pool (video/mp_image_pool.c analog).

    Returns numpy arrays backed by 128-byte-aligned pooled memory when the
    native extension is present; plain numpy allocations otherwise."""

    def __init__(self, max_entries: int = 16):
        self._pool = _native.BufferPool(max_entries) if HAVE_NATIVE else None
        # keyed by buffer address: stable and unique while the buffer is
        # alive (id() of the array can be reused after GC)
        self._live = {}

    def get(self, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if self._pool is None:
            return np.empty(shape, dtype)
        mv = self._pool.get(nbytes)
        arr = np.frombuffer(mv, dtype).reshape(shape)
        self._live[arr.__array_interface__["data"][0]] = mv
        return arr

    def give_back(self, arr: np.ndarray):
        base = arr
        while base.base is not None and isinstance(base.base, np.ndarray):
            base = base.base
        mv = self._live.pop(base.__array_interface__["data"][0], None)
        if mv is not None and self._pool is not None:
            self._pool.give_back(mv)

    def stats(self):
        if self._pool is None:
            return {"hits": 0, "misses": 0, "free": 0}
        return self._pool.stats()
