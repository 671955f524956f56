"""col_take / deinterleave_uv are bit-identical to the strided slices
they replace (ops/lanes.py -- the lane-stride slice is ~80x slower on
the chip; these reshape forms must select exactly the same elements)."""

import numpy as np
import jax.numpy as jnp

from mpv_frame_interpolator.ops.lanes import col_take, deinterleave_uv
from mpv_frame_interpolator.ops.flow import FlowGeometry
from mpv_frame_interpolator.ops import warp as W


def test_col_take_matches_slice():
    rng = np.random.default_rng(7)
    for shape in [(5, 64), (3, 7, 32), (17, 30)]:
        x = rng.integers(0, 255, size=shape, dtype=np.uint8)
        for s in (1, 2, 3, 4, 8):
            for off in range(min(s, 3)):
                got = np.asarray(col_take(jnp.asarray(x), s, off))
                np.testing.assert_array_equal(got, x[..., off::s])


def test_col_take_non_multiple_width_falls_back():
    x = np.arange(5 * 13, dtype=np.int32).reshape(5, 13)
    for s in (2, 4):
        np.testing.assert_array_equal(
            np.asarray(col_take(jnp.asarray(x), s)), x[:, ::s])


def test_deinterleave_uv_matches():
    rng = np.random.default_rng(11)
    uv = rng.integers(0, 255, size=(9, 40), dtype=np.uint8)
    u, v = deinterleave_uv(jnp.asarray(uv))
    np.testing.assert_array_equal(np.asarray(u), uv[:, 0::2])
    np.testing.assert_array_equal(np.asarray(v), uv[:, 1::2])


def test_upsample_uv_half_matches_sliced_upsample():
    rng = np.random.default_rng(13)
    for h, w_stride, aw, mcr in [(64, 96, 90, 270), (128, 128, 128, 32),
                                 (48, 64, 64, 12)]:
        geom = FlowGeometry.create(h, w_stride, aw, max_calc_res=mcr)
        lo = rng.integers(0, 255,
                          size=(geom.low_h, geom.low_w), dtype=np.uint8)
        lo = jnp.asarray(lo)
        full = np.asarray(W._upsample_uv(geom, lo))
        half = np.asarray(W._upsample_uv_half(geom, lo))
        np.testing.assert_array_equal(half, full[:, 0::2])
