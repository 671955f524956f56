"""Scanned pyramid == unrolled pyramid, bit for bit (VERDICT r1 item 7).

The scan form (one traced step body; ~4x faster cold compile) must stay
bit-identical to the round-1 unrolled form -- the integral-image block
reduction is exact under uint32 mod-2^32 arithmetic, and this test pins
that across geometries, radii, and both bit depths.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mpv_frame_interpolator.frame import split_chroma
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.ops.flow import FlowGeometry, _flow_impl
from mpv_frame_interpolator.ops.oracle import MAX_SEARCH_RADIUS


def planes(cfg, source="gradient_pan"):
    g = getattr(synthetic, source)(cfg, 2)
    f1, f2 = next(g), next(g)
    return [jnp.asarray(x) for x in (f1.y, *split_chroma(f1.uv),
                                     f2.y, *split_chroma(f2.uv))]


@pytest.mark.parametrize("w,h,radius", [
    (96, 64, 5),           # res_scalar 0
    (96, 64, 16),
    (320, 180, 8),         # res_scalar 1
    (128, 544, 11),        # res_scalar 2, tall (partial edge windows)
    (100, 56, 7),          # odd-ish geometry
])
def test_scan_matches_unroll(w, h, radius):
    cfg = synthetic.SyntheticConfig(width=w, height=h)
    a = planes(cfg)
    geom = FlowGeometry.create(h, w, w)
    kw = dict(layers=MAX_SEARCH_RADIUS)
    o1, b1 = _flow_impl(geom, jnp.int32(radius), 0, *a, jnp.int32(8),
                        jnp.int32(6), program="scan", **kw)
    o2, b2 = _flow_impl(geom, jnp.int32(radius), 0, *a, jnp.int32(8),
                        jnp.int32(6), program="unroll", **kw)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))


def test_scan_matches_unroll_p010():
    cfg = synthetic.SyntheticConfig(width=96, height=64, pixfmt="p010")
    a = planes(cfg)
    geom = FlowGeometry.create(64, 96, 96)
    o1, b1 = _flow_impl(geom, jnp.int32(9), 8, *a, jnp.int32(8),
                        jnp.int32(6), program="scan",
                        layers=MAX_SEARCH_RADIUS)
    o2, b2 = _flow_impl(geom, jnp.int32(9), 8, *a, jnp.int32(8),
                        jnp.int32(6), program="unroll",
                        layers=MAX_SEARCH_RADIUS)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))
