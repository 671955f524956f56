"""_phase_stacks construction equality: the low-res mirror assembly
(_phase_stacks_lowres, the fast default) must be bit-identical to the
full-res remap form (_phase_stacks_remap, the general fallback) -- the
stack IS the flow sampler's source, so any construction difference
breaks the golden contract.

Reference semantics: mirror_inside (calcDeltaSumsKernel.cl:84-93)
applied to the full-res sample position, phase-decomposed as
ARCHITECTURE.md section 3 describes."""

import numpy as np
import pytest

import jax.numpy as jnp

from mpv_frame_interpolator.ops import flow as F


def _geom(h, w):
    g = F.FlowGeometry.create(h, w, w)
    assert g.low_h << g.res_scalar == h
    assert g.low_w << g.res_scalar == w
    return g


def _planes(rng, h, w, dtype=np.uint8, hi=256):
    y = rng.integers(0, hi, (h, w)).astype(dtype)
    u = rng.integers(0, hi, (h // 2, w // 2)).astype(dtype)
    v = rng.integers(0, hi, (h // 2, w // 2)).astype(dtype)
    return jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)


@pytest.mark.parametrize("h,w", [(448, 768), (544, 1024), (2160, 3840)])
def test_lowres_assembly_matches_remap(h, w):
    g = _geom(h, w)
    assert g.res_scalar >= 1 and F._FLOW_BLOW <= min(g.low_h, g.low_w)
    rng = np.random.default_rng(h + w)
    y, u, v = _planes(rng, h, w)
    fast = np.asarray(F._phase_stacks_lowres(g, y, u, v))
    ref = np.asarray(F._phase_stacks_remap(g, y, u, v))
    assert fast.shape == ref.shape
    assert np.array_equal(fast, ref)


def test_lowres_assembly_p010_dtype():
    g = _geom(448, 768)
    rng = np.random.default_rng(7)
    y, u, v = _planes(rng, 448, 768, dtype=np.uint16, hi=1 << 16)
    fast = np.asarray(F._phase_stacks_lowres(g, y, u, v))
    ref = np.asarray(F._phase_stacks_remap(g, y, u, v))
    assert np.array_equal(fast, ref)


def test_default_dispatch_picks_lowres():
    """_phase_stacks must route eligible geometries to the low-res form
    and everything else to the remap fallback (never None for exact
    multiples)."""
    g = _geom(544, 1024)
    rng = np.random.default_rng(3)
    y, u, v = _planes(rng, 544, 1024)
    out = np.asarray(F._phase_stacks(g, y, u, v))
    ref = np.asarray(F._phase_stacks_remap(g, y, u, v))
    assert np.array_equal(out, ref)
