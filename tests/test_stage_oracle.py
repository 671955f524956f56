"""The plain XLA stages against ops/oracle.py, one parametrised test per
stage: a single pyramid step (both candidate samplers), the flow blur,
and the engine's warp stage over a batch of blend positions (both warp
samplers).  The cases cover each step shape the pyramid runs (window
sizes, x/y step parity, neighbor bias, a radius below its layer
bucket), committed fields with one, many and more distinct values than
the shift samplers' budgets (the runtime gather fallbacks), P010 luma,
large displacements, one and many blend positions and the endpoints."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpv_frame_interpolator.frame import interleave_chroma
from mpv_frame_interpolator.ops import flow as F
from mpv_frame_interpolator.ops import oracle
from mpv_frame_interpolator.ops import warp as W
from mpv_frame_interpolator.pipeline.engine import _warp_stage


def _planes8(rng, h, w):
    return (rng.integers(0, 256, (h, w)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))


def _device(planes, p010):
    """P010 planes carry the 8-bit content in their top byte, so the
    8-bit oracle is the reference for both depths."""
    if p010:
        return [jnp.asarray(p.astype(np.uint16) << 8) for p in planes]
    return [jnp.asarray(p) for p in planes]


# --- one pyramid step -------------------------------------------------

# name: (window, neighbor bias, radius, layers, distinct values, seed,
#        p010); the seed's parity picks the x (even) or y (odd) step
FLOW_CASES = {
    "window1": (1, True, 16, 16, 5, 2, False),
    "window2": (2, True, 16, 16, 5, 4, False),
    "window4_no_neighbor_bias": (4, False, 16, 16, 5, 6, False),
    "window16": (16, True, 16, 16, 5, 8, False),
    "x_step": (2, True, 16, 16, 4, 0, False),
    "y_step": (2, True, 16, 16, 4, 1, False),
    "radius5_in_16_layers": (2, True, 5, 16, 5, 3, False),
    "radius8_in_8_layers": (4, True, 8, 8, 5, 10, False),
    "single_distinct_value": (2, True, 16, 16, 1, 5, False),
    "many_distinct_values": (2, True, 16, 16, 11, 7, False),
    "exceeding_distinct_budget": (2, True, 16, 16, F._FLOW_K + 20, 11,
                                  False),
    "p010_luma_shift": (4, True, 16, 16, 5, 9, True),
}


def _committed_field(rng, lh, lw, n_values, rep):
    """(off_x, off_y) drawn from n_values (x, y) pairs, block-constant
    at `rep` -- as every field entering a step of window `rep` is."""
    vy = rng.integers(-20, 20, n_values)
    vx = rng.integers(-20, 20, n_values)
    pick = rng.integers(0, n_values, (-(-lh // rep), -(-lw // rep)))
    fy = vy[pick].repeat(rep, 0).repeat(rep, 1)[:lh, :lw]
    fx = vx[pick].repeat(rep, 0).repeat(rep, 1)[:lh, :lw]
    return fx.astype(np.int32), fy.astype(np.int32)


@pytest.mark.parametrize("sampling", ["shift", "gather"])
@pytest.mark.parametrize("case", list(FLOW_CASES))
def test_flow_step_matches_oracle(case, sampling):
    window, nb, radius, layers, n_values, seed, p010 = FLOW_CASES[case]
    h, w = 48, 64
    geom = F.FlowGeometry.create(h, w, w, max_calc_res=24)   # rs 1
    lh, lw = geom.low_h, geom.low_w
    rng = np.random.default_rng(seed)
    f1, f2 = _planes8(rng, h, w), _planes8(rng, h, w)
    fx, fy = _committed_field(rng, lh, lw, n_values, window)
    if case == "exceeding_distinct_budget":
        assert len(set(zip(fx.ravel(), fy.ravel()))) > F._FLOW_K
    step = seed % 2

    d1, d2 = _device(f1, p010), _device(f2, p010)
    stacks = F._phase_stacks(geom, *d1) if sampling == "shift" else None
    if sampling == "shift":
        assert stacks is not None
    branch = F._make_step_branch(geom, window, nb, layers, 8 if p010 else 0,
                                 *d1, F._subsampled_f2(geom, *d2), stacks)
    ox, oy = jax.jit(branch)(jnp.asarray(fx), jnp.asarray(fy),
                             jnp.int32(step), jnp.int32(radius),
                             jnp.int32(8), jnp.int32(6))

    off = np.stack([fx, fy]).astype(np.int64)
    sums = oracle.calc_delta_sums(
        f1[0], interleave_chroma(f1[1], f1[2]),
        f2[0], interleave_chroma(f2[1], f2[2]), off, window, radius,
        geom.res_scalar, oracle.FIRST_NEIGHBOR_ITERATION if nb else 0,
        step, 8, 6)
    ref = oracle.adjust_offset_array(
        off, oracle.determine_lowest_layer(sums), window, radius, step)
    np.testing.assert_array_equal(np.asarray(ox), ref[0])
    np.testing.assert_array_equal(np.asarray(oy), ref[1])


# --- the flow blur ----------------------------------------------------

BLUR_CASES = {
    "random_odd_shape": (np.random.default_rng(3).integers(
        -500, 500, (2, 37, 53)), ),
    "negative_truncates_toward_zero": (np.full((2, 16, 24), -100), ),
    "full_calc_res_270x480": (np.random.default_rng(4).integers(
        -64, 64, (2, 270, 480)), ),
}


@pytest.mark.parametrize("case", list(BLUR_CASES))
def test_blur_matches_oracle(case):
    (field,) = BLUR_CASES[case]
    field = field.astype(np.int32)
    _, lh, lw = field.shape
    got = F.blur_flow(jnp.asarray(field), lh, lw)
    np.testing.assert_array_equal(np.asarray(got), oracle.blur_flow(field))


# --- the warp stage ---------------------------------------------------

# name: (height, width, flow values (x, y), blend positions, mode, p010)
WARP_CASES = {
    "zero_flow": (64, 96, [(0, 0)], [0.25, 0.5, 0.75],
                  W.BLENDED_FRAME, False),
    "small_multi_value": (64, 96, [(0, 0), (1, 0), (-1, 2), (3, -2),
                                   (-5, -7)], [0.2, 0.4, 0.6, 0.8],
                          W.BLENDED_FRAME, False),
    "large_displacements": (96, 128, [(40, -60), (-80, 33), (127, 127)],
                            [0.1, 0.5, 0.9], W.BLENDED_FRAME, False),
    "single_position": (64, 96, [(2, -3), (0, 5)], [0.5],
                        W.BLENDED_FRAME, False),
    "many_positions": (64, 96, [(1, 1), (-2, 4)],
                       list(np.linspace(0.1, 0.9, 7)), W.BLENDED_FRAME,
                       False),
    "endpoint_t": (64, 96, [(2, 1), (-3, 4)], [0.0, 1.0],
                   W.BLENDED_FRAME, False),
    "res_scalar1_many_values": (
        288, 320, [(x, y) for x in (-9, -3, 0, 4, 11) for y in (-5, 0, 7)],
        [0.6], W.BLENDED_FRAME, False),
    "beyond_distinct_budget": (
        64, 96, [(x, y) for x in range(-6, 6) for y in range(-5, 5)],
        [0.3, 0.7], W.BLENDED_FRAME, False),
    "p010_warp12": (64, 96, [(1, -1), (6, 6)], [0.3, 0.7],
                    W.WARPED_FRAME_12, True),
    "p010_blend_endpoints": (64, 96, [(1, -1), (6, 6)], [0.0, 1.0],
                             W.BLENDED_FRAME, True),
}


@pytest.mark.parametrize("sampling", ["shift", "gather"])
@pytest.mark.parametrize("case", list(WARP_CASES))
def test_warp_stage_matches_oracle(case, sampling):
    h, w, values, ts, mode, p010 = WARP_CASES[case]
    geom = F.FlowGeometry.create(h, w, w)
    rng = np.random.default_rng(len(case))
    f1, f2 = _planes8(rng, h, w), _planes8(rng, h, w)
    pick = rng.integers(0, len(values), (geom.low_h, geom.low_w))
    blurred = np.stack([np.array([v[0] for v in values])[pick],
                        np.array([v[1] for v in values])[pick]]
                       ).astype(np.int32)
    if case == "beyond_distinct_budget":
        assert len(values) > W._ROLL_K

    stage = jax.jit(functools.partial(
        _warp_stage, geom, mode, 8 if p010 else 0, "nearest", False,
        "hopper", warp_sampling=sampling))
    y, uv = stage(*_device(f1, p010), *_device(f2, p010),
                  jnp.asarray(blurred), jnp.float32(0.0),
                  jnp.asarray(np.asarray(ts, np.float32)),
                  jnp.float32(0.0), jnp.float32(255.0), jnp.float32(28.0))
    uv1, uv2 = interleave_chroma(f1[1], f1[2]), interleave_chroma(f2[1],
                                                                  f2[2])
    shift = 8 if p010 else 0
    for n, t in enumerate(np.asarray(ts, np.float32)):
        ry, ruv = oracle.warp_frame(f1[0], uv1, f2[0], uv2, blurred,
                                    float(t), mode, geom.res_scalar, w)
        np.testing.assert_array_equal(
            np.asarray(y[n]), ry.astype(np.uint16) << shift,
            err_msg=f"luma at position {n} (t={t})")
        np.testing.assert_array_equal(
            np.asarray(uv[n]), ruv.astype(np.uint16) << shift,
            err_msg=f"chroma at position {n} (t={t})")
