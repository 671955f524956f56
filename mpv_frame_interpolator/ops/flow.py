"""Hierarchical block-matching optical flow in JAX/XLA.

Re-design of the reference's four flow kernels
(calcDeltaSumsKernel.cl, determineLowestLayerKernel.cl,
adjustOffsetArrayKernel.cl, blurFlowKernel.cl) and their host loop
(opticalFlowCalc.c:126-203):

* The reference launches a 3-D work grid per candidate layer and reduces SAD
  windows with local-memory trees + global atomics.  XLA wants static
  shapes and has no atomics in its array model, so each (iteration, step) becomes one dense computation
  over a (search_radius, lowH, lowW) tensor followed by a reshape-based
  window reduction -- the pyramid's window size is a compile-time constant
  per unrolled iteration (there are only log2(next_pow2(maxdim)/2) of them).
* Frame sampling at candidate offsets is a flat gather from the full-res
  planes; the probe positions for frame2 are a static strided slice.
* All delta/bias sums accumulate in uint32 with natural mod-2**32 wraparound,
  matching the reference's unsigned atomic adds (calcDeltaSumsKernel.cl:187).
* The 8x8 box blur of the final field (blurFlowKernel.cl) is a separable
  16-add shift sum with symmetric edge padding and C-style truncating
  division.

Frames are planar on device: y (H, stride), u and v (H//2, stride//2) --
NV12's interleaved chroma is split at upload so chroma gathers share one
index computation (u/v always use identical sample coordinates,
calcDeltaSumsKernel.cl:97-98).

The flow functions are specialized (jit-cached) per search radius; the
auto-quality controller changes radius between frames, and each of the 12
possible radii compiles once.
"""

from __future__ import annotations

import dataclasses
import functools

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mpv_frame_interpolator.ops import oracle
from mpv_frame_interpolator.ops.lanes import col_take as _col_take

FIRST_NEIGHBOR_ITERATION = oracle.FIRST_NEIGHBOR_ITERATION
BLUR_RADIUS = oracle.BLUR_KERNEL_RADIUS


@dataclasses.dataclass(frozen=True)
class FlowGeometry:
    """Static geometry of one flow problem (one jit specialization).

    Mirrors the derived fields of struct OpticalFlowCalc
    (opticalFlowCalc.c:323-357): res scalar chosen so height>>rs <= 270,
    low dims are ceil(stride/2**rs) x ceil(height/2**rs)."""

    height: int
    stride: int
    actual_width: int
    res_scalar: int
    low_h: int
    low_w: int
    start_window: int
    iterations: int

    @classmethod
    def create(cls, height: int, stride: int, actual_width: int,
               max_calc_res: int = oracle.MAX_CALC_RES,
               num_iter_cfg: int = 0) -> "FlowGeometry":
        rs = oracle.res_scalar_for(height, max_calc_res)
        lh, lw = oracle.low_dims_for(height, stride, rs)
        window = oracle.start_window_size(lh, lw)
        iters = oracle.num_iterations(window, num_iter_cfg)
        return cls(height, stride, actual_width, rs, lh, lw, window, iters)

    def window_schedule(self) -> Tuple[int, ...]:
        """Static (windowSize per iteration) list, opticalFlowCalc.c:156-188."""
        out, w = [], self.start_window
        for _ in range(self.iterations):
            out.append(w)
            w = max(w >> 1, 1)
        return tuple(out)


def _gather(plane, ry, rx):
    """Flat gather plane[ry, rx]; indices must already be in-bounds."""
    h, w = plane.shape
    idx = ry * w + rx
    return jnp.take(plane.reshape(-1), idx, mode="clip")


def mirror_inside(pos, dim: int):
    """calcDeltaSumsKernel.cl:84-93 reflection into [0, dim), then clip."""
    pos = jnp.where(pos >= dim, dim - (pos - dim + 1), pos)
    pos = jnp.where(pos < 0, -pos - 1, pos)
    return jnp.clip(pos, 0, dim - 1)


def _mirror_inside_map(n: int, dim: int) -> np.ndarray:
    """numpy mirror_inside over positions [-n, dim-1+n]."""
    pos = np.arange(-n, dim + n)
    pos = np.where(pos >= dim, dim - (pos - dim + 1), pos)
    pos = np.where(pos < 0, -pos - 1, pos)
    return np.clip(pos, 0, dim - 1)


def _remap_axis(plane, mapping: np.ndarray, axis: int):
    """Apply a static index map along `axis` with slices/flips/repeats
    (never a gather: a static map is plain data movement).  The maps
    used here
    are piecewise linear with steps in {-1, 0, +1}, so they RLE-compress
    to a handful of segments."""
    segs = []
    i, n = 0, len(mapping)
    while i < n:
        j = i
        if j + 1 < n and abs(int(mapping[j + 1]) - int(mapping[j])) == 1:
            step = int(mapping[j + 1]) - int(mapping[j])
            while j + 1 < n and int(mapping[j + 1]) - int(mapping[j]) == step:
                j += 1
            segs.append(("run", int(mapping[i]), int(mapping[j]), step))
        else:
            while j + 1 < n and mapping[j + 1] == mapping[j]:
                j += 1
            segs.append(("const", int(mapping[i]), j - i + 1))
        i = j + 1
    parts = []
    for seg in segs:
        if seg[0] == "const":
            _, v, cnt = seg
            sl = jax.lax.slice_in_dim(plane, v, v + 1, axis=axis)
            parts.append(jnp.repeat(sl, cnt, axis=axis))
        else:
            _, a, b, step = seg
            if step == 1:
                parts.append(jax.lax.slice_in_dim(plane, a, b + 1, axis=axis))
            else:
                parts.append(jnp.flip(
                    jax.lax.slice_in_dim(plane, b, a + 1, axis=axis),
                    axis=axis))
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else parts[0]


# ---------------------------------------------------------------------------
# Phase-decomposed candidate sampling (the default flow path).
#
# The delta-sums step samples f1 at `scaled_c + off + adj_l` -- per-pixel
# gathers, 3 channels x 16 layers per low-res pixel.  But the sample
# positions decompose: `scaled_c` is the strided low-res grid, and
# (off + adj_l) takes FEW distinct values on real content (off is
# block-committed and spatially coherent; adj_l is a per-layer scalar).
# Mirror-pad f1 once per pair, slice it into its (2^rs)^2 phase planes --
# then f1[(c<<rs) + o] == phase[(o & m)][c + (o >> rs)], a LOW-RES dynamic
# slice per distinct offset instead of a gather per pixel.  Chroma planes
# are lifted to the full-res index domain first (each sample repeated 2x2)
# so the kernel's `>> 1` addressing reduces to the same machinery.
# Bit-exact; a per-step runtime fallback to the gather form handles fields
# with more than _FLOW_K distinct offsets or shifts beyond the padding.
# ---------------------------------------------------------------------------

_FLOW_K = 12       # distinct-base-offset budget per pyramid step
_FLOW_BLOW = 96    # low-res padding: covers |off + adj| < _FLOW_BLOW << rs


def _shift_clamped(p, s: int, axis: int):
    """out[..., i] = p[..., clip(i + s, 0, n-1)] with STATIC integer s,
    built from one slice + one edge-repeat (never a gather)."""
    n = p.shape[axis]
    if s == 0:
        return p
    if s > 0:
        k = min(s, n)
        edge = jax.lax.slice_in_dim(p, n - 1, n, axis=axis)
        parts = ([jax.lax.slice_in_dim(p, k, n, axis=axis)] if k < n else []) \
            + [jnp.repeat(edge, k, axis=axis)]
    else:
        k = min(-s, n)
        edge = jax.lax.slice_in_dim(p, 0, 1, axis=axis)
        parts = [jnp.repeat(edge, k, axis=axis)] \
            + ([jax.lax.slice_in_dim(p, 0, n - k, axis=axis)] if k < n else [])
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else parts[0]


def _phase_stacks(geom: FlowGeometry, f1y, f1u, f1v):
    """ONE stack of shape (s*s, 3, lh+2*Bl, lw+2*Bl) such that
    stack[(oy & m)*s + (ox & m), q, Bl + cy + (oy>>rs), Bl + cx + (ox>>rs)]
    == plane_q[mirror_inside(scaled_cy+oy, H), mirror_inside(scaled_cx+ox, W)]
    for plane_q in (y, u, v), with the chroma planes' `>>1` addressing
    already folded in.  The three planes INTERLEAVE one stack so the
    sampler fetches a candidate's y+u+v with a single dynamic slice
    (per-op overhead, not bandwidth, bounds the sampling stage).
    Returns None when the geometry is not phase-decomposable.

    Construction: the build cost is a material slice of the flow budget
    (measured 7.9 of 13.7 ms/pair at 4K for the round-2 form), so the
    default path assembles the mirror padding at LOW RES from flipped
    phase planes (_phase_stacks_lowres) instead of mirror-remapping the
    full-res plane (2.4x the source area at 4K) and space-to-depth
    transposing the result.  Bit-identical
    (tests/test_flow_stacks.py)."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    H, W = geom.height, geom.stride
    s = 1 << rs
    if lh << rs != H or lw << rs != W:
        return None
    Bl = _FLOW_BLOW
    if rs >= 1 and Bl <= lh and Bl <= lw:
        return _phase_stacks_lowres(geom, f1y, f1u, f1v)
    return _phase_stacks_remap(geom, f1y, f1u, f1v)


def _phase_stacks_remap(geom: FlowGeometry, f1y, f1u, f1v):
    """Round-2 construction: mirror-remap the full-res plane, then
    space-to-depth into phases.  Kept as the general-geometry fallback
    (rs == 0, or padding wider than the low-res field where a single
    reflection no longer covers mirror_inside's clip) and as the
    reference form for the equality test."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    H, W = geom.height, geom.stride
    s = 1 << rs
    Bl = _FLOW_BLOW
    B = Bl << rs

    def lift_pad_phase(plane, lift: bool):
        if lift:   # chroma -> full-res index domain (q -> plane[q >> 1])
            plane = jnp.repeat(jnp.repeat(plane, 2, axis=0), 2, axis=1)
        plane = plane[:H, :W]
        plane = _remap_axis(plane, _mirror_inside_map(B, H), 0)
        plane = _remap_axis(plane, _mirror_inside_map(B, W), 1)
        ph = plane.reshape(lh + 2 * Bl, s, lw + 2 * Bl, s)
        return ph.transpose(1, 3, 0, 2).reshape(s * s, lh + 2 * Bl,
                                                lw + 2 * Bl)

    return jnp.stack([lift_pad_phase(f1y, False),
                      lift_pad_phase(f1u, True),
                      lift_pad_phase(f1v, True)], axis=1)


def _pad_phases_mirror(ph, Bl: int):
    """(py, px, lh, lw) raw phase planes -> (py, px, lh+2Bl, lw+2Bl)
    carrying the FULL-RES mirror_inside padding, assembled at low res.

    Identity: for x = (c << rs) + p with c < 0 (and B <= H so a single
    reflection lands inside), mirror_inside(x) = -x - 1
    = ((-c - 1) << rs) + (s - 1 - p) -- i.e. the out-of-range rows of
    phase p are FLIPPED in-range rows of phase s-1-p; the x >= H side
    reflects to 2H-1-x with the same phase reversal.  So the padding is
    pure static slice/flip/concat on the phase-reversed planes -- no
    full-res intermediate, no gather."""
    rev_y = jnp.flip(ph, 0)
    top = jnp.flip(rev_y[:, :, :Bl, :], 2)
    bot = jnp.flip(rev_y[:, :, -Bl:, :], 2)
    rp = jnp.concatenate([top, ph, bot], axis=2)
    rev_x = jnp.flip(rp, 1)
    left = jnp.flip(rev_x[:, :, :, :Bl], 3)
    right = jnp.flip(rev_x[:, :, :, -Bl:], 3)
    return jnp.concatenate([left, rp, right], axis=3)


def _phase_stacks_lowres(geom: FlowGeometry, f1y, f1u, f1v):
    """Fast-path construction of the _phase_stacks layout (bit-identical
    to _phase_stacks_remap; see _phase_stacks):

      * split the raw plane into its (s, s) phase planes (ONE
        space-to-depth of the unpadded source -- the remap form
        transposed a 2.4x-padded plane);
      * assemble the mirror padding from flipped LOW-RES rows/columns of
        the phase-reversed planes (_pad_phases_mirror);
      * chroma: lift-then-split == split the raw chroma plane at stride
        s/2, where phases (py, px) and (py|1, px|1) coincide -- build
        and pad the (s/2, s/2) distinct planes and 2x2-repeat along the
        PHASE axes (a broadcast copy, vs repeating the full-res pixels
        and transposing 4x the data)."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    H, W = geom.height, geom.stride
    s = 1 << rs
    Bl = _FLOW_BLOW
    h = s // 2

    yph = f1y[:H, :W].reshape(lh, s, lw, s).transpose(1, 3, 0, 2)
    yp = _pad_phases_mirror(yph, Bl)

    def chroma(plane):
        cph = plane[:H // 2, :W // 2].reshape(lh, h, lw, h) \
            .transpose(1, 3, 0, 2)
        cp = _pad_phases_mirror(cph, Bl)
        return jnp.repeat(jnp.repeat(cp, 2, axis=0), 2, axis=1)

    PH, PW = lh + 2 * Bl, lw + 2 * Bl
    return jnp.stack([yp.reshape(s * s, PH, PW),
                      chroma(f1u).reshape(s * s, PH, PW),
                      chroma(f1v).reshape(s * s, PH, PW)], axis=1)


def _distinct_min_extract(key_flat, K: int):
    """The first K distinct values of a NON-NEGATIVE int32 key field, by
    K sequential masked min-reductions (vals[j] = smallest key greater
    than vals[j-1]).  K passes over the field beat a full bitonic sort
    wherever K << log^2(n) -- the distinct budget here is ~12-96 while
    jnp.sort of a 32k-130k field costs hundreds of compare-exchange
    passes (measured: the per-step sort was a material slice of the flow
    budget).  Returns (vals[K] ascending with 0x7FFFFFFF padding, D = how
    many are real, exceeded = whether distinct values beyond K exist)."""
    BIG = jnp.int32(0x7FFFFFFF)

    def body(last, _):
        nxt = jnp.min(jnp.where(key_flat > last, key_flat, BIG))
        return nxt, nxt

    _, vals = jax.lax.scan(body, jnp.int32(-1), None, length=K)
    D = jnp.sum((vals < BIG).astype(jnp.int32))
    # vals[K-1] == BIG when D < K, making this False by construction
    exceeded = jnp.any(key_flat > vals[K - 1])
    return vals, D, exceeded


def _distinct_base_offsets(off_y, off_x, K: int, stride: int = 2):
    """Padded table of the distinct (oy, ox) pairs of the committed
    field, computed from a STRIDE SUBSAMPLE: every commit repeats its
    adjustment at its window's granularity (adjustOffsetArrayKernel.cl
    operates per window block; oracle._window_sums_u32) and the initial
    field is zero, so the committed field entering a step is always
    block-constant at >= the CURRENT window size -- a stride-`window`
    subsample sees every distinct value at 1/window^2 the detection
    cost, and the select masks rebuild exactly by `stride`x repeat.
    stride=2 is the universally safe default (every window is >= 2).

    Values are clipped into the +-2**11 pack range; the caller's `ok`
    gate must reject fields whose magnitude reaches the clip (see
    _pyramid_step_traced) so clipping can never mis-key a selected
    shift.  Returns (key_b at the subsampled grid, vals[K], D,
    exceeded)."""
    R = 1 << 11
    oy = jnp.clip(_col_take(off_y[::stride], stride), -R, R - 1)
    ox = jnp.clip(_col_take(off_x[::stride], stride), -R, R - 1)
    key_b = ((oy + R) * (2 * R) + (ox + R)).astype(jnp.int32)
    vals, D, exceeded = _distinct_min_extract(key_b.ravel(), K)
    return key_b, vals, D, exceeded


def _delta_layers_shift(geom: FlowGeometry, stacks, key_b, vals, D,
                        adj_y, adj_x, layers: int, f2_probe,
                        luma_shift: int = 0, rep: int = 2):
    """(layers, lh, lw) int32 SAD deltas |y1-y2|+|u1-u2|+|v1-v2| of the
    candidate samples at per-layer probe offsets (adj_y[l], adj_x[l]),
    via phase slices + ONE masked select per distinct base offset
    (selecting the summed delta instead of the three sample stacks cuts
    the select traffic 3x vs round 2's sampler).  Serves both the
    pyramid step (one axis swept by the signed-square schedule) and the
    sub-pel refiner's 3x3 probe neighborhood."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    s = 1 << rs
    m = s - 1
    Bl = _FLOW_BLOW
    R = 1 << 11
    y2, u2, v2 = f2_probe
    # 8-bit sources: the per-candidate SAD fits int16 (<= 3*255), halving
    # the select/accumulate traffic of the j-loop; 10-bit needs int32
    acc_t = jnp.int32 if luma_shift else jnp.int16
    y2s, u2s, v2s = (p.astype(acc_t) for p in (y2, u2, v2))

    def cond(carry):
        return carry[1] < D

    def body(carry):
        delta, j = carry
        v = vals[j]
        vy = v // (2 * R) - R
        vx = v % (2 * R) - R
        # block-level mask -> per-pixel by repeat (exact: the committed
        # field is block-constant at >= rep, see _distinct_base_offsets)
        mask = jnp.repeat(jnp.repeat(key_b == v, rep, 0),
                          rep, 1)[:lh, :lw]
        sl = []
        for l in range(layers):
            oy = vy + adj_y[l]
            ox = vx + adj_x[l]
            p = (oy & m) * s + (ox & m)
            sy = Bl + (oy >> rs)
            sx = Bl + (ox >> rs)
            # one slice fetches y+u+v together (the chroma planes live
            # in the full-res index domain with the >>1 fold built into
            # the lifted stacks: the lifted plane IS plane[q>>1], so the
            # same (phase, shift) serves all 3)
            sl.append(jax.lax.dynamic_slice(
                stacks, (p, 0, sy, sx), (1, 3, lh, lw))[0])
        smp = jnp.stack(sl).astype(acc_t)       # (layers, 3, lh, lw)
        d = (jnp.abs(smp[:, 0] - y2s) + jnp.abs(smp[:, 1] - u2s)
             + jnp.abs(smp[:, 2] - v2s))
        return jnp.where(mask[None], d, delta), j + 1

    # while_loop, not a K-length scan: only the D REAL distinct offsets
    # run; padded budget entries cost nothing.  (MFI_FLOW_JLOOP=scan
    # keeps the round-2 fixed-length form for A/B measurement.)
    z = jnp.zeros((layers, lh, lw), acc_t)
    if _os.environ.get("MFI_FLOW_JLOOP", "while") == "scan":
        def sbody(delta, j):
            return jax.lax.cond(j < D, lambda d: body((d, j))[0],
                                lambda d: d, delta), None
        delta, _ = jax.lax.scan(sbody, z, jnp.arange(vals.shape[0]))
    else:
        delta, _ = jax.lax.while_loop(cond, body, (z, jnp.int32(0)))
    return delta.astype(jnp.int32)


def _subsampled_f2(geom: FlowGeometry, f2y, f2u, f2v):
    """Frame-2 probe samples at the scaled grid (strided slices, no gather).

    y2[cy,cx]   = f2y[cy<<rs, cx<<rs]
    u2/v2[cy,cx] = f2u/v[(cy<<rs)>>1, (cx<<rs)>>1]
    (calcDeltaSumsKernel.cl:96-98 with scaledC = c << resolutionScalar)."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    s = 1 << rs
    # column subsampling via _col_take, not [:, ::s] (ops/lanes.py)
    y2 = _col_take(f2y[::s], s)[:lh, :lw]
    if rs == 0:
        u2 = jnp.repeat(jnp.repeat(f2u, 2, 0), 2, 1)[:lh, :lw]
        v2 = jnp.repeat(jnp.repeat(f2v, 2, 0), 2, 1)[:lh, :lw]
    else:
        t = 1 << (rs - 1)
        u2 = _col_take(f2u[::t], t)[:lh, :lw]
        v2 = _col_take(f2v[::t], t)[:lh, :lw]
    return (y2.astype(jnp.int32), u2.astype(jnp.int32), v2.astype(jnp.int32))


def _delta_sums_one_step(
    geom: FlowGeometry,
    window: int,
    iteration: int,
    step: int,
    radius,                             # int (static) OR traced int32 scalar
    off_x, off_y,                       # (lh, lw) int32 current offsets
    f1y, f1u, f1v,                      # full-res planes (uint8/uint16)
    f2_probe,                           # precomputed (y2, u2, v2) int32
    delta_scalar, neighbor_bias_scalar,  # traced int32 scalars
    luma_shift: int,
    layers: int = None,
):
    """One (iteration, step): returns (layers, nwy, nwx) uint32 window sums.

    Dense equivalent of calcDeltaSumsKernel.cl:34-188 + host window sum.

    `layers` is the static layer count of the tensors; `radius` may be a
    traced scalar <= layers, in which case layers beyond it are masked to
    0xFFFFFFFF after the window reduction (they can never win the argmin:
    valid layers always come first, and jnp.argmin takes the first
    minimum, matching determineLowestLayerKernel.cl's ascending scan).
    One compiled program then serves every search radius the quality
    controller can pick."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    H, W = geom.height, geom.stride
    y2, u2, v2 = f2_probe
    if layers is None:
        layers = int(radius)

    cyg, cxg = jnp.mgrid[0:lh, 0:lw]
    scaled_cx = (cxg << rs).astype(jnp.int32)
    scaled_cy = (cyg << rs).astype(jnp.int32)

    z = jnp.arange(layers, dtype=jnp.int32)
    radius_t = jnp.asarray(radius, jnp.int32)
    rel = jnp.mod(z, radius_t) - radius_t // 2   # (cz % R) - R/2, cl:68
    adj = jnp.where(rel > 0, rel * rel, -(rel * rel)).astype(jnp.int32)
    adj = adj[:, None, None]                     # (layers,1,1)
    radius = layers  # tensor extent below

    if step == 0:
        cand_x = off_x[None] + adj               # (R, lh, lw)
        cand_y = jnp.broadcast_to(off_y[None], (radius, lh, lw))
        probe = cand_x
        prev_plane = off_x
    else:
        cand_x = jnp.broadcast_to(off_x[None], (radius, lh, lw))
        cand_y = off_y[None] + adj
        probe = cand_y
        prev_plane = off_y

    new_cx = mirror_inside(scaled_cx[None] + cand_x, W)
    new_cy = mirror_inside(scaled_cy[None] + cand_y, H)

    y1 = _gather(f1y, new_cy, new_cx).astype(jnp.int32)
    u1 = _gather(f1u, new_cy >> 1, new_cx >> 1).astype(jnp.int32)
    v1 = _gather(f1v, new_cy >> 1, new_cx >> 1).astype(jnp.int32)

    delta = (jnp.abs(y1 - y2[None]) + jnp.abs(u1 - u2[None])
             + jnp.abs(v1 - v2[None])).astype(jnp.uint32)
    if luma_shift:
        # P010 path: compare top 8 bits so bias weights keep their meaning.
        delta = delta >> np.uint32(luma_shift)
    delta = delta << delta_scalar.astype(jnp.uint32)

    offset_bias = jnp.abs(probe).astype(jnp.uint32)

    if iteration >= FIRST_NEIGHBOR_ITERATION:
        w2 = 2 * window
        nb = jnp.zeros((radius, lh, lw), jnp.uint32)
        for dx, dy in ((0, w2), (w2, 0), (-w2, 0), (0, -w2)):
            nx = np.clip(np.arange(lw) + dx, 0, lw - 1)
            ny = np.clip(np.arange(lh) + dy, 0, lh - 1)
            n_off = prev_plane[jnp.asarray(ny)[:, None], jnp.asarray(nx)[None, :]]
            nb = nb + jnp.abs(n_off[None] - probe).astype(jnp.uint32)
        neighbor_bias = nb << neighbor_bias_scalar.astype(jnp.uint32)
    else:
        neighbor_bias = jnp.zeros((), jnp.uint32)

    partial = delta + offset_bias + neighbor_bias   # uint32 wraparound

    nwy, nwx = -(-lh // window), -(-lw // window)
    if window > 1:
        padded = jnp.zeros((radius, nwy * window, nwx * window), jnp.uint32)
        padded = padded.at[:, :lh, :lw].set(partial)
        sums = padded.reshape(radius, nwy, window, nwx, window).sum(axis=(2, 4),
                                                                    dtype=jnp.uint32)
    else:
        sums = partial
    # layers beyond the active radius can never win (first-min + ordering)
    invalid = (z >= radius_t)[:, None, None]
    return jnp.where(invalid, jnp.uint32(0xFFFFFFFF), sums)


def _commit_winner(geom, window, step, radius, off_x, off_y, sums):
    """determineLowestLayerKernel.cl + adjustOffsetArrayKernel.cl.

    radius may be traced; (winner % R) - R/2 per adjustOffsetArrayKernel.cl:14."""
    lh, lw = geom.low_h, geom.low_w
    radius_t = jnp.asarray(radius, jnp.int32)
    lowest = jnp.argmin(sums, axis=0).astype(jnp.int32)   # first minimum
    rel = jnp.mod(lowest, radius_t) - radius_t // 2
    adj = jnp.where(rel > 0, rel * rel, -(rel * rel))
    if window > 1:
        adj = jnp.repeat(jnp.repeat(adj, window, 0), window, 1)
    adj = adj[:lh, :lw]
    if step == 0:
        return off_x + adj, off_y
    return off_x, off_y + adj


def blur_flow(offset, lh: int, lw: int):
    """blurFlowKernel.cl: separable 8x8 box sum over taps [-4,3], symmetric
    padding, truncating division by 64."""
    r = BLUR_RADIUS
    padded = jnp.pad(offset, ((0, 0), (r, r), (r, r)), mode="symmetric").astype(jnp.int32)
    rows = jnp.zeros((offset.shape[0], lh, lw + 2 * r), jnp.int32)
    for ky in range(-r, r):
        rows = rows + padded[:, r + ky:r + ky + lh, :]
    acc = jnp.zeros((offset.shape[0], lh, lw), jnp.int32)
    for kx in range(-r, r):
        acc = acc + rows[:, :, r + kx:r + kx + lw]
    ksz = (2 * r) * (2 * r)
    return jax.lax.div(acc, jnp.int32(ksz))   # trunc toward zero, like C


def _make_step_branch(geom: FlowGeometry, window: int, nb_enabled: bool,
                      layers: int, luma_shift: int,
                      f1y, f1u, f1v, f2_probe, stacks):
    """One WHOLE pyramid step as a lax.switch branch with the window
    size STATIC (branch index == iteration; there are only `iterations`
    distinct windows).  Static windows buy, vs round 2's traced-window
    body:

    * distinct-offset detection on a stride-`window` subsample -- the
      committed field entering a step is block-constant at >= the
      current window, so early steps detect over a handful of values
      instead of the full low-res field (the detection's sequential
      min-reductions were a fixed ~0.5 ms/step at stride 2);
    * plain zero-pad + reshape window block sums (exact mod 2**32 under
      any association, so the reference's atomic-add wraparound
      semantics survive, calcDeltaSumsKernel.cl:187) instead of an
      integral image read back through per-pixel gathers;
    * the neighbor fetch as a static clamped shift (slice+edge-repeat).

    Branch signature: (off_x, off_y, is_y, radius_t, ds, nbs) ->
    (off_x', off_y').  Bit-exact with the unrolled
    _delta_sums_one_step/_commit_winner pair."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    H, W = geom.height, geom.stride
    w2 = 2 * window
    y2, u2, v2 = f2_probe

    cyg, cxg = jnp.mgrid[0:lh, 0:lw]
    scaled_cx = (cxg << rs).astype(jnp.int32)
    scaled_cy = (cyg << rs).astype(jnp.int32)

    def branch(off_x, off_y, is_y, radius_t, delta_scalar,
               neighbor_bias_scalar):
        z = jnp.arange(layers, dtype=jnp.int32)
        rel = jnp.mod(z, radius_t) - radius_t // 2  # (cz % R) - R/2, cl:68
        adj = jnp.where(rel > 0, rel * rel, -(rel * rel)).astype(jnp.int32)
        adj = adj[:, None, None]

        cand_x = off_x[None] + adj * (1 - is_y)
        cand_y = off_y[None] + adj * is_y
        probe = jnp.where(is_y == 1, cand_y, cand_x)
        prev_plane = jnp.where(is_y == 1, off_y, off_x)

        def gather_delta(_):
            new_cx = mirror_inside(scaled_cx[None] + cand_x, W)
            new_cy = mirror_inside(scaled_cy[None] + cand_y, H)
            y1 = _gather(f1y, new_cy, new_cx).astype(jnp.int32)
            u1 = _gather(f1u, new_cy >> 1, new_cx >> 1).astype(jnp.int32)
            v1 = _gather(f1v, new_cy >> 1, new_cx >> 1).astype(jnp.int32)
            return (jnp.abs(y1 - y2[None]) + jnp.abs(u1 - u2[None])
                    + jnp.abs(v1 - v2[None]))

        def commit(delta):
            """Bias + window sums + argmin + signed-square commit (the
            tail shared by the XLA sampling paths)."""
            delta = delta.astype(jnp.uint32)
            if luma_shift:
                # P010: compare top 8 bits so bias weights keep meaning
                delta = delta >> np.uint32(luma_shift)
            delta = delta << delta_scalar.astype(jnp.uint32)

            partial = delta + jnp.abs(probe).astype(jnp.uint32)  # bias
            if nb_enabled:
                # neighbor bias at +-2*window, clamped (cl:137-151)
                nb = jnp.zeros((layers, lh, lw), jnp.uint32)
                for axis in (1, 0):
                    for sign in (1, -1):
                        n_off = _shift_clamped(prev_plane, sign * w2, axis)
                        nb = nb + jnp.abs(n_off[None] - probe).astype(
                            jnp.uint32)
                partial = partial + (nb << neighbor_bias_scalar.astype(
                    jnp.uint32))

            nwy, nwx = -(-lh // window), -(-lw // window)
            if window > 1:
                padded = jnp.zeros((layers, nwy * window, nwx * window),
                                   jnp.uint32)
                padded = padded.at[:, :lh, :lw].set(partial)
                sums = padded.reshape(layers, nwy, window, nwx,
                                      window).sum(axis=(2, 4),
                                                  dtype=jnp.uint32)
            else:
                sums = partial
            invalid = (z >= radius_t)[:, None, None]
            sums = jnp.where(invalid, jnp.uint32(0xFFFFFFFF), sums)
            lowest = jnp.argmin(sums, axis=0).astype(jnp.int32)  # 1st min
            rel2 = jnp.mod(lowest, radius_t) - radius_t // 2
            adj2 = jnp.where(rel2 > 0, rel2 * rel2, -(rel2 * rel2))
            if window > 1:
                adj2 = jnp.repeat(jnp.repeat(adj2, window, 0),
                                  window, 1)[:lh, :lw]
            return (off_x + adj2 * (1 - is_y), off_y + adj2 * is_y)

        if stacks is None:
            return commit(gather_delta(None))

        # phase-decomposed candidate sampling over the distinct
        # committed offsets; gather fallback at runtime for wild fields
        key_b, vals, D, exceeded = _distinct_base_offsets(
            off_y, off_x, _FLOW_K, stride=window)
        max_adj = (layers // 2) ** 2
        # subsampled max == field max by block constancy
        mag = jnp.maximum(
            jnp.max(jnp.abs(_col_take(off_x[::window], window))),
            jnp.max(jnp.abs(_col_take(off_y[::window], window))))
        # third conjunct: the pack keys clip at +-2**11; past that a
        # shift could be mis-keyed without tripping the padding bound
        # (possible at res_scalar >= 5, i.e. beyond-8K geometries)
        ok = (~exceeded) & (mag + max_adj <= (_FLOW_BLOW << rs) - 1) \
            & (mag < (1 << 11))
        adj_flat = adj[:, 0, 0]

        def shift_delta(_):
            return _delta_layers_shift(geom, stacks, key_b, vals, D,
                                       adj_flat * is_y,
                                       adj_flat * (1 - is_y), layers,
                                       (y2, u2, v2), luma_shift,
                                       rep=window)

        return commit(jax.lax.cond(ok, shift_delta, gather_delta, None))

    return branch


def _flow_impl_scan(geom: FlowGeometry, radius, luma_shift: int,
                    f1y, f1u, f1v, f2y, f2u, f2v,
                    delta_scalar, neighbor_bias_scalar, layers: int,
                    sampling: str = "shift"):
    """The pyramid as ONE lax.scan over (iteration, step) pairs: the HLO
    contains a single step body instead of 2*iterations unrolled copies,
    which cuts cold-start compile time (XLA's compile time grows
    faster than linearly with program size).  Output is
    bit-exact with the unrolled form (see _pyramid_step_traced).

    sampling="shift" replaces the candidate gathers with the
    phase-decomposed sampler (bit-exact, per-step runtime gather
    fallback); sampling="gather" keeps the per-pixel gathers."""
    lh, lw = geom.low_h, geom.low_w
    f2_probe = _subsampled_f2(geom, f2y, f2u, f2v)
    stacks = _phase_stacks(geom, f1y, f1u, f1v) \
        if sampling == "shift" else None

    branches = tuple(
        _make_step_branch(geom, w, it >= FIRST_NEIGHBOR_ITERATION, layers,
                          luma_shift, f1y, f1u, f1v, f2_probe, stacks)
        for it, w in enumerate(geom.window_schedule()))
    bidx, parities = [], []
    for it in range(len(branches)):
        for step in (0, 1):
            bidx.append(it)
            parities.append(step)
    xs = (jnp.asarray(bidx, jnp.int32), jnp.asarray(parities, jnp.int32))
    radius_t = jnp.asarray(radius, jnp.int32)
    ds_t = jnp.asarray(delta_scalar, jnp.int32)
    nbs_t = jnp.asarray(neighbor_bias_scalar, jnp.int32)

    def body(carry, x):
        b_t, isy_t = x
        carry = jax.lax.switch(b_t, branches, carry[0], carry[1],
                               jnp.asarray(isy_t, jnp.int32), radius_t,
                               ds_t, nbs_t)
        return carry, None

    init = (jnp.zeros((lh, lw), jnp.int32), jnp.zeros((lh, lw), jnp.int32))
    (off_x, off_y), _ = jax.lax.scan(body, init, xs)
    return off_x, off_y


# program form for the pyramid: "scan" (one traced step body, fast
# compile) or "unroll" (2*iterations inlined stages).  Both are bit-exact;
# scan is the default for its cold-start time (see ARCHITECTURE §3).
# Overridable for measurement via MFI_FLOW_PROGRAM.
import os as _os
FLOW_PROGRAM = _os.environ.get("MFI_FLOW_PROGRAM", "scan")
# candidate sampling: "shift" (phase-decomposed slices) or "gather"
# (per-pixel; the reference's design, still used by the unroll program
# and as the in-program runtime fallback)
FLOW_SAMPLING = _os.environ.get("MFI_FLOW_SAMPLING", "shift")


def _flow_impl(geom: FlowGeometry, radius, luma_shift: int,
               f1y, f1u, f1v, f2y, f2u, f2v,
               delta_scalar, neighbor_bias_scalar,
               layers: int = None, program: str = None,
               sampling: str = None):
    lh, lw = geom.low_h, geom.low_w
    program = program or FLOW_PROGRAM
    sampling = sampling or FLOW_SAMPLING

    if program == "scan" and layers is not None:
        off_x, off_y = _flow_impl_scan(
            geom, radius, luma_shift, f1y, f1u, f1v, f2y, f2u, f2v,
            delta_scalar, neighbor_bias_scalar, layers, sampling)
    else:
        off_x = jnp.zeros((lh, lw), jnp.int32)
        off_y = jnp.zeros((lh, lw), jnp.int32)
        f2_probe = _subsampled_f2(geom, f2y, f2u, f2v)
        for iteration, window in enumerate(geom.window_schedule()):
            for step in (0, 1):
                sums = _delta_sums_one_step(
                    geom, window, iteration, step, radius,
                    off_x, off_y, f1y, f1u, f1v, f2_probe,
                    delta_scalar, neighbor_bias_scalar, luma_shift,
                    layers=layers)
                off_x, off_y = _commit_winner(geom, window, step, radius,
                                              off_x, off_y, sums)

    offset = jnp.stack([off_x, off_y])
    return offset, blur_flow(offset, lh, lw)


def subpel_refine(geom: FlowGeometry, blurred, f1y, f1u, f1v, f2_probe,
                  luma_shift: int = 0):
    """Measured fractional-pel refinement of the (blurred) integer flow --
    the `subpel_flow` option of the hopperq/hopperxq families.

    The reference's flow is integer-pel by construction (the signed-square
    commit of adjustOffsetArrayKernel.cl:14 only ever adds whole pixels);
    hopperq's bilinear warp can consume finer motion, so this measures it:
    per low-res pixel the SAD cost (y+u+v, the same terms as
    calcDeltaSumsKernel.cl:96-98 without the bias terms) is evaluated on
    the 3x3 integer neighborhood of the committed offset and a 2-D
    quadratic is fit through it; the Newton step -H^-1 g is the sub-pel
    minimum.  A full 2-D fit (not two 1-D parabolas) because real SAD
    surfaces have diagonal valleys -- on textured content an x residual
    leaks into the per-axis y estimate, and the cross term H_xy is what
    cancels that.

    The per-probe costs are aggregated over the same 8x8 window as the
    flow blur before fitting: a single pixel's SAD is far too noisy a
    signal for a curvature estimate (measured: the windowed fit halves
    the refined field's spatial noise), and windowed cost surfaces are
    exactly what classic block-matching sub-pixel estimation fits.

    Gates, each zeroing the correction where the fit is meaningless:
      * d0 == 0 (exact match -- nothing to refine),
      * H not positive definite (no interior valley: H_xx/H_yy <= 0 or
        det <= 0).

    Integer math throughout (truncating division, clamped to +-0.5 pel),
    platform-stable like the rest of the flow.  The 9 cost probes ride
    the same phase-decomposed sampler as the pyramid (probe offsets
    (-1,0,1)^2 around each distinct committed value; per-pixel-gather
    fallback at runtime for wild fields; the gather form is 27
    gathers per low-res pixel).

    Returns (2, lh, lw) int32 in 1/64-pel units."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    H, W = geom.height, geom.stride
    y2, u2, v2 = f2_probe
    ox, oy = blurred[0], blurred[1]
    cyg, cxg = jnp.mgrid[0:lh, 0:lw]
    scaled_cx = (cxg << rs).astype(jnp.int32)
    scaled_cy = (cyg << rs).astype(jnp.int32)

    def window_avg(p):
        # 8x8 box average, blurFlowKernel-style taps/padding; >>6 keeps
        # the Hessian products below inside int32
        r = BLUR_RADIUS
        pad = jnp.pad(p[None], ((0, 0), (r, r), (r, r)), mode="symmetric")
        rows = sum(pad[:, r + ky:r + ky + lh, :] for ky in range(-r, r))
        acc = sum(rows[:, :, r + kx:r + kx + lw] for kx in range(-r, r))
        return acc[0] >> 6

    # probe order: index p -> (dx, dy) = PROBES[p]
    PROBES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
              (-1, -1), (1, 1), (-1, 1), (1, -1))

    def gather_probes(_):
        ds = []
        for dx, dy in PROBES:
            ncx = mirror_inside(scaled_cx + ox + dx, W)
            ncy = mirror_inside(scaled_cy + oy + dy, H)
            y1 = _gather(f1y, ncy, ncx).astype(jnp.int32)
            u1 = _gather(f1u, ncy >> 1, ncx >> 1).astype(jnp.int32)
            v1 = _gather(f1v, ncy >> 1, ncx >> 1).astype(jnp.int32)
            ds.append(jnp.abs(y1 - y2) + jnp.abs(u1 - u2)
                      + jnp.abs(v1 - v2))
        return jnp.stack(ds)

    stacks = _phase_stacks(geom, f1y, f1u, f1v)
    if stacks is None:
        deltas = gather_probes(None)
    else:
        key_b, vals, D, exceeded = _distinct_base_offsets(oy, ox, _FLOW_K)
        mag = jnp.maximum(jnp.max(jnp.abs(_col_take(ox[::2], 2))),
                          jnp.max(jnp.abs(_col_take(oy[::2], 2))))
        ok = (~exceeded) & (mag + 1 <= (_FLOW_BLOW << rs) - 1) \
            & (mag < (1 << 11))
        adj_y = jnp.asarray([dy for _, dy in PROBES], jnp.int32)
        adj_x = jnp.asarray([dx for dx, _ in PROBES], jnp.int32)

        def shift_probes(_):
            return _delta_layers_shift(geom, stacks, key_b, vals, D,
                                       adj_y, adj_x, len(PROBES),
                                       (y2, u2, v2), luma_shift)

        deltas = jax.lax.cond(ok, shift_probes, gather_probes, None)

    if luma_shift:
        # 10-bit inputs: drop to the 8-bit scale so the Hessian products
        # below stay well inside int32 (parabola vertex is scale-free)
        deltas = deltas >> luma_shift
    costs = [window_avg(deltas[p]) for p in range(len(PROBES))]
    d0, dxm, dxp, dym, dyp, dmm, dpp, dmp, dpm = costs  # (dx, dy) naming

    # finite-difference gradient and Hessian of the SAD surface, scaled to
    # stay integer: gx2 = 2*g_x, hxx = H_xx exactly, hxy4 = 4*H_xy
    gx2 = dxp - dxm
    gy2 = dyp - dym
    hxx = dxp + dxm - 2 * d0
    hyy = dyp + dym - 2 * d0
    hxy4 = dpp + dmm - dmp - dpm
    # Newton step -H^-1 g:
    #   dx = -(H_yy*g_x - H_xy*g_y) / det,  det = H_xx*H_yy - H_xy^2
    # With the scales above: numx = 8*(H_yy*g_x - H_xy*g_y), det16 =
    # 16*det, so dx = -2*numx/det16 and dx64 = -128*numx/det16.  Computed
    # at 1/32-pel then doubled to keep every product inside int32 for
    # 8-bit-scale costs (<= 765): |numx*64| < 1.6e9, |det16| < 1.5e8.
    det16 = 16 * hxx * hyy - hxy4 * hxy4
    numx = hyy * gx2 * 4 - hxy4 * gy2
    numy = hxx * gy2 * 4 - hxy4 * gx2
    fx = -2 * jax.lax.div(numx * 64, jnp.maximum(det16, 1))
    fy = -2 * jax.lax.div(numy * 64, jnp.maximum(det16, 1))
    valid = (d0 > 0) & (hxx > 0) & (hyy > 0) & (det16 > 0)
    fx = jnp.where(valid, jnp.clip(fx, -32, 32), 0)
    fy = jnp.where(valid, jnp.clip(fy, -32, 32), 0)
    return jnp.stack([fx, fy])


@functools.lru_cache(maxsize=64)
def _make_flow_traced(geom: FlowGeometry, luma_shift: int, layers: int):
    """One jitted flow program with the search radius as a traced scalar:
    every radius the quality controller picks shares this compilation
    (layers beyond the radius are masked out of the argmin)."""

    def fn(radius_t, f1y, f1u, f1v, f2y, f2u, f2v, ds, nbs):
        return _flow_impl(geom, radius_t, luma_shift,
                          f1y, f1u, f1v, f2y, f2u, f2v, ds, nbs,
                          layers=layers)

    return jax.jit(fn)


def make_flow_fn(geom: FlowGeometry, radius: int, luma_shift: int = 0):
    """Build the flow function for a given geometry + search radius.

    Returns fn(f1y, f1u, f1v, f2y, f2u, f2v, delta_scalar, nbs)
      -> (offset (2,lh,lw) int32, blurred (2,lh,lw) int32)

    f1 is the OLDER frame, f2 the NEWER (ping-pong semantics of
    opticalFlowCalc.c:96-106 / 163-164).  All radii share one compiled
    program (radius is traced; see _make_flow_traced)."""
    layers = max(oracle.MAX_SEARCH_RADIUS, radius)
    shared = _make_flow_traced(geom, luma_shift, layers)

    def call(f1y, f1u, f1v, f2y, f2u, f2v, ds, nbs):
        return shared(jnp.int32(radius), f1y, f1u, f1v, f2y, f2u, f2v,
                      ds, nbs)

    return call
