"""Bidirectional frame warp + blend + output modes in JAX/XLA.

Re-design of warpFrameKernel.cl (reference:
video/filter/HopperRender/Kernels/warpFrameKernel.cl:114-182, launched once
per plane from opticalFlowCalc.c:205-234).

Key design choices:
* The flow field is constant within each 2**rs x 2**rs full-res block
  (the kernel indexes flow at c >> resolutionScalar, cl:151-152), so flow
  "lookup" is a dense nearest-neighbor upsample (repeat + crop), not a
  gather.  The reverse-flow lookup (cl:155-156) happens once at low res.
* Only the final source-pixel fetches are gathers (2 per luma pixel for the
  blended mode), with indices produced by pure elementwise math.
* Chroma runs on planar u/v (NV12's interleave split at upload); the
  kernel's (newCx & ~1) + (cx & 1) NV12 addressing (cl:171-176) becomes
  even/odd column slices of the UV-pass coordinate grids.

Output modes (vf_HopperRender.c:21): 0 WarpedFrame12, 1 WarpedFrame21,
2 BlendedFrame, 3 HSVFlow, 4 GreyFlow, 5 SideBySide1, 6 SideBySide2.
Modes 5/6 take a generic per-pixel-gather path; they are debug views.

10-bit (P010-style, uint16 samples) is supported via scale_shift=8: level
mapping and HSV math run on the 8-bit scale with fractional precision
preserved, so the 8-bit semantics generalize continuously.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from mpv_frame_interpolator.ops.flow import FlowGeometry, _gather
from mpv_frame_interpolator.ops.lanes import col_take as _col_take

WARPED_FRAME_12 = 0
WARPED_FRAME_21 = 1
BLENDED_FRAME = 2
HSV_FLOW = 3
GREY_FLOW = 4
SIDE_BY_SIDE_1 = 5
SIDE_BY_SIDE_2 = 6


def mirror_edge2(pos, dim: int):
    """warpFrameKernel.cl:10-18: reflect, then clamp into [1, dim-2]."""
    res = jnp.where(pos >= dim - 1, pos - (pos - (dim - 2)) * 2, pos)
    res = jnp.where(pos < 1, -pos + 1, res)
    return jnp.clip(res, 1, dim - 2)


def _iround(x):
    """(int)round(f) with round-half-away-from-zero (OpenCL round())."""
    return (jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)).astype(jnp.int32)


def _reverse_flow(geom: FlowGeometry, blurred):
    """offsetX21/offsetY21 at low res (warpFrameKernel.cl:155-156)."""
    lh, lw, rs = geom.low_h, geom.low_w, geom.res_scalar
    ox12, oy12 = blurred[0], blurred[1]
    ly, lx = jnp.mgrid[0:lh, 0:lw]
    bscy = jnp.clip(ly - (oy12 >> rs), 0, lh - 1)
    bscx = jnp.clip(lx - (ox12 >> rs), 0, lw - 1)
    ox21 = _gather(ox12, bscy, bscx)
    oy21 = _gather(oy12, bscy, bscx)
    return ox21, oy21


def _upsample_y(geom: FlowGeometry, plane):
    """Nearest upsample of a (lh,lw) plane to the (H, actual_width) luma grid."""
    rep = 1 << geom.res_scalar
    if rep > 1:
        plane = jnp.repeat(jnp.repeat(plane, rep, 0), rep, 1)
    return plane[:geom.height, :geom.actual_width]


def _upsample_uv(geom: FlowGeometry, plane):
    """Flow sample grid for the UV pass: value at (cy,cx) is
    plane[(cy>>rs)<<1, (cx>>rs)&~1] (cl:151-152 with cz=1)."""
    rep_r = 1 << geom.res_scalar
    rep_c = 1 << (geom.res_scalar + 1)
    sub = _col_take(plane[::2], 2)
    sub = jnp.repeat(jnp.repeat(sub, rep_r, 0), rep_c, 1)
    return sub[:geom.height // 2, :geom.actual_width]


def _upsample_uv_half(geom: FlowGeometry, plane):
    """``_upsample_uv(geom, plane)[:, 0::2]`` built directly: u and v
    share their chroma coordinate (the column doubling), so the
    half-width field is just the 2x2-subsampled plane repeated
    ``2**res_scalar`` both ways -- bit-identical, and skips the
    full-width intermediate plus its lane-stride slice (ops/lanes.py)."""
    rep = 1 << geom.res_scalar
    sub = _col_take(plane[::2], 2)
    if rep > 1:
        sub = jnp.repeat(jnp.repeat(sub, rep, 0), rep, 1)
    return sub[:geom.height // 2, :geom.actual_width // 2]


def _occlusion_adjust(blended, s12, s21, fs12, scale_shift: int):
    """Occlusion-aware blend correction (the `hopperx` model family; an
    extension beyond the reference, which always cross-fades).

    Where the two warped samples disagree strongly the flow is wrong or
    the region is occluded in one frame; cross-fading there produces
    double-exposure ghosting.  The blend is shifted toward the temporally
    nearer source proportionally to the disagreement (8-bit scale ramp
    32..96, 1/256 steps -- exact integer arithmetic, deterministic across
    platforms like the rest of the warp).

    Note: this is a PERCEPTUAL option.  Plain cross-fading minimizes L2
    error (PSNR rewards averaging two wrong answers), so hopperx will
    typically measure slightly lower PSNR while looking cleaner at
    occlusion boundaries; that tradeoff is standard in motion-compensated
    interpolation and is why it is a separate model family, not the
    default."""
    s12i = s12.astype(jnp.int32)
    s21i = s21.astype(jnp.int32)
    near = jnp.where(fs12 < 0.5, s12i, s21i)
    d8 = jnp.abs(s12i - s21i) >> scale_shift
    a = jnp.clip((d8 - 32) * 4, 0, 256)
    return (blended * (256 - a) + near * a) >> 8


def _bilinear_sample(plane, py, px, dim_y: int, dim_x: int):
    """Sub-pixel sample with 1/64 fixed-point weights (the `hopperq`
    quality family; the reference rounds to the nearest integer position,
    warpFrameKernel.cl:165-168, which quantizes motion to whole pixels).

    py/px are fixed-point positions in 1/64 pixel units (int32).  Edges use
    the same reflect+clamp as the reference's mirrorCoordinate.  Returns
    the sample in 1/4096 units (int32) so the caller can round once."""
    y0 = py >> 6
    x0 = px >> 6
    fy = py & 63
    fx = px & 63
    y0m = mirror_edge2(y0, dim_y)
    y1m = mirror_edge2(y0 + 1, dim_y)
    x0m = mirror_edge2(x0, dim_x)
    x1m = mirror_edge2(x0 + 1, dim_x)
    s00 = _gather(plane, y0m, x0m).astype(jnp.int32)
    s01 = _gather(plane, y0m, x1m).astype(jnp.int32)
    s10 = _gather(plane, y1m, x0m).astype(jnp.int32)
    s11 = _gather(plane, y1m, x1m).astype(jnp.int32)
    top = s00 * (64 - fx) + s01 * fx          # 1/64 units
    bot = s10 * (64 - fx) + s11 * fx
    return top * (64 - fy) + bot * fy         # 1/4096 units


# ---------------------------------------------------------------------------
# Shift-decomposed sampling (the default warp path).
#
# The warp can be written without per-pixel gathers: dynamic slices and
# selects are plain streaming data movement.  Because the warp's
# integer displacement field is CONSTANT on 2^rs-pixel blocks (nearest
# upsample of the low-res flow, warpFrameKernel.cl:151-152) and takes few
# distinct values on real content (1 on uniform motion, ~10-100 typically),
# the exact warp decomposes into one dynamic-slice + masked select per
# DISTINCT displacement:
#
#     out(p) = src_padded[p + d_j]   where  d(p) == d_j
#
# with src_padded pre-remapped so that plain indexing reproduces the
# reference's mirrorCoordinate semantics (mirror_edge2) at every border.
# A compiled gather fallback handles fields with more than _ROLL_K distinct
# values or shifts beyond the _ROLL_B padding (e.g. pure noise -- where the
# flow is garbage anyway).  Outputs are BIT-IDENTICAL to the gather path;
# the golden suite runs against this path by default.
# ---------------------------------------------------------------------------

_ROLL_K = 96     # distinct-displacement budget of the shift path
_ROLL_B = 255    # |shift| bound covered by the mirror padding


def _mirror_map(n: int, dim: int):
    """numpy mirror_edge2 over positions [-n, dim-1+n]."""
    pos = np.arange(-n, dim + n)
    res = np.where(pos >= dim - 1, pos - (pos - (dim - 2)) * 2, pos)
    res = np.where(pos < 1, -pos + 1, res)
    return np.clip(res, 1, max(dim - 2, 0))


def _remap_axis(plane, mapping: np.ndarray, axis: int):
    """Apply a static index map along `axis` using slices/flips/repeats
    (NEVER a gather).  The map is piecewise linear with steps in
    {-1, 0, +1}, so it RLE-compresses to a handful of segments."""
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


def _mirror_padded(plane, B: int, dim_y: int, dim_x: int):
    """(dim_y+2B, dim_x+2B) plane where padded[B+q, B+r] ==
    plane[mirror_edge2(q), mirror_edge2(r)] for q,r in [-B, dim-1+B]."""
    p = plane[:dim_y, :dim_x]
    p = _remap_axis(p, _mirror_map(B, dim_y), 0)
    return _remap_axis(p, _mirror_map(B, dim_x), 1)


def _index_field(key_lo, vals, D):
    """uint8 table-INDEX field: idx[p] = j where key_lo[p] == vals[j]
    (255 where absent -- impossible under the `ok` gate, whose table
    covers every field value).  The per-distinct selects then compare
    one byte per output pixel instead of a packed int32 -- the compare
    read is the sampler's largest stream at 4K -- and the lookup runs at
    LOW res before the nearest upsample."""
    def cond(c):
        return c[1] < D

    def body(c):
        idx, j = c
        return jnp.where(key_lo == vals[j], j.astype(jnp.uint8), idx), j + 1

    idx0 = jnp.full(key_lo.shape, 255, jnp.uint8)
    idx, _ = jax.lax.while_loop(cond, body, (idx0, jnp.int32(0)))
    return idx


def _shift_sample(padded, idx_full, vals, D, out_h: int, out_w: int,
                  dtype):
    """sum_j [idx_full == j] * padded[B+dy_j : ..., B+dx_j : ...].

    One dynamic slice + select per DISTINCT displacement, at memory
    speed.  A while_loop, not a budget-length scan: only the D real
    entries execute, the padded tail costs nothing."""
    B = _ROLL_B
    SPAN = 2 * B + 2

    def cond(c):
        return c[1] < D

    def body(c):
        acc, j = c
        v = vals[j]
        dy = v // SPAN - B
        dx = v % SPAN - B
        plane = jax.lax.dynamic_slice(padded, (B + dy, B + dx),
                                      (out_h, out_w))
        return jnp.where(idx_full == j.astype(jnp.uint8), plane, acc), j + 1

    acc0 = jnp.zeros((out_h, out_w), dtype)
    acc, _ = jax.lax.while_loop(cond, body, (acc0, jnp.int32(0)))
    return acc


def _shift_sample_uv(padded2, idx_c, vals, D, hc: int, wc: int, dtype):
    """u and v planes of one direction in ONE loop: u/v share their
    displacement field (warpFrameKernel.cl:171-176 computes a single
    chroma coordinate; _upsample_uv doubles columns so one parity slice
    keys both), so each distinct value needs one (2, hc, 2*wc) slice of
    the stacked padded chroma; u takes the even output columns, v the
    odd (the kernel's (newCx & ~1) + (cx & 1) NV12 addressing)."""
    B = _ROLL_B
    SPAN = 2 * B + 2

    def cond(c):
        return c[2] < D

    def body(c):
        au, av, j = c
        v = vals[j]
        dy = v // SPAN - B
        dx = v % SPAN - B
        sl = jax.lax.dynamic_slice(padded2, (0, B + dy, B + dx),
                                   (2, hc, 2 * wc))
        mask = idx_c == j.astype(jnp.uint8)
        au = jnp.where(mask, _col_take(sl[0], 2, 0), au)
        av = jnp.where(mask, _col_take(sl[1], 2, 1), av)
        return au, av, j + 1

    z = jnp.zeros((hc, wc), dtype)
    au, av, _ = jax.lax.while_loop(cond, body, (z, z, jnp.int32(0)))
    return au, av


_FLOW_PACK = 2048      # flow-value pack radius for the per-pair tables


def _sampler_prep(geom, fields, f1y, f1u, f1v, f2y, f2u, f2v,
                  bilinear: bool = False):
    """The t-INDEPENDENT half of the shift-decomposed sampler, computed
    once per source pair: mirror-padded sources and the distinct LOW-RES
    FLOW value tables.  Every blend position then derives its
    displacement tables from the flow tables by scalar math on (K,)
    vectors, since d(p) = iround(flow(p) * s) makes the displacement
    value set the image of the flow value set under a scalar map."""
    from mpv_frame_interpolator.ops.flow import _distinct_min_extract
    H, Wa = geom.height, geom.actual_width
    hc, wc = H >> 1, Wa >> 1
    K, B = _ROLL_K, _ROLL_B
    R = _FLOW_PACK

    ox12l, oy12l = fields["OX12l"], fields["OY12l"]
    ox21l, oy21l = fields["OX21l"], fields["OY21l"]

    def pack_flow(oy, ox):
        return ((jnp.clip(oy, -R, R - 1) + R) * (2 * R)
                + (jnp.clip(ox, -R, R - 1) + R)).astype(jnp.int32)

    v12, D12, x12 = _distinct_min_extract(pack_flow(oy12l, ox12l).ravel(),
                                          K)
    v21, D21, x21 = _distinct_min_extract(pack_flow(oy21l, ox21l).ravel(),
                                          K)
    mag = jnp.maximum(
        jnp.maximum(jnp.max(jnp.abs(ox12l)), jnp.max(jnp.abs(oy12l))),
        jnp.maximum(jnp.max(jnp.abs(ox21l)), jnp.max(jnp.abs(oy21l))))
    # |iround(v*s)| <= |v| for |s| <= 1 (round-half-away is odd and
    # monotone), so one magnitude gate covers every blend position; the
    # R-clip gate keeps the flow pack exact wherever the shift branch
    # can be selected
    ok = (~(x12 | x21)) & (mag <= B - 2) & (mag < R)

    def unpack(v, D):
        j = jnp.arange(v.shape[0])
        vy = v // (2 * R) - R
        vx = v % (2 * R) - R
        good = j < D
        return (jnp.where(good, vy, 0).astype(jnp.float32),
                jnp.where(good, vx, 0).astype(jnp.float32), good)

    p1 = _mirror_padded(f1y, B, H, Wa)
    p2 = _mirror_padded(f2y, B, H, Wa)

    def cpad2(u, v):
        # full-width chroma domain (each sample doubled) so the kernel's
        # mirror-then->>1 addressing becomes plain indexing; u and v
        # stack so one slice serves both (_shift_sample_uv)
        return jnp.stack([
            _mirror_padded(jnp.repeat(u[:, :wc], 2, axis=1), B, hc, Wa),
            _mirror_padded(jnp.repeat(v[:, :wc], 2, axis=1), B, hc, Wa)])

    def cpad2_half(u, v):
        # bilinear chroma samples in the HALF-width chroma domain
        # (warpFrameKernel's planar-u/v addressing; u and v share their
        # sub-pel coordinate, _upsample_uv doubles columns)
        return jnp.stack([_mirror_padded(u[:, :wc], B, hc, wc),
                          _mirror_padded(v[:, :wc], B, hc, wc)])

    cp = cpad2_half if bilinear else cpad2

    # t-INDEPENDENT index fields: the per-pixel table index is the index
    # of the pixel's distinct FLOW value, and d(p) = iround(flow(p) * s)
    # maps table entry j to its displacement pixel-independently -- so
    # ONE index field (per direction, luma + chroma grids) serves every
    # blend position, with only the (K,) value tables re-derived per t.
    if12_lo = _index_field(pack_flow(oy12l, ox12l), v12, D12)
    if21_lo = _index_field(pack_flow(oy21l, ox21l), v21, D21)
    c1, c2 = cp(f1u, f1v), cp(f2u, f2v)
    return {"p1": p1, "p2": p2, "c1": c1, "c2": c2,
            "t12": unpack(v12, D12), "t21": unpack(v21, D21),
            "D12": D12, "D21": D21,
            "IF12": _upsample_y(geom, if12_lo),
            "IF21": _upsample_y(geom, if21_lo),
            "IF12c": _upsample_uv_half(geom, if12_lo),
            "IF21c": _upsample_uv_half(geom, if21_lo),
            "ok": ok}


# plain numpy scalar: a module-level jnp constant would initialize the
# default jax backend at import time (and take the card's memory)
_BIG32 = np.int32(0x7FFFFFFF)
_C64 = 1 << 14     # 1/64-pel displacement pack center (|d64| <= 64*_ROLL_B)



def _bilinear_shift_sample(padded, idx64, vals64, D, out_h: int,
                           out_w: int):
    """Shift-decomposed 1/64-pel bilinear sampling (the hopperq
    families' quality warp): the fractional phase (fy, fx) = d64 & 63 is
    CONSTANT per distinct displacement, so each distinct value costs 4
    integer-offset slices + one fixed-weight blend + one select -- vs 4
    per-pixel gathers.  `padded` may be
    (h+2B, w+2B) luma or (2, h+2B, w+2B) stacked chroma (u/v share their
    coordinate, see _upsample_uv's column doubling).  Returns int32 in
    1/4096 units, bit-identical to _bilinear_sample."""
    B = _ROLL_B
    chroma = padded.ndim == 3

    def cond(c):
        return c[1] < D

    def body(c):
        acc, j = c
        v = vals64[j]
        dy64 = (v >> 15) - _C64
        dx64 = (v & 32767) - _C64
        dyI = dy64 >> 6
        fy = dy64 & 63
        dxI = dx64 >> 6
        fx = dx64 & 63

        def tap(oy, ox):
            if chroma:
                sl = jax.lax.dynamic_slice(
                    padded, (0, B + dyI + oy, B + dxI + ox),
                    (2, out_h, out_w))
            else:
                sl = jax.lax.dynamic_slice(
                    padded, (B + dyI + oy, B + dxI + ox), (out_h, out_w))
            return sl.astype(jnp.int32)

        top = tap(0, 0) * (64 - fx) + tap(0, 1) * fx
        bot = tap(1, 0) * (64 - fx) + tap(1, 1) * fx
        val = top * (64 - fy) + bot * fy          # 1/4096 units
        mask = idx64 == j.astype(jnp.uint8)
        if chroma:
            mask = mask[None]
        return jnp.where(mask, val, acc), j + 1

    shape = (2, out_h, out_w) if chroma else (out_h, out_w)
    acc0 = jnp.zeros(shape, jnp.int32)
    acc, _ = jax.lax.while_loop(cond, body, (acc0, jnp.int32(0)))
    return acc



def _bilinear_all_planes(geom, fields, f1y, f1u, f1v, f2y, f2u, f2v,
                         fs12, fs21):
    """The four bilinear-sampled quantities of the hopperq families --
    (s12q, s21q, cu12, cu21), luma (H, Wa) and stacked u/v (2, hc, wc),
    all int32 in 1/4096 units -- via the shift-decomposed 1/64-pel
    sampler with a per-pixel-gather fallback selected at RUNTIME.
    Bit-identical to the _bilinear_sample path in both branches."""
    H, Wa = geom.height, geom.actual_width
    hc, wc = H >> 1, Wa >> 1
    prep = fields.get("SPREP")
    if prep is None:
        prep = _sampler_prep(geom, fields, f1y, f1u, f1v, f2y, f2u, f2v,
                             bilinear=True)

    # per-t 1/64-pel displacement VALUE tables over the per-pair flow
    # tables; the t-independent flow-INDEX fields come from prep (same
    # hoist as _sample_all_planes -- entry j's displacement is scalar
    # math on the flow value, so no per-t index rebuild/upsample/dedup)
    def disp_table64(table, y_scale, x_scale):
        vy, vx, good = table
        dy = jnp.clip(_iround(vy * y_scale), -_C64 + 1, _C64 - 2)
        dx = jnp.clip(_iround(vx * x_scale), -_C64 + 1, _C64 - 2)
        return jnp.where(good, ((dy + _C64) << 15) | (dx + _C64), _BIG32)

    v12 = disp_table64(prep["t12"], fs12 * 64, fs12 * 64)
    v21 = disp_table64(prep["t21"], -fs21 * 64, -fs21 * 64)
    v12c = disp_table64(prep["t12"], fs12 * 32, fs12 * 32)
    v21c = disp_table64(prep["t21"], -fs21 * 32, -fs21 * 32)
    D12, D21 = prep["D12"], prep["D21"]
    i12, i21 = prep["IF12"], prep["IF21"]
    # u and v share their chroma coordinate (_upsample_uv doubles
    # columns), so one parity slice keys both
    i12c, i21c = prep["IF12c"], prep["IF21c"]

    def shift_branch(_):
        s12q = _bilinear_shift_sample(prep["p1"], i12, v12, D12, H, Wa)
        s21q = _bilinear_shift_sample(prep["p2"], i21, v21, D21, H, Wa)
        cu12 = _bilinear_shift_sample(prep["c1"], i12c, v12c, D12,
                                      hc, wc)
        cu21 = _bilinear_shift_sample(prep["c2"], i21c, v21c, D21,
                                      hc, wc)
        return s12q, s21q, cu12, cu21

    def gather_branch(_):
        flds = _ensure_full_fields(geom, fields)
        cyg, cxg = jnp.mgrid[0:H, 0:Wa]
        OX12, OY12 = flds["OX12"], flds["OY12"]
        OX21, OY21 = flds["OX21"], flds["OY21"]
        p12x = (cxg << 6) + _iround(OX12.astype(jnp.float32) * (fs12 * 64))
        p12y = (cyg << 6) + _iround(OY12.astype(jnp.float32) * (fs12 * 64))
        p21x = (cxg << 6) - _iround(OX21.astype(jnp.float32) * (fs21 * 64))
        p21y = (cyg << 6) - _iround(OY21.astype(jnp.float32) * (fs21 * 64))
        s12q = _bilinear_sample(f1y, p12y, p12x, H, Wa)
        s21q = _bilinear_sample(f2y, p21y, p21x, H, Wa)
        cyg, cxg = jnp.mgrid[0:hc, 0:Wa]
        OX12c, OY12c = flds["OX12c"], flds["OY12c"]
        OX21c, OY21c = flds["OX21c"], flds["OY21c"]
        pxg = (cxg >> 1) << 6
        pyg = cyg << 6
        p12x = pxg + _iround(OX12c.astype(jnp.float32) * (fs12 * 32))
        p12y = pyg + _iround(OY12c.astype(jnp.float32) * (fs12 * 32))
        p21x = pxg - _iround(OX21c.astype(jnp.float32) * (fs21 * 32))
        p21y = pyg - _iround(OY21c.astype(jnp.float32) * (fs21 * 32))

        def bs(plane, py, px, par):
            return _bilinear_sample(plane, py[:, par::2], px[:, par::2],
                                    hc, wc)

        cu12 = jnp.stack([bs(f1u, p12y, p12x, 0), bs(f1v, p12y, p12x, 1)])
        cu21 = jnp.stack([bs(f2u, p21y, p21x, 0), bs(f2v, p21y, p21x, 1)])
        return s12q, s21q, cu12, cu21

    return jax.lax.cond(prep["ok"], shift_branch, gather_branch, None)


def _sample_all_planes(geom, fields, f1y, f1u, f1v, f2y, f2u, f2v,
                       fs12, fs21):
    """The six nearest-sampled planes (s12, s21, su12, su21, sv12, sv21)
    via the shift-decomposed path, with a compiled per-pixel-gather
    fallback selected at RUNTIME when the flow field is too wild for the
    static budgets (distinct count > _ROLL_K or |flow| near _ROLL_B).
    Bit-identical to the gather path in both branches."""
    H, Wa = geom.height, geom.actual_width
    hc, wc = H >> 1, Wa >> 1
    B = _ROLL_B
    SPAN = 2 * B + 2
    prep = fields.get("SPREP")
    if prep is None:
        prep = _sampler_prep(geom, fields, f1y, f1u, f1v, f2y, f2u, f2v)

    # per-position displacement VALUE tables from the per-pair flow
    # tables: iround(v * s) with s = +-fs (the 21-direction negation
    # folds into the scale; round-half-away is odd, so iround(v*-s) ==
    # -iround(v*s)).  The INDEX fields are t-independent (prep["IF*"]):
    # pixel p carries the index of its distinct FLOW value, and entry j
    # maps to its per-t displacement by scalar math -- no dedup (two
    # entries may share a displacement; both select the same samples),
    # no per-t index rebuild, no per-t upsample.
    def disp_table(table, y_scale, x_scale):
        vy, vx, good = table
        dy = jnp.clip(_iround(vy * y_scale), -B, B)
        dx = jnp.clip(_iround(vx * x_scale), -B, B)
        return jnp.where(good, (dy + B) * SPAN + (dx + B), _BIG32)

    v12 = disp_table(prep["t12"], fs12, fs12)
    v21 = disp_table(prep["t21"], -fs21, -fs21)
    v12c = disp_table(prep["t12"], fs12 * 0.5, fs12)
    v21c = disp_table(prep["t21"], -fs21 * 0.5, -fs21)
    D12, D21 = prep["D12"], prep["D21"]
    i12f, i21f = prep["IF12"], prep["IF21"]
    i12cf, i21cf = prep["IF12c"], prep["IF21c"]

    ok = prep["ok"]

    def shift_branch(_):
        s12 = _shift_sample(prep["p1"], i12f, v12, D12, H, Wa, f1y.dtype)
        s21 = _shift_sample(prep["p2"], i21f, v21, D21, H, Wa, f2y.dtype)
        su12, sv12 = _shift_sample_uv(prep["c1"], i12cf, v12c, D12,
                                      hc, wc, f1u.dtype)
        su21, sv21 = _shift_sample_uv(prep["c2"], i21cf, v21c, D21,
                                      hc, wc, f2u.dtype)
        return s12, s21, su12, su21, sv12, sv21

    def gather_branch(_):
        # coordinate AND full-res flow fields built INSIDE the branch:
        # the shift path never pays for the fallback's per-pixel
        # round/mirror math or the 8 full-res upsamples
        flds = _ensure_full_fields(geom, fields)
        cyg, cxg = jnp.mgrid[0:H, 0:Wa]
        OX12, OY12 = flds["OX12"], flds["OY12"]
        OX21, OY21 = flds["OX21"], flds["OY21"]
        ncx12 = mirror_edge2(
            cxg + _iround(OX12.astype(jnp.float32) * fs12), Wa)
        ncy12 = mirror_edge2(
            cyg + _iround(OY12.astype(jnp.float32) * fs12), H)
        ncx21 = mirror_edge2(
            cxg - _iround(OX21.astype(jnp.float32) * fs21), Wa)
        ncy21 = mirror_edge2(
            cyg - _iround(OY21.astype(jnp.float32) * fs21), H)
        s12 = _gather(f1y, ncy12, ncx12)
        s21 = _gather(f2y, ncy21, ncx21)
        OX12c, OY12c = flds["OX12c"], flds["OY12c"]
        OX21c, OY21c = flds["OX21c"], flds["OY21c"]
        cyg, cxg = jnp.mgrid[0:hc, 0:Wa]
        cx12 = mirror_edge2(cxg + _iround(OX12c.astype(jnp.float32) * fs12),
                            Wa)
        cy12 = mirror_edge2(cyg + _iround(OY12c.astype(jnp.float32)
                                          * fs12 * 0.5), hc)
        cx21 = mirror_edge2(cxg - _iround(OX21c.astype(jnp.float32) * fs21),
                            Wa)
        cy21 = mirror_edge2(cyg - _iround(OY21c.astype(jnp.float32)
                                          * fs21 * 0.5), hc)

        def samp(plane, ncy, ncx, par):
            return _gather(plane, ncy[:, par::2], ncx[:, par::2] >> 1)

        return (s12, s21,
                samp(f1u, cy12, cx12, 0), samp(f2u, cy21, cx21, 0),
                samp(f1v, cy12, cx12, 1), samp(f2v, cy21, cx21, 1))

    return jax.lax.cond(ok, shift_branch, gather_branch, None)


def _blend_fix(s12, s21, t, scale_shift: int):
    """Fixed-point bidirectional blend (see ops/oracle.blend_weights for the
    semantics rationale: the reference's f32 mul-add truncation is
    FMA/GPU-dependent; this is exact and platform-stable).

    frac bits: 24 for 8-bit samples, 16 for 16-bit so the weighted sum fits
    uint32.  t is the traced blendingScalar (frameScalar12)."""
    frac = 24 - (8 if scale_shift else 0)
    T = jnp.clip(jnp.round(t * (1 << frac)), 0, 1 << frac).astype(jnp.uint32)
    w1 = jnp.uint32(1 << frac) - T
    acc = s12.astype(jnp.uint32) * w1 + s21.astype(jnp.uint32) * T
    return (acc >> frac).astype(jnp.int32)


def _levels_y(b_int, black, white, scale_shift: int):
    """Exact-integer luma level mapping; see ops/oracle._apply_levels_y for
    the semantics rationale (stable vs an approximate f32 division).

    b_int is the blended sample in device scale (8-bit: 0..255, P010-style:
    0..65535); black/white are traced floats on the 8-bit scale."""
    k = jnp.round(black).astype(jnp.int32)
    w = jnp.round(white).astype(jnp.int32)
    d = jnp.maximum(w - k, 1)
    n = jnp.maximum((b_int - (k << scale_shift)) * 255, 0)
    return jnp.minimum(jax.lax.div(n, d), 255 << scale_shift)


def _levels_uv(b_int, white, scale_shift: int):
    """Exact-integer chroma level mapping (oracle._apply_levels_uv)."""
    w = jnp.maximum(jnp.round(white).astype(jnp.int32), 1)
    m = 128 << scale_shift
    n = jnp.maximum((b_int - m) * 255 + m * w, 0)
    return jnp.minimum(jax.lax.div(n, w), 255 << scale_shift)


def _levels_y_rt(b_int, black, white, scale_shift: int):
    """_levels_y with a runtime shortcut for the DEFAULT levels: at
    black=0/white=255 the mapping reduces exactly to clip(b, 0, cap)
    (n = 255*b, floor(n/255) = b), so the hot path skips the full-res
    integer divisions.  Levels stay traced knobs -- no
    recompile when the user moves them; the cond just takes the other
    branch."""
    k = jnp.round(black).astype(jnp.int32)
    w = jnp.round(white).astype(jnp.int32)
    cap = jnp.int32(255 << scale_shift)
    return jax.lax.cond(
        (k == 0) & (w == 255),
        lambda x: jnp.clip(x, 0, cap),
        lambda x: _levels_y(x, black, white, scale_shift), b_int)


def _levels_uv_rt(b_int, white, scale_shift: int):
    """_levels_uv with the default-levels clip shortcut (see
    _levels_y_rt; the chroma map at white=255 is clip(b, 0, cap))."""
    w = jnp.round(white).astype(jnp.int32)
    cap = jnp.int32(255 << scale_shift)
    return jax.lax.cond(
        w == 255,
        lambda x: jnp.clip(x, 0, cap),
        lambda x: _levels_uv(x, white, scale_shift), b_int)


def _visualize_flow(off_x, off_y, curr_8, channel: int, res_impact: int):
    """visualizeFlow (warpFrameKernel.cl:21-111) for one plane.

    off_x/off_y int32 (already negated by caller), curr_8 int32 in 8-bit
    scale, channel: 0=Y, 1=U, 2=V (constant per plane in planar layout).
    Returns int32 in [0, 255]."""
    zero_flow = (jnp.abs(off_x) < 1) & (jnp.abs(off_y) < 1)
    fx = off_x.astype(jnp.float32)
    fy = off_y.astype(jnp.float32)

    angle = jnp.arctan2(fy, fx) * np.float32(180.0 / math.pi)
    angle = jnp.where(angle < 0, angle + 360.0, angle)
    angle = jnp.where(angle >= 360.0, angle - 360.0, angle)
    hue = angle / np.float32(360.0)

    h_i = (hue * 6.0).astype(jnp.int32)
    f = hue * 6.0 - h_i.astype(jnp.float32)
    q = 1.0 - f
    f255 = jnp.trunc(f * 255.0)
    q255 = jnp.trunc(q * 255.0)

    sector = jnp.mod(h_i, 6)
    zeros = jnp.zeros_like(f255)
    full = jnp.full_like(f255, 255.0)
    r = jnp.select([sector == 0, sector == 1, sector == 2, sector == 3,
                    sector == 4, sector == 5],
                   [full, q255, zeros, zeros, f255, full], zeros)
    g = jnp.select([sector == 0, sector == 1, sector == 2, sector == 3,
                    sector == 4, sector == 5],
                   [f255, full, full, q255, zeros, zeros], zeros)
    b = jnp.select([sector == 0, sector == 1, sector == 2, sector == 3,
                    sector == 4, sector == 5],
                   [zeros, zeros, f255, full, full, q255], zeros)

    mag = (jnp.abs(fx) + jnp.abs(fy)) * np.float32(res_impact)
    r = jnp.trunc(jnp.clip(r / 255.0 * mag, 0.0, 255.0))
    g = jnp.trunc(jnp.clip(g / 255.0 * jnp.abs(fy) * 2.0 * np.float32(res_impact), 0.0, 255.0))
    b = jnp.trunc(jnp.clip(b / 255.0 * mag, 0.0, 255.0))

    r = jnp.where(zero_flow, 0.0, r)
    g = jnp.where(zero_flow, 0.0, g)
    b = jnp.where(zero_flow, 0.0, b)

    if channel == 0:
        lum = jnp.trunc(jnp.clip(r * 0.299 + g * 0.587 + b * 0.114, 0.0, 255.0))
        return (lum.astype(jnp.int32) >> 1) + (curr_8 >> 1)
    if channel == 1:
        return jnp.trunc(jnp.clip(r * -0.168736 + g * -0.331264 + b * 0.5 + 128.0,
                                  0.0, 255.0)).astype(jnp.int32)
    return jnp.trunc(jnp.clip(r * 0.5 + g * -0.418688 + b * -0.081312 + 128.0,
                              0.0, 255.0)).astype(jnp.int32)


def _ensure_full_fields(geom: FlowGeometry, fields):
    """Full-res upsampled flow fields, built lazily from the low-res
    set when _warp_fields was called with full_res=False.  Idempotent;
    returns a new dict (never mutates the shared per-pair fields)."""
    if "OX12" in fields:
        return fields
    out = dict(fields)
    out.update({
        "OX12": _upsample_y(geom, fields["OX12l"]),
        "OY12": _upsample_y(geom, fields["OY12l"]),
        "OX21": _upsample_y(geom, fields["OX21l"]),
        "OY21": _upsample_y(geom, fields["OY21l"]),
        "OX12c": _upsample_uv(geom, fields["OX12l"]),
        "OY12c": _upsample_uv(geom, fields["OY12l"]),
        "OX21c": _upsample_uv(geom, fields["OX21l"]),
        "OY21c": _upsample_uv(geom, fields["OY21l"]),
    })
    return out


def _warp_fields(geom: FlowGeometry, blurred, frac=None,
                 full_res: bool = True):
    """The t-independent part of the warp: forward + reverse flow sampled
    onto the luma and chroma output grids.  Shared across all blend
    positions of one source pair (one flow calc serves numIntFrames warps,
    vf_HopperRender.c:481-500).

    `frac` is the optional (2, lh, lw) 1/64-pel refinement field
    (ops/flow.subpel_refine); its reverse lookup rides the SAME low-res
    positions as the integer reverse flow, and it is upsampled onto the
    same output grids (FX12/FY12/... keys).

    full_res=False skips the eight FULL-RES upsampled fields: the
    shift-decomposed samplers never read them on their hot path (they
    ride the low-res tables + index fields), so building them
    unconditionally was pure prep cost (~8 frame-sized writes per pair).
    Consumers that do need them -- the gather fallbacks, GREY/HSV modes
    -- rebuild them lazily via _ensure_full_fields (inside their
    runtime-cond branch, so the cost is only paid when that branch
    executes)."""
    lh, lw, rs = geom.low_h, geom.low_w, geom.res_scalar
    ox12, oy12 = blurred[0], blurred[1]
    ly, lx = jnp.mgrid[0:lh, 0:lw]
    bscy = jnp.clip(ly - (oy12 >> rs), 0, lh - 1)
    bscx = jnp.clip(lx - (ox12 >> rs), 0, lw - 1)
    ox21_lo = _gather(ox12, bscy, bscx)
    oy21_lo = _gather(oy12, bscy, bscx)
    fields = {
        # low-res fields for the shift-decomposed sampler (few distinct
        # values live here; see _shift_sample)
        "OX12l": ox12, "OY12l": oy12, "OX21l": ox21_lo, "OY21l": oy21_lo,
    }
    if full_res:
        fields = _ensure_full_fields(geom, fields)
    if frac is not None:
        fx12, fy12 = frac[0], frac[1]
        fx21_lo = _gather(fx12, bscy, bscx)
        fy21_lo = _gather(fy12, bscy, bscx)
        fields.update({
            "FX12": _upsample_y(geom, fx12),
            "FY12": _upsample_y(geom, fy12),
            "FX21": _upsample_y(geom, fx21_lo),
            "FY21": _upsample_y(geom, fy21_lo),
            "FX12c": _upsample_uv(geom, fx12),
            "FY12c": _upsample_uv(geom, fy12),
            "FX21c": _upsample_uv(geom, fx21_lo),
            "FY21c": _upsample_uv(geom, fy21_lo),
        })
    return fields


def _warp_impl(geom: FlowGeometry, mode: int, scale_shift: int, dtype,
               f1y, f1u, f1v, f2y, f2u, f2v, blurred, t, black, white):
    """Returns (y, u, v) warped/blended output planes."""
    if mode in (SIDE_BY_SIDE_1, SIDE_BY_SIDE_2):
        fs12 = t.astype(jnp.float32)
        fs21 = (1.0 - t).astype(jnp.float32)
        return _warp_sbs(geom, mode, scale_shift, dtype,
                         f1y, f1u, f1v, f2y, f2u, f2v, blurred,
                         fs12, fs21, black, white)
    fields = _warp_fields(geom, blurred)
    return _warp_sample(geom, mode, scale_shift, dtype,
                        f1y, f1u, f1v, f2y, f2u, f2v, fields, t,
                        black, white)


def _warp_sample(geom: FlowGeometry, mode: int, scale_shift: int, dtype,
                 f1y, f1u, f1v, f2y, f2u, f2v, fields, t, black, white,
                 occlusion_aware: bool = False, bilinear: bool = False,
                 sampling: str = "gather"):
    """Per-blend-position part of the warp (vmapped by the batch path).

    bilinear=True is the `hopperq` quality family: sub-pixel sampling in
    1/64 fixed point instead of the reference's round-to-nearest
    (warpFrameKernel.cl:165-168); applies to the blended mode only.

    sampling="shift" routes the nearest-sampled planes through the
    shift-decomposed sampler (_sample_all_planes; bit-identical, ~50x
    faster on real content where gathers are scalar-rate).  CALLER NOTE:
    the shift path contains dynamic slices whose starts depend on t;
    batch it with lax.map/scan, NOT vmap (vmap would lower the batched
    dynamic slices back into gathers)."""
    H, Wa, rs = geom.height, geom.actual_width, geom.res_scalar
    fs12 = t.astype(jnp.float32)
    fs21 = (1.0 - t).astype(jnp.float32)
    mid = 128 << scale_shift

    if mode == GREY_FLOW:
        flds = _ensure_full_fields(geom, fields)
        OX12, OY12 = flds["OX12"], flds["OY12"]
        grey = jnp.minimum((jnp.abs(OX12) + jnp.abs(OY12)) << 2, 255)
        out_y = (grey << scale_shift).astype(dtype)
        cu = jnp.full((H // 2, Wa // 2), mid, dtype)
        return out_y, cu, cu

    use_bilinear = bilinear and mode == BLENDED_FRAME
    shiftlike = sampling == "shift"
    use_shift = (shiftlike and not use_bilinear
                 and "OX12l" in fields
                 and mode in (WARPED_FRAME_12, WARPED_FRAME_21,
                              BLENDED_FRAME, HSV_FLOW))
    # the measured-sub-pel combo (FX fields) stays on the gather path:
    # its per-pixel 1/64 refinement breaks the few-distinct-values
    # structure the shift decomposition rides
    use_bshift = (shiftlike and use_bilinear
                  and "OX12l" in fields and "FX12" not in fields)
    # the reference's rounded+mirrored coordinate fields, built only for
    # the paths that gather with them (the shift samplers never touch
    # them; their runtime fallbacks build their own inside the cond)
    # full-res fields built lazily: the shift paths' hot branch never
    # reads them (GREY/HSV and the gather compositions do; the shift
    # samplers' runtime fallbacks rebuild them inside their cond)
    if mode == HSV_FLOW or not (use_shift or use_bshift):
        fields = _ensure_full_fields(geom, fields)
        OX12, OY12 = fields["OX12"], fields["OY12"]
        OX21, OY21 = fields["OX21"], fields["OY21"]
    ncy12 = ncx12 = ncy21 = ncx21 = None
    if not use_shift and not use_bilinear:
        cyg, cxg = jnp.mgrid[0:H, 0:Wa]
        ncx12 = mirror_edge2(
            cxg + _iround(OX12.astype(jnp.float32) * fs12), Wa)
        ncy12 = mirror_edge2(
            cyg + _iround(OY12.astype(jnp.float32) * fs12), H)
        ncx21 = mirror_edge2(
            cxg - _iround(OX21.astype(jnp.float32) * fs21), Wa)
        ncy21 = mirror_edge2(
            cyg - _iround(OY21.astype(jnp.float32) * fs21), H)

    sp = None
    bq = None
    if use_shift:
        sp = _sample_all_planes(geom, fields, f1y, f1u, f1v, f2y, f2u, f2v,
                                fs12, fs21)
    if use_bshift:
        bq = _bilinear_all_planes(geom, fields, f1y, f1u, f1v,
                                  f2y, f2u, f2v, fs12, fs21)

    if mode == WARPED_FRAME_12:
        out_y = sp[0] if use_shift else _gather(f1y, ncy12, ncx12)
    elif mode == WARPED_FRAME_21:
        out_y = sp[1] if use_shift else _gather(f2y, ncy21, ncx21)
    elif use_bilinear and bq is not None:
        s12q = bq[0].astype(jnp.float32)
        s21q = bq[1].astype(jnp.float32)
        val = (s12q * fs21 + s21q * fs12) * np.float32(1.0 / 4096.0)
        blended = jnp.floor(val + 0.5).astype(jnp.int32)
        if occlusion_aware:      # hopperxq: sub-pixel + occlusion handling
            k = np.float32(1.0 / 4096.0)
            s12i = jnp.floor(s12q * k + 0.5).astype(jnp.int32)
            s21i = jnp.floor(s21q * k + 0.5).astype(jnp.int32)
            blended = _occlusion_adjust(blended, s12i, s21i, fs12,
                                        scale_shift)
        out_y = _levels_y_rt(blended, black, white, scale_shift)
    elif use_bilinear:
        cyg, cxg = jnp.mgrid[0:H, 0:Wa]
        if "FX12" in fields:
            # measured sub-pel flow (subpel_flow): integer + 1/64 frac
            # combined in fixed point before the blend-time scale
            p12x = (cxg << 6) + _iround(
                ((OX12 << 6) + fields["FX12"]).astype(jnp.float32) * fs12)
            p12y = (cyg << 6) + _iround(
                ((OY12 << 6) + fields["FY12"]).astype(jnp.float32) * fs12)
            p21x = (cxg << 6) - _iround(
                ((OX21 << 6) + fields["FX21"]).astype(jnp.float32) * fs21)
            p21y = (cyg << 6) - _iround(
                ((OY21 << 6) + fields["FY21"]).astype(jnp.float32) * fs21)
        else:
            p12x = (cxg << 6) + _iround(OX12.astype(jnp.float32) * (fs12 * 64))
            p12y = (cyg << 6) + _iround(OY12.astype(jnp.float32) * (fs12 * 64))
            p21x = (cxg << 6) - _iround(OX21.astype(jnp.float32) * (fs21 * 64))
            p21y = (cyg << 6) - _iround(OY21.astype(jnp.float32) * (fs21 * 64))
        s12q = _bilinear_sample(f1y, p12y, p12x, H, Wa).astype(jnp.float32)
        s21q = _bilinear_sample(f2y, p21y, p21x, H, Wa).astype(jnp.float32)
        val = (s12q * fs21 + s21q * fs12) * np.float32(1.0 / 4096.0)
        blended = jnp.floor(val + 0.5).astype(jnp.int32)
        if occlusion_aware:      # hopperxq: sub-pixel + occlusion handling
            k = np.float32(1.0 / 4096.0)
            s12i = jnp.floor(s12q * k + 0.5).astype(jnp.int32)
            s21i = jnp.floor(s21q * k + 0.5).astype(jnp.int32)
            blended = _occlusion_adjust(blended, s12i, s21i, fs12,
                                        scale_shift)
        out_y = _levels_y_rt(blended, black, white, scale_shift)
    else:
        s12 = sp[0] if use_shift else _gather(f1y, ncy12, ncx12)
        s21 = sp[1] if use_shift else _gather(f2y, ncy21, ncx21)
        blended = _blend_fix(s12, s21, fs12, scale_shift)
        if occlusion_aware and mode == BLENDED_FRAME:
            blended = _occlusion_adjust(blended, s12, s21, fs12, scale_shift)
        if mode == HSV_FLOW:
            res_impact = 4 if rs <= 2 else 1
            b8 = (blended >> scale_shift) if scale_shift else blended
            blended = _visualize_flow(-OX12, -OY12, b8, 0, res_impact) << scale_shift
        out_y = _levels_y_rt(blended, black, white, scale_shift)
    out_y = out_y.astype(dtype)

    # ---------------- chroma pass (cz = 1) ----------------
    hc = H >> 1
    cyg, cxg = jnp.mgrid[0:hc, 0:Wa]
    if not use_shift and not use_bilinear:
        OX12c, OY12c = fields["OX12c"], fields["OY12c"]
        OX21c, OY21c = fields["OX21c"], fields["OY21c"]
        ncx12 = mirror_edge2(
            cxg + _iround(OX12c.astype(jnp.float32) * fs12), Wa)
        ncy12 = mirror_edge2(
            cyg + _iround(OY12c.astype(jnp.float32) * fs12 * 0.5), hc)
        ncx21 = mirror_edge2(
            cxg - _iround(OX21c.astype(jnp.float32) * fs21), Wa)
        ncy21 = mirror_edge2(
            cyg - _iround(OY21c.astype(jnp.float32) * fs21 * 0.5), hc)

    def samp(plane, ncy, ncx, par):
        # NV12 addressing (newCx & ~1) + (cx & 1) on planar u/v:
        # take every other output column's coordinates (parity par).
        return _gather(plane, ncy[:, par::2], ncx[:, par::2] >> 1)

    if mode == WARPED_FRAME_12:
        out_u = sp[2] if use_shift else samp(f1u, ncy12, ncx12, 0)
        out_v = sp[4] if use_shift else samp(f1v, ncy12, ncx12, 1)
    elif mode == WARPED_FRAME_21:
        out_u = sp[3] if use_shift else samp(f2u, ncy21, ncx21, 0)
        out_v = sp[5] if use_shift else samp(f2v, ncy21, ncx21, 1)
    elif use_bilinear and bq is not None:
        k = np.float32(1.0 / 4096.0)
        bu12 = bq[2][0].astype(jnp.float32)
        bv12 = bq[2][1].astype(jnp.float32)
        bu21 = bq[3][0].astype(jnp.float32)
        bv21 = bq[3][1].astype(jnp.float32)
        bu = jnp.floor((bu12 * fs21 + bu21 * fs12) * k + 0.5).astype(jnp.int32)
        bv = jnp.floor((bv12 * fs21 + bv21 * fs12) * k + 0.5).astype(jnp.int32)
        if occlusion_aware:      # hopperxq
            bu = _occlusion_adjust(
                bu, jnp.floor(bu12 * k + 0.5).astype(jnp.int32),
                jnp.floor(bu21 * k + 0.5).astype(jnp.int32), fs12,
                scale_shift)
            bv = _occlusion_adjust(
                bv, jnp.floor(bv12 * k + 0.5).astype(jnp.int32),
                jnp.floor(bv21 * k + 0.5).astype(jnp.int32), fs12,
                scale_shift)
        out_u = _levels_uv_rt(bu, white, scale_shift)
        out_v = _levels_uv_rt(bv, white, scale_shift)
    elif use_bilinear:
        # planar chroma space: horizontal displacement is off_x/2 chroma
        # samples, vertical off_y/2 chroma rows
        OX12c, OY12c = fields["OX12c"], fields["OY12c"]
        OX21c, OY21c = fields["OX21c"], fields["OY21c"]
        pxg = (cxg >> 1) << 6
        pyg = cyg << 6
        if "FX12c" in fields:
            # full-res 1/64 displacement halved into chroma space
            p12x = pxg + _iround(
                ((OX12c << 6) + fields["FX12c"]).astype(jnp.float32)
                * (fs12 * 0.5))
            p12y = pyg + _iround(
                ((OY12c << 6) + fields["FY12c"]).astype(jnp.float32)
                * (fs12 * 0.5))
            p21x = pxg - _iround(
                ((OX21c << 6) + fields["FX21c"]).astype(jnp.float32)
                * (fs21 * 0.5))
            p21y = pyg - _iround(
                ((OY21c << 6) + fields["FY21c"]).astype(jnp.float32)
                * (fs21 * 0.5))
        else:
            p12x = pxg + _iround(OX12c.astype(jnp.float32) * (fs12 * 32))
            p12y = pyg + _iround(OY12c.astype(jnp.float32) * (fs12 * 32))
            p21x = pxg - _iround(OX21c.astype(jnp.float32) * (fs21 * 32))
            p21y = pyg - _iround(OY21c.astype(jnp.float32) * (fs21 * 32))
        wc = Wa >> 1

        def bsamp(plane, py, px, par):
            return _bilinear_sample(plane, py[:, par::2], px[:, par::2],
                                    hc, wc).astype(jnp.float32)

        k = np.float32(1.0 / 4096.0)
        bu12, bu21 = bsamp(f1u, p12y, p12x, 0), bsamp(f2u, p21y, p21x, 0)
        bv12, bv21 = bsamp(f1v, p12y, p12x, 1), bsamp(f2v, p21y, p21x, 1)
        bu = jnp.floor((bu12 * fs21 + bu21 * fs12) * k + 0.5).astype(jnp.int32)
        bv = jnp.floor((bv12 * fs21 + bv21 * fs12) * k + 0.5).astype(jnp.int32)
        if occlusion_aware:      # hopperxq
            bu = _occlusion_adjust(
                bu, jnp.floor(bu12 * k + 0.5).astype(jnp.int32),
                jnp.floor(bu21 * k + 0.5).astype(jnp.int32), fs12,
                scale_shift)
            bv = _occlusion_adjust(
                bv, jnp.floor(bv12 * k + 0.5).astype(jnp.int32),
                jnp.floor(bv21 * k + 0.5).astype(jnp.int32), fs12,
                scale_shift)
        out_u = _levels_uv_rt(bu, white, scale_shift)
        out_v = _levels_uv_rt(bv, white, scale_shift)
    else:
        su12 = sp[2] if use_shift else samp(f1u, ncy12, ncx12, 0)
        su21 = sp[3] if use_shift else samp(f2u, ncy21, ncx21, 0)
        sv12 = sp[4] if use_shift else samp(f1v, ncy12, ncx12, 1)
        sv21 = sp[5] if use_shift else samp(f2v, ncy21, ncx21, 1)
        bu = _blend_fix(su12, su21, fs12, scale_shift)
        bv = _blend_fix(sv12, sv21, fs12, scale_shift)
        if occlusion_aware and mode == BLENDED_FRAME:
            bu = _occlusion_adjust(bu, su12, su21, fs12, scale_shift)
            bv = _occlusion_adjust(bv, sv12, sv21, fs12, scale_shift)
        if mode == HSV_FLOW:
            OX12c, OY12c = fields["OX12c"], fields["OY12c"]
            res_impact = 4 if rs <= 2 else 1
            bu8 = (bu >> scale_shift) if scale_shift else bu
            bv8 = (bv >> scale_shift) if scale_shift else bv
            bu = _visualize_flow(-OX12c[:, 0::2], -OY12c[:, 0::2], bu8, 1,
                                 res_impact) << scale_shift
            bv = _visualize_flow(-OX12c[:, 1::2], -OY12c[:, 1::2], bv8, 2,
                                 res_impact) << scale_shift
        out_u = _levels_uv_rt(bu, white, scale_shift)
        out_v = _levels_uv_rt(bv, white, scale_shift)
    return out_y, out_u.astype(dtype), out_v.astype(dtype)


def _warp_sbs(geom, mode, scale_shift, dtype,
              f1y, f1u, f1v, f2y, f2u, f2v, blurred,
              fs12, fs21, black, white):
    """Side-by-side debug modes (warpFrameKernel.cl:131-148), generic
    per-pixel-gather path for both planes."""
    H, Wa, rs = geom.height, geom.actual_width, geom.res_scalar
    W = geom.stride
    lh, lw = geom.low_h, geom.low_w
    mid = 128 << scale_shift

    outs = []
    for cz in (0, 1):
        rows = H if cz == 0 else H >> 1
        plane_rows = rows
        cyg, cxg = jnp.mgrid[0:rows, 0:Wa]
        adj_cy, adj_cx = cyg, cxg
        src1 = f1y if cz == 0 else None
        forced_mask = jnp.zeros((rows, Wa), bool)
        forced_val = jnp.zeros((rows, Wa), jnp.int32)

        def fetch(py, pu, pv, ry, rx):
            if cz == 0:
                return _gather(py, ry, rx).astype(jnp.int32)
            u = _gather(pu, ry, rx >> 1).astype(jnp.int32)
            v = _gather(pv, ry, rx >> 1).astype(jnp.int32)
            return jnp.where((cxg & 1) == 0, u, v)

        if mode == SIDE_BY_SIDE_1:
            # left side copies source verbatim (cl:131-133): index is (cy, cx)
            left = cxg < (Wa >> 1)
            lv = fetch(f1y, f1u, f1v, cyg, cxg)
            forced_mask, forced_val = left, lv
        else:  # SIDE_BY_SIDE_2
            vo = H >> 2
            in_rows = (cyg >= (vo >> cz)) & (cyg < ((vo >> cz) + (H >> (1 + cz))))
            in_left = in_rows & (cxg < (W >> 1))
            in_right = in_rows & (cxg >= (W >> 1)) & (cxg < W)
            ly = jnp.clip((cyg - (vo >> cz)) << 1, 0, plane_rows - 1)
            lx = jnp.clip((cxg << 1) + ((cxg & 1) if cz else 0), 0, W - 1)
            lv = fetch(f1y, f1u, f1v, ly, lx)
            forced_mask = in_left | (~in_left & ~in_right)
            forced_val = jnp.where(in_left, lv, mid if cz else 0)
            adj_cx = jnp.where(in_right, (cxg - (Wa >> 1)) << 1, cxg)
            adj_cy = jnp.where(in_right, (cyg - (vo >> cz)) << 1, cyg)

        # flow lookup (generic gather; adj coords are dynamic here)
        if cz == 0:
            scx = jnp.clip(adj_cx >> rs, 0, lw - 1)
            scy = jnp.clip(adj_cy >> rs, 0, lh - 1)
        else:
            scx = jnp.clip((adj_cx >> rs) & ~1, 0, lw - 1)
            scy = jnp.clip((adj_cy >> rs) << 1, 0, lh - 1)
        ox12 = _gather(blurred[0], scy, scx)
        oy12 = _gather(blurred[1], scy, scx)
        bscy = jnp.clip(scy - (oy12 >> rs), 0, lh - 1)
        bscx = jnp.clip(scx - (ox12 >> rs), 0, lw - 1)
        ox21 = _gather(blurred[0], bscy, bscx)
        oy21 = _gather(blurred[1], bscy, bscx)

        ydim = (H >> 1) if cz else H
        yscale = 0.5 if cz else 1.0
        ncx12 = mirror_edge2(adj_cx + _iround(ox12.astype(jnp.float32) * fs12), Wa)
        ncy12 = mirror_edge2(adj_cy + _iround(oy12.astype(jnp.float32) * fs12 * yscale), ydim)
        ncx21 = mirror_edge2(adj_cx - _iround(ox21.astype(jnp.float32) * fs21), Wa)
        ncy21 = mirror_edge2(adj_cy - _iround(oy21.astype(jnp.float32) * fs21 * yscale), ydim)
        if cz:
            sx12 = (ncx12 & ~1) + (cxg & 1)
            sx21 = (ncx21 & ~1) + (cxg & 1)
        else:
            sx12, sx21 = ncx12, ncx21
        s12 = fetch(f1y, f1u, f1v, ncy12, sx12)
        s21 = fetch(f2y, f2u, f2v, ncy21, sx21)
        blended = _blend_fix(s12, s21, fs12, scale_shift)
        if cz:
            val = _levels_uv(blended, white, scale_shift)
        else:
            val = _levels_y(blended, black, white, scale_shift)
        val = jnp.where(forced_mask, forced_val, val)
        outs.append(val)

    out_y = outs[0].astype(dtype)
    uv = outs[1]
    out_u = _col_take(uv, 2, 0).astype(dtype)
    out_v = _col_take(uv, 2, 1).astype(dtype)
    return out_y, out_u, out_v


@functools.lru_cache(maxsize=128)
def make_warp_batch_fn(geom: FlowGeometry, mode: int, scale_shift: int = 0):
    """Jitted batched warp: fn(f1y,...,f2v, blurred, ts, black, white)
    -> (y (N,H,Wa), u (N,H/2,Wa/2), v (N,H/2,Wa/2)) for a vector of N
    blend positions.

    All output frames of one source pair ride a single dispatch: the
    t-independent flow fields are computed once and the per-t sampling is
    vmapped.  (The reference launches warpFrameKernel per output frame,
    opticalFlowCalc.c:205-233; a batched dispatch amortizes launch
    overhead and reuses the flow upsample.)  SBS modes fall back to
    per-frame vmap of the generic path."""
    dtype = jnp.uint16 if scale_shift else jnp.uint8

    def impl(f1y, f1u, f1v, f2y, f2u, f2v, blurred, ts, black, white):
        if mode in (SIDE_BY_SIDE_1, SIDE_BY_SIDE_2):
            def one(t):
                return _warp_impl(geom, mode, scale_shift, dtype,
                                  f1y, f1u, f1v, f2y, f2u, f2v, blurred,
                                  t, black, white)
            return jax.vmap(one)(ts)
        fields = _warp_fields(geom, blurred)

        def one(t):
            return _warp_sample(geom, mode, scale_shift, dtype,
                                f1y, f1u, f1v, f2y, f2u, f2v, fields, t,
                                black, white)
        return jax.vmap(one)(ts)

    return jax.jit(impl)


@functools.lru_cache(maxsize=64)
def make_warp_fn(geom: FlowGeometry, mode: int, scale_shift: int = 0):
    """Jitted warp: fn(f1y,f1u,f1v,f2y,f2u,f2v, blurred, t, black, white)
    -> (y (H,Wa), u (H/2,Wa/2), v (H/2,Wa/2)).

    f1 = older source frame, f2 = newer; t = blendingScalar in [0,1]
    (opticalFlowCalc.c:214-216: frameScalar12 = t, frameScalar21 = 1-t)."""
    dtype = jnp.uint16 if scale_shift else jnp.uint8
    impl = functools.partial(_warp_impl, geom, mode, scale_shift, dtype)
    return jax.jit(impl)
