"""Cross-validate the vectorized oracle against literal scalar loops.

The oracle (ops/oracle.py) is the golden model for every other test, so it
gets an independent check: a direct per-pixel transliteration of
calcDeltaSumsKernel.cl / adjustOffsetArrayKernel.cl / warpFrameKernel.cl
written as plain Python loops (slow; tiny frames only).  Any vectorization
mistake in the oracle would show up here.
"""

import math

import numpy as np
import pytest

from mpv_frame_interpolator.ops import oracle


def mirror_inside_s(pos, dim):
    if pos >= dim:
        pos = dim - (pos - dim + 1)
    elif pos < 0:
        pos = -pos - 1
    return min(max(pos, 0), dim - 1)


def mirror_edge2_s(pos, dim):
    res = pos
    if pos >= dim - 1:
        res = pos - (pos - (dim - 2)) * 2
    elif pos < 1:
        res = -pos + 1
    return min(max(res, 1), dim - 2)


def scalar_delta_sums(f1y, f1uv, f2y, f2uv, off, window, R, rs, iteration,
                      step, ds, nbs):
    """calcDeltaSumsKernel.cl:34-188 as literal loops + window summation."""
    dim_y, dim_x = f1y.shape
    _, lh, lw = off.shape
    nwy, nwx = -(-lh // window), -(-lw // window)
    sums = np.zeros((R, nwy, nwx), dtype=np.uint64)
    for z in range(R):
        rel = (z % R) - R // 2
        adj = rel * rel * (1 if rel > 0 else -1)
        for cy in range(lh):
            for cx in range(lw):
                ix = int(off[0, cy, cx])
                iy = int(off[1, cy, cx])
                if step == 0:
                    ox, oy = ix + adj, iy
                else:
                    ox, oy = ix, iy + adj
                scx, scy = cx << rs, cy << rs
                ncx = mirror_inside_s(scx + ox, dim_x)
                ncy = mirror_inside_s(scy + oy, dim_y)
                if 0 <= scx < dim_x and 0 <= scy < dim_y:
                    d = (abs(int(f1y[ncy, ncx]) - int(f2y[scy, scx]))
                         + abs(int(f1uv[ncy >> 1, ncx & ~1])
                               - int(f2uv[scy >> 1, scx & ~1]))
                         + abs(int(f1uv[ncy >> 1, (ncx & ~1) + 1])
                               - int(f2uv[scy >> 1, (scx & ~1) + 1])))
                    d = (d << ds) % (1 << 32)
                else:
                    d = 0
                bias = abs(ox) if step == 0 else abs(oy)
                nb = 0
                if iteration >= 4:
                    w2 = 2 * window
                    cur = ox if step == 0 else oy
                    plane = 0 if step == 0 else 1
                    for dx, dy in ((0, w2), (w2, 0), (-w2, 0), (0, -w2)):
                        nx = min(max(cx + dx, 0), lw - 1)
                        ny = min(max(cy + dy, 0), lh - 1)
                        nb += abs(int(off[plane, ny, nx]) - cur)
                    nb = (nb << nbs) % (1 << 32)
                sums[z, cy // window, cx // window] += (d + bias + nb) % (1 << 32)
    return (sums % (1 << 32)).astype(np.uint32)


def scalar_warp_luma(f1y, f2y, off, t, rs, wa, black, white):
    """warpFrameKernel.cl:150-181 luma blended path as literal loops, with
    the framework's exact-integer blend/levels semantics."""
    dim_y, dim_x = f1y.shape
    _, lh, lw = off.shape
    w1, w2 = oracle.blend_weights(t)
    fs12 = np.float32(t)
    fs21 = np.float32(1.0 - t)
    out = np.zeros((dim_y, wa), np.uint8)
    k, w = int(round(black)), int(round(white))
    for cy in range(dim_y):
        for cx in range(wa):
            scx = min(cx >> rs, lw - 1)
            scy = min(cy >> rs, lh - 1)
            ox12 = int(off[0, scy, scx])
            oy12 = int(off[1, scy, scx])
            bscy = min(max(scy - (oy12 >> rs), 0), lh - 1)
            bscx = min(max(scx - (ox12 >> rs), 0), lw - 1)
            ox21 = int(off[0, bscy, bscx])
            oy21 = int(off[1, bscy, bscx])

            def rnd(v):
                return int(math.copysign(math.floor(abs(v) + 0.5), v))

            nx12 = mirror_edge2_s(cx + rnd(np.float32(ox12) * fs12), wa)
            ny12 = mirror_edge2_s(cy + rnd(np.float32(oy12) * fs12), dim_y)
            nx21 = mirror_edge2_s(cx - rnd(np.float32(ox21) * fs21), wa)
            ny21 = mirror_edge2_s(cy - rnd(np.float32(oy21) * fs21), dim_y)
            s12 = int(f1y[ny12, nx12])
            s21 = int(f2y[ny21, nx21])
            blended = (s12 * w1 + s21 * w2) >> 24
            n = max((blended - k) * 255, 0)
            out[cy, cx] = min(n // max(w - k, 1), 255)
    return out


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(77)
    h, w = 12, 16
    f1y = rng.integers(0, 255, (h, w)).astype(np.uint8)
    f2y = rng.integers(0, 255, (h, w)).astype(np.uint8)
    f1uv = rng.integers(0, 255, (h // 2, w)).astype(np.uint8)
    f2uv = rng.integers(0, 255, (h // 2, w)).astype(np.uint8)
    return f1y, f1uv, f2y, f2uv


class TestOracleScalarCrosscheck:
    @pytest.mark.parametrize("window,iteration,step", [
        (4, 0, 0), (4, 0, 1), (2, 4, 0), (1, 5, 1)])
    def test_delta_sums(self, tiny, window, iteration, step):
        f1y, f1uv, f2y, f2uv = tiny
        rng = np.random.default_rng(5)
        off = rng.integers(-6, 6, (2, 12, 16)).astype(np.int16)
        R, rs, ds, nbs = 4, 0, 8, 6
        vec = oracle.calc_delta_sums(f1y, f1uv, f2y, f2uv, off, window, R,
                                     rs, iteration, step, ds, nbs)
        sca = scalar_delta_sums(f1y, f1uv, f2y, f2uv, off, window, R, rs,
                                iteration, step, ds, nbs)
        np.testing.assert_array_equal(sca, vec)

    def test_warp_luma(self, tiny):
        f1y, f1uv, f2y, f2uv = tiny
        rng = np.random.default_rng(6)
        off = rng.integers(-5, 5, (2, 12, 16)).astype(np.int16)
        vec_y, _ = oracle.warp_frame(f1y, f1uv, f2y, f2uv, off, 0.4,
                                     oracle.BLENDED_FRAME, 0, 16)
        sca_y = scalar_warp_luma(f1y, f2y, off.astype(np.int64), 0.4, 0, 16,
                                 0.0, 255.0)
        np.testing.assert_array_equal(sca_y, vec_y)


def scalar_warp_chroma(f1uv, f2uv, off, t, rs, wa, dim_y, white):
    """warpFrameKernel.cl cz=1 pass as literal loops (NV12 interleaved
    addressing: (newCx & ~1) + (cx & 1), half-rate vertical flow)."""
    _, lh, lw = off.shape
    hc = dim_y >> 1
    w1, w2 = oracle.blend_weights(t)
    fs12 = np.float32(t)
    fs21 = np.float32(1.0 - t)
    out = np.zeros((hc, wa), np.uint8)
    wl = max(int(round(white)), 1)
    for cy in range(hc):
        for cx in range(wa):
            scx = min(max((cx >> rs) & ~1, 0), lw - 1)
            scy = min(max((cy >> rs) << 1, 0), lh - 1)
            ox12 = int(off[0, scy, scx])
            oy12 = int(off[1, scy, scx])
            bscy = min(max(scy - (oy12 >> rs), 0), lh - 1)
            bscx = min(max(scx - (ox12 >> rs), 0), lw - 1)
            ox21 = int(off[0, bscy, bscx])
            oy21 = int(off[1, bscy, bscx])

            def rnd(v):
                return int(math.copysign(math.floor(abs(v) + 0.5), v))

            nx12 = mirror_edge2_s(cx + rnd(np.float32(ox12) * fs12), wa)
            ny12 = mirror_edge2_s(cy + rnd(np.float32(oy12) * fs12 * np.float32(0.5)), hc)
            nx21 = mirror_edge2_s(cx - rnd(np.float32(ox21) * fs21), wa)
            ny21 = mirror_edge2_s(cy - rnd(np.float32(oy21) * fs21 * np.float32(0.5)), hc)
            par = cx & 1
            s12 = int(f1uv[ny12, (nx12 & ~1) + par])
            s21 = int(f2uv[ny21, (nx21 & ~1) + par])
            blended = (s12 * w1 + s21 * w2) >> 24
            n = max((blended - 128) * 255 + 128 * wl, 0)
            out[cy, cx] = min(n // wl, 255)
    return out


class TestOracleScalarChroma:
    @pytest.mark.parametrize("t", [0.25, 0.6])
    def test_warp_chroma(self, tiny, t):
        f1y, f1uv, f2y, f2uv = tiny
        rng = np.random.default_rng(8)
        off = rng.integers(-5, 5, (2, 12, 16)).astype(np.int16)
        _, vec_uv = oracle.warp_frame(f1y, f1uv, f2y, f2uv, off, t,
                                      oracle.BLENDED_FRAME, 0, 16)
        sca_uv = scalar_warp_chroma(f1uv, f2uv, off.astype(np.int64), t, 0,
                                    16, 12, 255.0)
        np.testing.assert_array_equal(sca_uv, vec_uv)
