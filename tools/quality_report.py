#!/usr/bin/env python
"""Quality report: PSNR of each model family against analytic ground truth.

Uses content whose true in-between frames are computable exactly:
  * integer-shift pan    -- ground truth on the pixel grid (flow must lock)
  * fractional-shift pan -- integer flow CANNOT lock (commits straddle the
    true motion); shows what the measured sub-pixel refinement
    (EngineConfig.subpel_flow) buys on top of hopperq's 1/64-pel sampling
  * sinusoidal pattern   -- ground truth at ANY sub-pixel position

Prints one table per motion; runs on whatever backend is active.

    PYTHONPATH=.:$PYTHONPATH python tools/quality_report.py
"""

import sys

import numpy as np
import jax.numpy as jnp

from mpv_frame_interpolator.frame import (
    FrameFormat, VideoFrame, interleave_chroma, psnr_arrays, split_chroma)
from mpv_frame_interpolator.models.hopper import HopperModel
from mpv_frame_interpolator.ops import warp as W


def sine_frames(shift, w=256, h=128):
    def pattern(delta):
        x = np.arange(w)[None, :] - delta
        y = np.arange(h)[:, None]
        val = (128 + 80 * np.sin(2 * np.pi * x / 24.0)
               + 30 * np.sin(2 * np.pi * (x + 2 * y) / 40.0))
        return np.clip(val, 0, 255).astype(np.uint8)

    def mk(delta, pts):
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = np.full((h // 2, w // 2), 128, np.uint8)
        return VideoFrame(pattern(delta), interleave_chroma(u, v),
                          FrameFormat(w, h), pts=pts, nominal_fps=24.0)
    return mk(0.0, 0.0), mk(float(shift), 1 / 24.0), pattern


def planar(f):
    u, v = split_chroma(f.uv)
    return jnp.asarray(f.y), jnp.asarray(u), jnp.asarray(v)


def report(shift):
    f1, f2, pattern = sine_frames(shift)
    m = HopperModel.for_frame(f1.fmt.height, f1.fmt.width, search_radius=10)
    a = [*planar(f1), *planar(f2)]
    off, blur = m.analyze(*a)
    crop = (slice(12, -12), slice(24, -24))

    # measured sub-pixel refinement (EngineConfig.subpel_flow): blur the
    # 1/64-pel combined field exactly as the engine does
    from mpv_frame_interpolator.ops.flow import (
        _subsampled_f2, blur_flow, subpel_refine)
    frac_raw = subpel_refine(m.geom, off, a[0], a[1], a[2],
                             _subsampled_f2(m.geom, a[3], a[4], a[5]))
    b64 = blur_flow((off << 6) + frac_raw, m.geom.low_h, m.geom.low_w)
    blur_sub = b64 >> 6
    frac = b64 - (blur_sub << 6)

    rows = []
    for t in (0.25, 0.4, 0.5, 0.75):
        gt = pattern(shift * t)[crop]
        fields = W._warp_fields(m.geom, blur)

        def render(**kw):
            y, _, _ = W._warp_sample(
                m.geom, W.BLENDED_FRAME, 0, jnp.uint8, *a, fields,
                jnp.float32(t), jnp.float32(0.0), jnp.float32(255.0), **kw)
            return np.asarray(y)[crop]

        fields_sub = W._warp_fields(m.geom, blur_sub, frac)

        def render_sub(**kw):
            y, _, _ = W._warp_sample(
                m.geom, W.BLENDED_FRAME, 0, jnp.uint8, *a, fields_sub,
                jnp.float32(t), jnp.float32(0.0), jnp.float32(255.0),
                bilinear=True, **kw)
            return np.asarray(y)[crop]

        zero = np.zeros_like(np.asarray(blur))
        fields0 = W._warp_fields(m.geom, jnp.asarray(zero))

        def render_blend():
            y, _, _ = W._warp_sample(
                m.geom, W.BLENDED_FRAME, 0, jnp.uint8, *a, fields0,
                jnp.float32(t), jnp.float32(0.0), jnp.float32(255.0))
            return np.asarray(y)[crop]

        rows.append((t, {
            "blend (no flow)": psnr_arrays(render_blend(), gt, 255),
            "hopper": psnr_arrays(render(), gt, 255),
            "hopperx": psnr_arrays(render(occlusion_aware=True), gt, 255),
            "hopperq": psnr_arrays(render(bilinear=True), gt, 255),
            "hopperxq": psnr_arrays(render(bilinear=True,
                                           occlusion_aware=True), gt, 255),
            "hopperq+subpel": psnr_arrays(render_sub(), gt, 255),
            "hopperxq+subpel": psnr_arrays(
                render_sub(occlusion_aware=True), gt, 255),
        }))

    def cap(x):   # exact hits (integer positions) print as 99dB
        return min(x, 99.0)
    names = list(rows[0][1])
    print(f"pan shift = {shift} px/frame")
    print(f"{'t':>5} " + " ".join(f"{n:>16}" for n in names))
    for t, vals in rows:
        print(f"{t:>5} " + " ".join(f"{cap(vals[n]):>14.1f}dB" for n in names))
    mean = {n: sum(cap(v[n]) for _, v in rows) / len(rows) for n in names}
    print(f"{'mean':>5} " + " ".join(f"{mean[n]:>14.1f}dB" for n in names))
    print()


def run():
    import jax
    from mpv_frame_interpolator.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    print(f"backend: {jax.default_backend()}")
    report(6)      # integer motion: flow locks exactly, subpel is a no-op
    report(2.5)    # fractional motion: integer commits straddle the truth
    return 0


if __name__ == "__main__":
    sys.exit(run())
