"""Oracle-parity checks, runnable on any active JAX backend.

The golden test suite proves bit-exactness on the CPU; this module
re-proves it on whatever backend is live (the GPU in production), so
compiler or hardware drift is caught: ``run_parity`` checks
``make_flow_fn``/``make_warp_fn`` on small frames in every output mode,
``timed_path_parity`` checks the engine's fused source-pair step (the
program the CLI runs) at full resolution.  ``chip_smoke.py`` runs both
on the card, and ``tests/test_gpu_parity.py`` holds them as tests.

Every row is ``(name, ok, n_diff, max_diff)``: the count of samples
that differ from the oracle and the largest absolute difference.  All
modes are integer arithmetic and must match exactly, except the HSV
flow view, whose atan2 and float hue math may move a sample across a
hue-sector edge by an ulp: it passes while fewer than 0.5% of samples
differ by more than 2 (the same bound tests/test_warp_golden.py holds
the CPU to).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

Row = Tuple[str, bool, int, int]

# (width, height, synthetic source, search radius, blend t)
FULL_CASES = [
    (96, 64, "moving_box", 5, 0.4),
    (96, 64, "gradient_pan", 16, 0.75),
    (320, 180, "moving_box", 8, 0.5),     # res_scalar >= 1
    (128, 544, "gradient_pan", 11, 0.3),  # res_scalar 2, tall
]
SMOKE_CASES = FULL_CASES[:2]

MODE_NAMES = {0: "warp12", 1: "warp21", 2: "blend", 3: "hsv", 4: "grey",
              5: "sbs1", 6: "sbs2"}
# non-default black/white levels, checked in blended mode per case
LEVELS = (16.0, 219.0)


def _row(name: str, refs, gots, hsv: bool = False) -> Row:
    n = m = big = total = 0
    for ref, got in zip(refs, gots):
        d = np.abs(np.asarray(ref).astype(np.int64)
                   - np.asarray(got).astype(np.int64))
        n += int(np.count_nonzero(d))
        m = max(m, int(d.max(initial=0)))
        big += int(np.count_nonzero(d > 2))
        total += d.size
    ok = (big < 0.005 * total) if hsv else n == 0
    return name, bool(ok), n, m


def run_parity(cases: Iterable[tuple] = SMOKE_CASES,
               modes: Iterable[int] = (0, 2),
               levels: bool = False) -> List[Row]:
    """Compare device flow+warp against the NumPy oracle, case by case
    and mode by mode; with ``levels`` also the blended mode at
    non-default black/white levels."""
    import jax.numpy as jnp
    from mpv_frame_interpolator.io import synthetic
    from mpv_frame_interpolator.frame import split_chroma, interleave_chroma
    from mpv_frame_interpolator.ops import oracle
    from mpv_frame_interpolator.ops.flow import FlowGeometry, make_flow_fn
    from mpv_frame_interpolator.ops.warp import make_warp_fn

    rows: List[Row] = []
    for (w, h, src, radius, t) in cases:
        cfg = synthetic.SyntheticConfig(width=w, height=h, fps=24.0)
        gen = getattr(synthetic, src)(cfg, 2)
        f1, f2 = next(gen), next(gen)
        geom = FlowGeometry.create(h, w, w)
        u1, v1 = split_chroma(f1.uv)
        u2, v2 = split_chroma(f2.uv)
        a = [jnp.asarray(x) for x in (f1.y, u1, v1, f2.y, u2, v2)]

        off_ref, blur_ref = oracle.calculate_optical_flow(
            f1.y, f1.uv, f2.y, f2.uv, search_radius=radius,
            res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
        off_dev, _ = make_flow_fn(geom, radius)(*a, jnp.int32(8),
                                                jnp.int32(6))
        rows.append(_row(f"flow {w}x{h} {src} r{radius}",
                         [off_ref], [off_dev]))

        runs = [(mode, 0.0, 255.0) for mode in modes]
        if levels:
            runs.append((oracle.BLENDED_FRAME, *LEVELS))
        for mode, black, white in runs:
            ry, ruv = oracle.warp_frame(
                f1.y, f1.uv, f2.y, f2.uv, blur_ref, t, mode,
                geom.res_scalar, geom.actual_width, black, white)
            y, u, v = make_warp_fn(geom, mode)(
                *a, jnp.asarray(blur_ref.astype(np.int32)),
                jnp.float32(t), jnp.float32(black), jnp.float32(white))
            name = f"warp {w}x{h} {MODE_NAMES.get(mode, mode)} t={t}"
            if (black, white) != (0.0, 255.0):
                name += f" levels={black:g}/{white:g}"
            rows.append(_row(name, [ry, ruv],
                             [y, interleave_chroma(np.asarray(u),
                                                   np.asarray(v))],
                             hsv=mode == oracle.HSV_FLOW))
    return rows


def parity_ok(cases=SMOKE_CASES, modes=(0, 2)) -> bool:
    return all(ok for _, ok, _, _ in run_parity(cases, modes))


def timed_path_parity(content: str, n_pairs: int = 2, width: int = 3840,
                      height: int = 2160, src_fps: float = 24.0,
                      display_fps: float = 120.0, radius: int = 16,
                      scene_detection: bool = True,
                      warp_sampling: str = "shift") -> List[Row]:
    """Outputs of the engine's fused source-pair step (``engine.push``,
    hopper family, blended mode) for ``n_pairs`` pairs of a synthetic
    source against the oracle: one row for each pair's blurred flow and
    one for each output frame.

    A pair the scene detector calls a cut is compared the way the engine
    defines it: zero flow, each blend position snapped to the nearer
    source (cut_policy "nearest"); its flow row still checks the flow
    the engine computed."""
    from mpv_frame_interpolator.io import synthetic
    from mpv_frame_interpolator.ops import oracle
    from mpv_frame_interpolator.pipeline.engine import (
        EngineConfig, InterpolationEngine)

    cfg = synthetic.SyntheticConfig(width=width, height=height, fps=src_fps)
    frames = list(getattr(synthetic, content)(cfg, n_pairs + 1))
    engine = InterpolationEngine(EngineConfig(
        display_fps=display_fps, auto_quality=False,
        initial_search_radius=radius, scene_detection=scene_detection,
        measure_timing=False, background_precompile=False,
        warp_sampling=warp_sampling))
    blends = []
    ts_for = engine._ts_for
    engine._ts_for = lambda b: (blends.append(b), ts_for(b))[1]

    rows: List[Row] = []
    tag = f"{width}x{height} {content}"
    for i, f in enumerate(frames):
        outs = engine.push(f)
        if i == 0:
            continue
        prev = frames[i - 1]
        geom = engine.geom
        _, blur_ref = oracle.calculate_optical_flow(
            prev.y, prev.uv, f.y, f.uv, search_radius=radius,
            res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
        rows.append(_row(f"timed {tag} pair {i} flow", [blur_ref],
                         [np.asarray(engine._blurred)]))
        cut = (scene_detection
               and engine.last_cut_score() > engine.scene.threshold)
        flow = np.zeros_like(blur_ref) if cut else blur_ref
        for o, t in zip(outs, blends[-1]):
            if cut:
                t = 1.0 if t >= 0.5 else 0.0
            ry, ruv = oracle.warp_frame(
                prev.y, prev.uv, f.y, f.uv, flow, t,
                oracle.BLENDED_FRAME, geom.res_scalar, geom.actual_width)
            vf = o.to_video_frame()
            rows.append(_row(
                f"timed {tag} pair {i} t={t:.2f}{' cut' if cut else ''}",
                [ry, ruv], [vf.y, vf.uv]))
    return rows
