"""InterpolationEngine: the device-side heart of the pipeline.

Plays the role of vf_HopperRender's process() + the OpticalFlowCalc host
driver (vf_HopperRender.c:512-533, opticalFlowCalc.c), re-imagined for XLA:

* push(frame) takes one decoded source frame and returns ALL output frames
  due for it (the reference trickles intermediates through repeated filter
  invocations; a pull-based Python pipeline doesn't need that).
* Device state is a pair of planar frame pytrees (ping-pong by rebinding,
  the XLA analog of the cl_mem swap in opticalFlowCalc.c:102-106).
* Flow runs once per source pair; ALL of the pair's warps ride one fused
  dispatch.  Everything stays on device until the sink downloads.
* Scene-cut handling is branchless-on-host: the cut decision is a traced
  scalar folded into the warp (flow zeroed, blend snapped), so no device
  sync is needed on the hot path.
* The quality controller is fed the measured flow+warp wall time of the
  previous source frame, mirroring the OpenCL event timing loop
  (opticalFlowCalc.c:111-122,192-201 -> vf_HopperRender.c:326-345).
"""

from __future__ import annotations

import dataclasses
from os import environ as _os_env
import functools
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpv_frame_interpolator.frame import (
    FrameFormat, VideoFrame, NV12)
from mpv_frame_interpolator.ops.flow import FlowGeometry
from mpv_frame_interpolator.ops import warp as warp_ops
from mpv_frame_interpolator.ops.lanes import deinterleave_uv as _deint
from mpv_frame_interpolator.pipeline.cadence import (
    CadenceEngine, InterpolationState)
from mpv_frame_interpolator.pipeline.quality import QualityController
from mpv_frame_interpolator.pipeline import scene as scene_mod
from mpv_frame_interpolator.pipeline.scene import SceneChangeDetector
from mpv_frame_interpolator.utils import get_logger, StatsRegistry

log = get_logger("engine")

# Background-precompile thread registry: XLA must not be mid-compile on a
# daemon thread when the interpreter tears down (pthread cancellation
# aborts with "FATAL: exception not rethrown").  The atexit hook asks the
# threads to stop between batch sizes and joins the in-flight one.
_warm_threads = []
_warm_shutdown = None


def _register_warm_thread(t):
    global _warm_shutdown
    import atexit
    import threading
    if _warm_shutdown is None:
        _warm_shutdown = threading.Event()

        def _drain():
            _warm_shutdown.set()
            for th in _warm_threads:
                th.join(timeout=120.0)

        atexit.register(_drain)
    _warm_threads.append(t)


@dataclasses.dataclass
class EngineConfig:
    display_fps: float = 60.0
    frame_output_mode: int = warp_ops.BLENDED_FRAME  # FrameOutput default 2
                                                     # (vf_HopperRender.c:716)
    auto_quality: bool = True                        # config.h:10
    initial_search_radius: int = 5                   # MIN_SEARCH_RADIUS
    too_slow_patience: int = 3   # consecutive over-budget frames before
                                 # TooSlow (1 = exact reference behavior)
    scene_detection: bool = True
    scene_threshold: float = 28.0
    cut_policy: str = "nearest"                      # "nearest" | "hold"
    delta_scalar: int = 8                            # opticalFlowCalc.c:339
    neighbor_bias_scalar: int = 6                    # opticalFlowCalc.c:340
    black_level: float = 0.0                         # opticalFlowCalc.c:328
    white_level: float = 255.0                       # opticalFlowCalc.c:329
    max_calc_res: int = 270                          # config.h:2
    num_iterations: int = 0                          # config.h:4
    # feed the quality controller the wall time from dispatch until the
    # pair's last output is ready (block_until_ready) -- the analog of the
    # reference's OpenCL event timing (vf_HopperRender.c:326-345)
    measure_timing: bool = True
    playback_speed: float = 1.0
    precompile: bool = False         # compile all batch sizes at init
    # compile the OTHER plausible warp-batch sizes on a background thread
    # right after the first frame is out, so a cold cache stalls playback
    # once, not once per batch size (the 24->60 cadence alternates 2/3
    # outputs per pair -> two programs).  Measurements taken while the
    # background compile is executing are discarded (device contention).
    # (MFI_BG_PRECOMPILE=0 force-disables -- the CPU test suite does:
    # concurrent XLA:CPU compiles from the warm thread + the main thread
    # have segfaulted the compiler on this host)
    background_precompile: bool = _os_env.get("MFI_BG_PRECOMPILE",
                                              "1") != "0"
    # persistent jit cache at the place utils/compile_cache.py chooses
    # (MFI_COMPILE_CACHE=0 disables; the CPU test suite does -- loading
    # AOT artifacts compiled for another host's CPU features can
    # SIGILL/SEGV, per XLA's own loader warning)
    compile_cache: bool = _os_env.get("MFI_COMPILE_CACHE", "1") != "0"
    model: str = "hopper"            # interpolator family (models/)
    stats_log_path: str = ""         # append per-source-frame compute time
                                     # (SAVE_STATS/ofclog.txt analog,
                                     # vf_HopperRender.c:313-324)
    # flow/warp split telemetry (the reference times each stage with CL
    # profiling events, opticalFlowCalc.c:111-122,192-201; the fused
    # one-dispatch hot path has no stage boundary to time):
    #   "auto"   = keep the fused dispatch; when a telemetry consumer asks
    #              (applet / ofc-time property), measure the split once per
    #              (radius, batch, mode) spec via dedicated flow/warp
    #              programs and republish on spec changes
    #   "always" = dispatch flow and warp as two programs every source
    #              frame and time each (reference-authentic; slightly
    #              slower: two device round-trips per pair)
    #   "off"    = no split telemetry (ofc/warp times read 0)
    split_timing: str = "auto"
    # warp-batch shape policy:
    #   "exact"  = one program per distinct output count (2-4 programs for
    #              a fixed rate pair; the r1 behavior)
    #   "bucket" = pad the blend batch up to {1,2,3,4,6,8,12,16,24,...}
    #              (1.5x steps, <=33% padded warp compute) so VFR sources
    #              whose per-pair output counts vary never hit a compile
    #              stall after the first few buckets
    batch_shapes: str = "exact"
    # how the N per-pair warps are expressed inside the fused program:
    #   "vmap" = batched warp (default)
    #   "scan" = lax.map over the blend axis; bit-identical outputs.
    # Compile time, not speed, is what separates them; neither has been
    # measured against the other on the GPU.
    warp_loop: str = "vmap"
    # warp source sampling for the nearest families:
    #   "shift"  = shift-decomposed exact sampler: one dynamic slice +
    #              masked select per DISTINCT displacement (ops/warp.
    #              _sample_all_planes), with a runtime fallback to the
    #              gather program for fields too wild for its budgets
    #   "gather" = per-pixel gather everywhere (the reference's design)
    # Both are bit-exact; which one the GPU should default to is open
    # (PERF.md has the per-pair device times of each).
    warp_sampling: str = "shift"
    # compiled flow LAYER-count variants.  The search radius is traced, so
    # radius changes inside a bucket never recompile -- but round 2 kept a
    # single MAX_SEARCH_RADIUS(16)-layer program, so the quality
    # controller's degradation changed the argmin mask and not one
    # millisecond of chip time (the reference scales its launch grid's
    # layer dimension with the LIVE radius, opticalFlowCalc.c:130, which
    # is exactly how its TooSlow rescue works).  Buckets restore that:
    # radius r runs the smallest compiled variant with layers >= r, so
    # stepping 16 -> 5 really cuts the per-step candidate work ~3.2x.
    # () disables (single 16-layer program, the round-2 behavior).
    layer_buckets: tuple = (5, 8, 16)
    # Degradation ladder BEYOND the radius floor (QualityController.
    # level).  Each rung is (iteration_delta, res_divisor[, model])
    # relative to the configured setup: the rung's flow pyramid runs
    # max(base_iterations - iteration_delta, 1) iterations at
    # max(max_calc_res // res_divisor, 64) calc resolution, optionally
    # under a cheaper interpolator family.  Radius is the reference's
    # only lever (it scales the launch grid, opticalFlowCalc.c:130); the
    # rungs add pyramid depth, calc resolution and, as the last resort
    # before the reference's TooSlow passthrough, the zero-flow "blend"
    # family (cross-fade at the full display rate: still a better
    # experience than TooSlow's source-rate snap, and far cheaper than
    # warping).  () disables the ladder (radius-only degradation,
    # reference-shaped).  Rung programs are warmed by the
    # background-precompile thread; the controller only steps onto a
    # warm rung.  (3,4) -- depth -3, calc-res 67 rows -- is the middle
    # rung between (2,2) and the blend cliff.  What each rung buys on
    # the GPU is not measured yet (ROADMAP Speed 5).
    degrade_rungs: tuple = ((2, 2), (3, 4), (3, 4, "blend"))
    # measured fractional-pel flow (ops/flow.subpel_refine): parabolic
    # sub-pel refinement of the committed integer flow.  The bilinear
    # families (hopperq/hopperxq) consume it at 1/64-pel in the warp; the
    # integer families (hopper/hopperx) consume it as a round-to-nearest
    # flow field (vs the default floor-of-integer-blur).  Off by default:
    # it changes the flow families' outputs (a quality choice, not
    # parity).
    subpel_flow: bool = False

    def __post_init__(self):
        # startup validation mirroring vf_HopperRender_create
        # (vf_HopperRender.c:585-622)
        if self.max_calc_res < 64:
            raise ValueError("max_calc_res must be at least 64")
        if self.num_iterations < 0:
            raise ValueError("num_iterations must be >= 0 (0 = maximum)")
        if not 2 <= self.initial_search_radius <= 256:
            raise ValueError("search radius must be within [2, 256]")
        if not 0 <= self.frame_output_mode <= 6:
            raise ValueError("frame_output_mode must be in [0, 6]")
        if self.display_fps <= 0:
            raise ValueError("display_fps must be positive")
        if self.cut_policy not in ("nearest", "hold"):
            raise ValueError("cut_policy must be 'nearest' or 'hold'")
        if self.split_timing not in ("auto", "always", "off"):
            raise ValueError("split_timing must be auto|always|off")
        if self.batch_shapes not in ("exact", "bucket"):
            raise ValueError("batch_shapes must be exact|bucket")
        if self.warp_loop not in ("vmap", "scan"):
            raise ValueError("warp_loop must be vmap|scan")
        if self.warp_sampling not in ("shift", "gather"):
            raise ValueError("warp_sampling must be shift|gather")
        self.layer_buckets = tuple(sorted(int(b) for b in
                                          self.layer_buckets))
        if any(b < 2 for b in self.layer_buckets):
            raise ValueError("layer buckets must be >= 2")
        rungs = []
        for rung in self.degrade_rungs:
            d, r = int(rung[0]), int(rung[1])
            m = rung[2] if len(rung) > 2 else None
            if d < 0 or r < 1:
                raise ValueError("degrade rungs must be (iteration_delta"
                                 ">=0, res_divisor>=1[, model])")
            if m is not None:
                from mpv_frame_interpolator import models as _models
                _models.validate(m)
            rungs.append((d, r, m))
        self.degrade_rungs = tuple(rungs)


class OutputFrame:
    """A produced frame; planes may live on device until materialized.

    Warped outputs of one source pair share a single batched device array
    (one dispatch for all blend positions); `index` selects this frame's
    slice lazily."""

    __slots__ = ("pts", "fmt", "_y", "_uv", "_host", "_index")

    def __init__(self, pts: float, fmt: FrameFormat, y, uv, host: bool,
                 index: Optional[int] = None):
        self.pts = pts
        self.fmt = fmt
        self._y = y
        self._uv = uv
        self._host = host
        self._index = index

    def block(self):
        if not self._host:
            jax.block_until_ready(self._uv)
        return self

    def device_planes(self):
        """(y, uv) as device (or host) arrays for zero-copy consumers."""
        if self._index is None:
            return self._y, self._uv
        return self._y[self._index], self._uv[self._index]

    def to_video_frame(self) -> VideoFrame:
        y, uv = self.device_planes()
        return VideoFrame(np.asarray(y), np.asarray(uv), self.fmt,
                          pts=self.pts)


_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def _bucket_size(n: int) -> int:
    """Smallest 1.5x-step bucket >= n (batch_shapes='bucket')."""
    for b in _BUCKETS:
        if b >= n:
            return b
    return n


@dataclasses.dataclass
class _DeviceFrame:
    """Device-resident source frame: luma + INTERLEAVED chroma.  The
    u/v split happens inside the fused program (one traced slice each,
    fused by XLA) -- splitting on the host costs two extra device
    dispatches per frame."""
    y: jax.Array
    uv: jax.Array


def _flow_stage(geom, scale_shift, scene_enabled, model,
                f1y, f1u, f1v, f2y, f2u, f2v, radius, ds, nbs,
                scene_threshold, subpel: bool = False, layers: int = None):
    """Traced flow half of a source pair: scene score + hierarchical flow.
    Returns (blurred flow, frac or None, cut_score).  `frac` is the
    1/64-pel refinement field when subpel_flow is enabled for a bilinear
    family (ops/flow.subpel_refine), else None.  `layers` is the static
    layer count of this program variant (the bucket; see
    EngineConfig.layer_buckets) -- the traced radius must be <= layers."""
    from mpv_frame_interpolator.ops.flow import (
        _flow_impl, _subsampled_f2, subpel_refine)
    from mpv_frame_interpolator.ops.oracle import MAX_SEARCH_RADIUS
    if layers is None:
        layers = MAX_SEARCH_RADIUS
    if scene_enabled:
        cut_score = scene_mod.cut_score(f1y, f2y, geom.res_scalar,
                                        scale_shift)
    else:
        cut_score = jnp.float32(0.0)

    frac = None
    if model in ("hopper", "hopperx", "hopperq", "hopperxq"):
        offset, blurred = _flow_impl(geom, radius, scale_shift,
                                     f1y, f1u, f1v, f2y, f2u, f2v,
                                     ds, nbs, layers=layers)
        if subpel:
            # refine the UNBLURRED committed flow -- that's the SAD argmin
            # where a 3x3 quadratic fit is meaningful -- then blur the
            # combined 1/64-pel field, so the box blur averages with
            # fractional precision instead of truncating to whole pels.
            from mpv_frame_interpolator.ops.flow import blur_flow
            frac_raw = subpel_refine(geom, offset, f1y, f1u, f1v,
                                     _subsampled_f2(geom, f2y, f2u, f2v),
                                     luma_shift=scale_shift)
            b64 = blur_flow((offset << 6) + frac_raw,
                            geom.low_h, geom.low_w)
            if model in ("hopperq", "hopperxq"):
                blurred = b64 >> 6             # floor decomposition
                frac = b64 - (blurred << 6)    # in [0, 63]
            else:
                # integer families sample at whole pels; the fractional
                # measurement still helps as round-to-nearest (the plain
                # path is a floor-of-integer-blur; measured +0.3..+3.3 dB
                # on non-uniform motion, tests/test_subpel.py)
                blurred = (b64 + 32) >> 6
    else:
        # blend / repeat families: null flow field (models/__init__.py)
        blurred = jnp.zeros((2, geom.low_h, geom.low_w), jnp.int32)
    return blurred, frac, cut_score


def _warp_stage(geom, mode, scale_shift, cut_policy, scene_enabled, model,
                f1y, f1u, f1v, f2y, f2u, f2v, blurred, cut_score, ts,
                black, white, scene_threshold, warp_loop: str = "vmap",
                frac=None, warp_sampling: str = "shift"):
    """Traced warp half: scene-cut folding + N batched warps + NV12
    re-interleave.  Returns (y batch, uv batch).

    warp_loop="scan" expresses the blend axis as lax.map (scan): the warp
    body is traced/compiled once per program instead of unrolled N times,
    so cold-start compile time stops scaling with the output batch size.
    Outputs are bit-identical (same ops per position, no cross-position
    math).

    warp_sampling="shift" (default) uses the shift-decomposed sampler for
    the nearest families (ops/warp._sample_all_planes: exact; slices and
    selects instead of per-pixel gathers).  It FORCES the lax.map loop:
    vmapping its dynamic slices would lower them back into gathers."""
    dtype = jnp.uint16 if scale_shift else jnp.uint8
    if scene_enabled:
        cut = cut_score > scene_threshold
    else:
        cut = jnp.asarray(False)

    blurred_w = jnp.where(cut, jnp.zeros_like(blurred), blurred)
    if frac is not None:
        frac = jnp.where(cut, jnp.zeros_like(frac), frac)
    if cut_policy == "nearest":
        ts_cut = jnp.where(ts >= 0.5, 1.0, 0.0).astype(jnp.float32)
    else:  # hold the previous frame
        ts_cut = jnp.zeros_like(ts)
    ts_w = jnp.where(cut, ts_cut, ts)
    if model == "repeat":
        # nearest-source snap at every position (cadence without
        # interpolation -- what a plain player displays)
        ts_w = jnp.where(ts_w >= 0.5, 1.0, 0.0).astype(jnp.float32)

    bilinear = model in ("hopperq", "hopperxq")
    shiftlike = warp_sampling == "shift"
    shift_active = (shiftlike and not bilinear and mode in (0, 1, 2, 3))
    # bilinear families ride the 1/64-pel shift sampler (ops/warp.
    # _bilinear_all_planes) except under measured sub-pel flow, whose
    # per-pixel refinement defeats the few-distinct-values structure
    bshift_active = (shiftlike and bilinear
                     and mode == warp_ops.BLENDED_FRAME and frac is None)
    loop = jax.lax.map if (warp_loop == "scan" or shift_active
                           or bshift_active) else (
        lambda f, xs: jax.vmap(f)(xs))
    if mode in (warp_ops.SIDE_BY_SIDE_1, warp_ops.SIDE_BY_SIDE_2):
        def one(t):
            return warp_ops._warp_impl(
                geom, mode, scale_shift, dtype,
                f1y, f1u, f1v, f2y, f2u, f2v, blurred_w, t, black, white)
        y, u, v = loop(one, ts_w)
    else:
        # lean fields: the shift hot paths never read the 8 full-res
        # upsampled flow planes (their gather fallbacks rebuild them
        # lazily inside the runtime cond); building them per pair was
        # pure prep cost.  GREY/HSV and plain-gather sampling still get
        # them eagerly.
        lean = ((shift_active or bshift_active)
                and mode in (warp_ops.WARPED_FRAME_12,
                             warp_ops.WARPED_FRAME_21,
                             warp_ops.BLENDED_FRAME)
                and frac is None)
        fields = warp_ops._warp_fields(geom, blurred_w, frac,
                                       full_res=not lean)
        if shift_active or bshift_active:
            # t-independent sampler prep (padded sources + distinct flow
            # tables + index fields) hoisted out of the per-position
            # loop: ONE extraction and padding serves every output
            fields["SPREP"] = warp_ops._sampler_prep(
                geom, fields, f1y, f1u, f1v, f2y, f2u, f2v,
                bilinear=bilinear)

        def one(t):
            return warp_ops._warp_sample(
                geom, mode, scale_shift, dtype,
                f1y, f1u, f1v, f2y, f2u, f2v, fields, t, black, white,
                occlusion_aware=(model in ("hopperx", "hopperxq")),
                bilinear=bilinear,
                sampling=warp_sampling if (shift_active or bshift_active)
                else "gather")
        y, u, v = loop(one, ts_w)
    n, hc, wc = u.shape
    uv = jnp.stack((u, v), axis=3).reshape(n, hc, wc * 2)
    return y, uv


@functools.lru_cache(maxsize=128)
def _make_source_step(geom: FlowGeometry, mode: int,
                      scale_shift: int, cut_policy: str,
                      scene_enabled: bool, model: str = "hopper",
                      warp_loop: str = "vmap", subpel: bool = False,
                      warp_sampling: str = "shift", layers: int = None):
    """ONE fused device dispatch per source pair: scene-cut score ->
    hierarchical flow -> N batched warps -> NV12 re-interleave.

    The reference issues ~2*log2(win)*3+1 flow launches plus 2 warp
    launches per output frame plus blocking copies (SURVEY.md §3.2); here
    the whole source-pair computation is a single XLA program, so host/
    dispatch overhead is paid once and XLA fuses across stage boundaries.

    The search radius is traced (masked layers, ops/flow.py), so the
    quality controller's radius changes never recompile."""

    def source_step(f1y, f1uv, f2y, f2uv, ts, radius, ds, nbs, black,
                    white, scene_threshold):
        f1u, f1v = _deint(f1uv)
        f2u, f2v = _deint(f2uv)
        blurred, frac, cut_score = _flow_stage(
            geom, scale_shift, scene_enabled, model,
            f1y, f1u, f1v, f2y, f2u, f2v, radius, ds, nbs, scene_threshold,
            subpel, layers)
        y, uv = _warp_stage(
            geom, mode, scale_shift, cut_policy, scene_enabled, model,
            f1y, f1u, f1v, f2y, f2u, f2v, blurred, cut_score, ts,
            black, white, scene_threshold, warp_loop, frac, warp_sampling)
        return y, uv, blurred, cut_score

    return jax.jit(source_step)


@functools.lru_cache(maxsize=64)
def _make_group_step(geom: FlowGeometry, mode: int, scale_shift: int,
                     cut_policy: str, scene_enabled: bool, model: str,
                     warp_loop: str, subpel: bool, warp_sampling: str,
                     layers: int):
    """K source pairs in ONE device program (engine.push_many).

    The per-pair work is the exact traced body of _make_source_step,
    expressed as lax.scan over the stacked pair axis: one enqueue and
    one in-order queue entry for K pairs -- the grouped analog of the
    reference's async in-order queue, which pays ~0 host time between
    kernels (opticalFlowCalc.c:96-124).  K and the padded output count
    are shape-specialized by jit.

    scan (not vmap): the shift-decomposed samplers lower to dynamic
    slices that vmap would re-lower into gathers; scan keeps each
    pair's slices as slices."""

    def group_step(f1y, f1uv, f2y, f2uv, ts, radius, ds, nbs, black,
                   white, scene_threshold):
        def body(carry, xs):
            a_y, a_uv, b_y, b_uv, t = xs
            f1u, f1v = _deint(a_uv)
            f2u, f2v = _deint(b_uv)
            blurred, frac, cut_score = _flow_stage(
                geom, scale_shift, scene_enabled, model,
                a_y, f1u, f1v, b_y, f2u, f2v, radius, ds, nbs,
                scene_threshold, subpel, layers)
            y, uv = _warp_stage(
                geom, mode, scale_shift, cut_policy, scene_enabled, model,
                a_y, f1u, f1v, b_y, f2u, f2v, blurred, cut_score, t,
                black, white, scene_threshold, warp_loop, frac,
                warp_sampling)
            return carry, (y, uv, blurred, cut_score)

        _, (ys, uvs, blurs, cuts) = jax.lax.scan(
            body, jnp.int32(0), (f1y, f1uv, f2y, f2uv, ts))
        return ys, uvs, blurs, cuts

    return jax.jit(group_step)


@functools.lru_cache(maxsize=32)
def _make_flow_step(geom: FlowGeometry, scale_shift: int,
                    scene_enabled: bool, model: str,
                    subpel: bool = False, layers: int = None):
    """Flow-only program for split-timing (opticalFlowCalc.c:111-122
    OFC-event analog).  Same traced code as the fused step's first half.
    Returns (blurred, frac-or-None, cut_score)."""
    def flow_step(f1y, f1uv, f2y, f2uv, radius, ds, nbs, scene_threshold):
        f1u, f1v = _deint(f1uv)
        f2u, f2v = _deint(f2uv)
        return _flow_stage(geom, scale_shift, scene_enabled, model,
                           f1y, f1u, f1v, f2y, f2u, f2v,
                           radius, ds, nbs, scene_threshold, subpel,
                           layers)
    return jax.jit(flow_step)


@functools.lru_cache(maxsize=64)
def _make_warp_step(geom: FlowGeometry, mode: int, scale_shift: int,
                    cut_policy: str, scene_enabled: bool, model: str,
                    warp_loop: str = "vmap", warp_sampling: str = "shift"):
    """Warp-only program for split-timing (opticalFlowCalc.c:192-201
    warp-event analog).  Same traced code as the fused step's second half.
    `frac` is the subpel field or None (None is a valid jit pytree)."""
    def warp_step(f1y, f1uv, f2y, f2uv, blurred, frac, cut_score, ts,
                  black, white, scene_threshold):
        f1u, f1v = _deint(f1uv)
        f2u, f2v = _deint(f2uv)
        return _warp_stage(geom, mode, scale_shift, cut_policy,
                           scene_enabled, model, f1y, f1u, f1v, f2y, f2u,
                           f2v, blurred, cut_score, ts, black, white,
                           scene_threshold, warp_loop, frac, warp_sampling)
    return jax.jit(warp_step)


class InterpolationEngine:
    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        from mpv_frame_interpolator import models as _models
        _models.validate(self.config.model)
        self.cadence = CadenceEngine(self.config.display_fps,
                                     self.config.playback_speed)
        self.quality = QualityController(
            enabled=self.config.auto_quality,
            search_radius=self.config.initial_search_radius,
            too_slow_patience=self.config.too_slow_patience,
            max_level=len(self.config.degrade_rungs))
        self.quality.rung_warm = self._rung_warm
        self.scene = SceneChangeDetector(
            enabled=self.config.scene_detection,
            threshold=self.config.scene_threshold)
        self.stats = StatsRegistry()
        self.frame_output_mode = self.config.frame_output_mode
        self.black_level = self.config.black_level
        self.white_level = self.config.white_level
        self.delta_scalar = self.config.delta_scalar
        self.neighbor_bias_scalar = self.config.neighbor_bias_scalar

        self.geom: Optional[FlowGeometry] = None
        self._geoms: List[FlowGeometry] = []   # [level 0, rung 1, ...]
        self._level_models: List[str] = []     # model family per level
        self._rung_ready = {0}                 # levels with warm programs
        self._scale_shift = 0
        self._fmt: Optional[FrameFormat] = None
        self._prev: Optional[_DeviceFrame] = None
        self._cur: Optional[_DeviceFrame] = None
        self._last_calc_duration = 0.0
        self._blurred = None
        self._last_cut_score = None
        self._warm = set()           # (radius, mode) specializations executed
        # split flow/warp telemetry state (see EngineConfig.split_timing)
        self._split_wanted = self.config.split_timing == "always"
        self._split_cache = {}   # (radius, mode, n, model) -> (flow, warp)
        self._bg_started = False
        self._bg_active = False
        self._scalar_cache = {}
        self._ts_cache = {}
        if self.config.compile_cache:
            from mpv_frame_interpolator.utils.compile_cache import (
                enable_compile_cache)
            enable_compile_cache()

    # ------------------------------------------------------------------ #

    def set_speed(self, speed: float):
        self.cadence.set_speed(speed)

    def reset(self):
        """Seek reset (vf_HopperRender.c:562-567): counters only; device
        buffers are re-anchored by the next two source frames."""
        self.cadence.reset()
        self._prev = None
        self._cur = None

    def _ensure_geometry(self, frame: VideoFrame):
        fmt = frame.fmt
        if self._fmt is not None and (fmt.height, fmt.stride, fmt.width,
                                      fmt.pixfmt) == (
                self._fmt.height, self._fmt.stride, self._fmt.width,
                self._fmt.pixfmt):
            return
        # lazy init, like vf_HopperRender.c:445-447
        self.geom = FlowGeometry.create(fmt.height, fmt.stride, fmt.width,
                                        self.config.max_calc_res,
                                        self.config.num_iterations)
        self._geoms = [self.geom]
        self._level_models = [self.config.model]
        for d_iter, res_div, model in self.config.degrade_rungs:
            self._geoms.append(FlowGeometry.create(
                fmt.height, fmt.stride, fmt.width,
                max(self.config.max_calc_res // res_div, 64),
                max(self.geom.iterations - d_iter, 1)))
            self._level_models.append(model or self.config.model)
        self._rung_ready = {0}
        self._scale_shift = 0 if fmt.pixfmt == NV12 else 8
        self._fmt = fmt
        self._prev = None
        self._cur = None
        self._warm = set()
        self._bg_started = False
        self.cadence.reset()
        log.info("flow geometry: %s (pixfmt=%s)", self.geom, fmt.pixfmt)
        if self.config.precompile:
            self._precompile()

    def _rung_warm(self, level: int) -> bool:
        """Gate for QualityController ladder steps: a rung may be entered
        only once its programs are compiled (the background-precompile
        thread warms every rung right after the layer buckets), so a
        degradation step never trades an over-budget frame for a
        multi-second jit stall.  Without the background thread (tests,
        precompile=True setups) stepping compiles synchronously."""
        if not self.config.background_precompile:
            return True
        return level in self._rung_ready

    def _active_level(self) -> int:
        """The degradation level this push runs: the controller's level,
        demoted to the nearest lower level whose program is warm (level 0
        is warm after the first pair by construction)."""
        level = self.quality.level
        while level > 0 and not self._rung_warm(level):
            level -= 1
        return level

    def _layers_for(self, radius: int) -> int:
        """Static layer count (compiled variant) serving `radius`: the
        smallest configured bucket >= radius (EngineConfig.layer_buckets).
        Radius stays traced within the bucket."""
        from mpv_frame_interpolator.ops.oracle import MAX_SEARCH_RADIUS
        for b in self.config.layer_buckets:
            if b >= radius:
                return b
        return max(radius, MAX_SEARCH_RADIUS)

    def _plausible_batch_sizes(self):
        """Batch sizes the current display/source ratio can produce."""
        ratio = max(self.cadence.target_frame_time
                    / self.cadence.source_frame_time, 1e-6)
        base_n = max(int(np.ceil(1.0 / ratio)), 1)
        return {1, base_n, max(base_n - 1, 1), base_n + 1}

    def _warm_batch_sizes(self, sizes, layers: int = None,
                          level: int = 0) -> int:
        """Execute the fused step once per still-cold batch size (zeros
        input): populates the jit + persistent compile caches.  `layers`
        selects the flow layer bucket to warm (default: the bucket the
        current radius runs); `level` the degradation-ladder rung."""
        h, w = self.geom.height, self.geom.stride
        geom = self._geoms[level]
        model = self._level_models[level]
        if layers is None:
            layers = self._layers_for(self.quality.search_radius)
        dt = np.uint16 if self._scale_shift else np.uint8
        zy = jnp.zeros((h, w), dt)
        zuv = jnp.zeros((h // 2, w), dt)
        step = _make_source_step(geom, self.frame_output_mode,
                                 self._scale_shift, self.config.cut_policy,
                                 self.scene.enabled, model,
                                 self.config.warp_loop,
                                 self.config.subpel_flow,
                                 self.config.warp_sampling, layers)
        warmed = 0
        if self.config.batch_shapes == "bucket":
            sizes = {_bucket_size(n) for n in sizes}
        aborted = False
        for n in sorted(sizes):
            if _warm_shutdown is not None and _warm_shutdown.is_set():
                aborted = True
                break
            spec = (self.frame_output_mode, n, model, layers, level)
            if spec in self._warm:
                continue
            out = step(zy, zuv, zy, zuv,
                       jnp.zeros((n,), jnp.float32),
                       jnp.int32(min(self.quality.search_radius, layers)),
                       jnp.int32(8), jnp.int32(6),
                       jnp.float32(0.0), jnp.float32(255.0),
                       jnp.float32(self.scene.threshold))
            jax.block_until_ready(out[0])
            self._warm.add(spec)
            warmed += 1
        if not aborted:
            self._rung_ready.add(level)
        return warmed

    def _precompile(self):
        """Compile the plausible batch-size specializations up front so the
        quality controller never observes compile time (the reference
        builds its kernels once at init, opticalFlowCalc.c:404-408).  The
        search radius is traced within a bucket, so (batch size x layer
        bucket) covers every radius the controller can pick."""
        t0 = time.perf_counter()
        sizes = self._plausible_batch_sizes()
        n = self._warm_batch_sizes(sizes)
        for b in self.config.layer_buckets:
            n += self._warm_batch_sizes(sizes, layers=b)
        # degradation rungs run at the floor radius -> smallest bucket
        floor_layers = self._layers_for(self.quality.min_radius)
        for lvl in range(1, len(self._geoms)):
            n += self._warm_batch_sizes(sizes, layers=floor_layers,
                                        level=lvl)
        log.info("precompiled %d batch-size/bucket specs (all radii "
                 "shared) in %.1fs", n, time.perf_counter() - t0)

    def _start_background_precompile(self):
        """After the first frame is delivered, warm the REMAINING batch
        sizes on a daemon thread so a cold cache stalls playback once, not
        once per batch size.  Timing measurements taken while this runs
        are discarded (push checks _bg_active)."""
        if (self._bg_started or not self.config.background_precompile
                or self.geom is None):
            return
        self._bg_started = True
        import threading

        def work():
            self._bg_active = True
            try:
                t0 = time.perf_counter()
                n = self._warm_batch_sizes(self._plausible_batch_sizes())
                # then the OTHER layer buckets, so the quality
                # controller's bucket changes never stall playback either
                cur = self._layers_for(self.quality.search_radius)
                for b in self.config.layer_buckets:
                    if b != cur:
                        n += self._warm_batch_sizes(
                            self._plausible_batch_sizes(), layers=b)
                # then the degradation rungs (run at the floor radius ->
                # smallest bucket), so the controller's ladder steps
                # (gated on _rung_warm) become available without ever
                # stalling playback on a compile
                floor_layers = self._layers_for(self.quality.min_radius)
                for lvl in range(1, len(self._geoms)):
                    n += self._warm_batch_sizes(
                        self._plausible_batch_sizes(),
                        layers=floor_layers, level=lvl)
                if n:
                    log.info("background-precompiled %d batch-size/bucket "
                             "specs in %.1fs", n, time.perf_counter() - t0)
            except Exception:   # never kill playback from the warm thread
                log.exception("background precompile failed")
            finally:
                self._bg_active = False

        t = threading.Thread(target=work, daemon=True)
        _register_warm_thread(t)
        t.start()

    def stage(self, frame: VideoFrame) -> VideoFrame:
        """Start the async host->HBM copy for a frame and return a frame
        whose planes are device arrays (BASELINE config #3: double-buffered
        async uploads -- the reference blocks in clEnqueueWriteBuffer,
        opticalFlowCalc.c:98-100).  jax.device_put returns immediately; the
        transfer overlaps compute.  Call from a reader thread (the
        pipeline's prefetcher does) so even the enqueue cost is off the
        critical path.

        Frames carrying a `recycle` hook (native ingest, io/ingest.py) get
        their host buffers returned to the source pool once the device
        copy has completed -- the blocking wait runs on the reader thread,
        off the critical path, and keeps steady-state ingest allocation-
        free (mp_image_pool recycling analog)."""
        import dataclasses
        if isinstance(frame.y, jax.Array):
            return frame
        y = jax.device_put(frame.y)
        uv = jax.device_put(frame.uv)
        if frame.recycle is not None:
            jax.block_until_ready(y)
            jax.block_until_ready(uv)
            frame.recycle()
        return dataclasses.replace(frame, y=y, uv=uv, recycle=None)

    def _upload(self, frame: VideoFrame) -> _DeviceFrame:
        return _DeviceFrame(jnp.asarray(frame.y), jnp.asarray(frame.uv))

    def _dev_scalar(self, name: str, value, ctor):
        """Cached device scalar: knobs change rarely, so re-uploading them
        every push wastes a host->device dispatch each."""
        ent = self._scalar_cache.get(name)
        if ent is None or ent[0] != value:
            ent = (value, ctor(value))
            self._scalar_cache[name] = ent
        return ent[1]

    def _ts_for(self, blends: tuple) -> jax.Array:
        """Cached device blend vector, keyed by VALUE.  Fixed-rate
        cadences alternate between a few blend tuples (24->60: two; a
        24->120 transfer: one), so steady-state pushes reuse a staged
        array instead of paying a per-push host->device transfer.  VFR
        sources with ever-changing tuples bound the cache by eviction."""
        dev = self._ts_cache.get(blends)
        if dev is None:
            if len(self._ts_cache) >= 64:
                self._ts_cache.pop(next(iter(self._ts_cache)))
            dev = jnp.asarray(blends, jnp.float32)
            self._ts_cache[blends] = dev
        return dev

    def _out_fmt(self) -> FrameFormat:
        # colorimetry passes through untouched (mp_image_copy_attributes
        # analog, video/mp_image.c:538)
        return FrameFormat(self.geom.actual_width, self.geom.height,
                           self._fmt.pixfmt,
                           primaries=self._fmt.primaries,
                           transfer=self._fmt.transfer,
                           matrix=self._fmt.matrix)

    # ------------------------------------------------------------------ #

    def push(self, frame: VideoFrame) -> List[OutputFrame]:
        """Process one source frame; returns the output frames due."""
        self._ensure_geometry(frame)
        sbs2 = self.frame_output_mode == warp_ops.SIDE_BY_SIDE_2
        plan = self.cadence.on_source_frame(frame.pts, frame.nominal_fps,
                                            first_frame_interpolates=sbs2)
        if plan.inconsistent_detected:
            log.warning("Inconsistent frame timings detected. Using less "
                        "accurate frame timing method to maintain A/V sync.")

        if plan.passthrough:
            if self.cadence.state == InterpolationState.ACTIVE \
                    and self.cadence.source_frame_num == 1:
                # first frame: keep it as the flow anchor
                self._prev = self._cur
                self._cur = self._upload(frame)
            return [OutputFrame(frame.pts, frame.fmt, frame.y, frame.uv,
                                host=True)]

        # quality controller runs on the previous frame's measured duration
        # (ordering per vf_HopperRender.c:484 before the new calc)
        self.quality.update(self._last_calc_duration, self.cadence)

        n_out = len(plan.outputs)
        n_batch = (_bucket_size(n_out)
                   if self.config.batch_shapes == "bucket" else n_out)
        layers = self._layers_for(self.quality.search_radius)
        level = self._active_level()
        geom = self._geoms[level]
        model = self._level_models[level]
        spec_key = (self.frame_output_mode, n_batch, model, layers, level)
        if spec_key not in self._warm and self.config.background_precompile:
            # the wanted bucket isn't compiled yet: serve this pair from a
            # LARGER warm bucket (always valid -- layers >= radius -- and
            # bit-identical, tests/test_layer_buckets.py) instead of
            # stalling playback on a compile; the background thread warms
            # the wanted bucket (vd_lavc would rather show a frame late
            # than never)
            for b in self.config.layer_buckets:
                if b > layers and (self.frame_output_mode, n_batch,
                                   model, b, level) in self._warm:
                    layers = b
                    spec_key = (self.frame_output_mode, n_batch,
                                model, b, level)
                    break
        was_warm = spec_key in self._warm

        t0 = time.perf_counter()
        self._prev = self._cur
        self._cur = self._upload(frame)
        f1, f2 = self._prev, self._cur
        if f1 is None:
            # first-frame interpolation (SideBySide2): pair with itself
            f1 = f2

        out_fmt = self._out_fmt()
        blends = [slot.blend for slot in plan.outputs]
        if n_batch > n_out:
            # padded warp slots (batch_shapes="bucket"): computed, unused
            blends += [blends[-1]] * (n_batch - n_out)
        # device-cache the blend vector by VALUE: fixed-rate cadences
        # cycle through a handful of blend tuples, and a fresh
        # jnp.asarray here would enqueue one host->device transfer per
        # push that the in-order device queue must wait on
        # (tools/gap_reconcile.py measures the cost: raw-ts vs raw-const)
        ts = self._ts_for(tuple(blends))
        args = (f1.y, f1.uv, f2.y, f2.uv)
        knobs = (self._dev_scalar("radius", self.quality.search_radius,
                                  jnp.int32),
                 self._dev_scalar("ds", self.delta_scalar, jnp.int32),
                 self._dev_scalar("nbs", self.neighbor_bias_scalar,
                                  jnp.int32))
        levels = (self._dev_scalar("black", self.black_level, jnp.float32),
                  self._dev_scalar("white", self.white_level, jnp.float32))
        thr = self._dev_scalar("thr", self.scene.threshold, jnp.float32)

        if self.config.split_timing == "always":
            # reference-authentic two-dispatch mode: flow and warp are
            # separate programs, each timed by a device sync
            # (opticalFlowCalc.c:111-122,192-201)
            y, uv, blurred, cut_score, dur = self._push_split(
                args, knobs, levels, thr, ts, was_warm, len(plan.outputs),
                geom)
        else:
            step = _make_source_step(
                geom, self.frame_output_mode, self._scale_shift,
                self.config.cut_policy, self.scene.enabled,
                model, self.config.warp_loop, self.config.subpel_flow,
                self.config.warp_sampling, layers)
            y, uv, blurred, cut_score = step(*args, ts, *knobs, *levels,
                                             thr)
            dur = None
        self._blurred = blurred
        self._last_cut_score = cut_score
        outputs: List[OutputFrame] = [
            OutputFrame(slot.pts, out_fmt, y, uv, host=False, index=i)
            for i, slot in enumerate(plan.outputs)]

        if self.config.measure_timing and outputs:
            if dur is None:
                outputs[-1].block()
                dur = time.perf_counter() - t0
            if was_warm and not self._bg_active:
                self._last_calc_duration = dur
                self._log_duration(dur)
                if self.config.split_timing == "auto" and self._split_wanted:
                    split_spec = (self.quality.search_radius,
                                  self.frame_output_mode, len(outputs),
                                  self.config.model)
                    cached = self._split_cache.get(split_spec)
                    if cached is None:
                        self._calibrate_split(args, knobs, levels, thr, ts,
                                              split_spec, len(outputs))
                    else:
                        # republish so telemetry tracks the live spec
                        self._record_split(*cached, len(outputs))
            else:
                # compile happened inside: not a compute-time measurement
                self._last_calc_duration = 0.0
            self.stats.add("outputs", len(outputs))
        self._warm.add(spec_key)
        self._start_background_precompile()
        return outputs

    # -- grouped dispatch (transcode/serving path) ------------------------

    _GROUP_BUCKETS = (8, 4, 2, 1)

    def push_many(self, frames, group_size: int = 8) -> List[OutputFrame]:
        """Process many source frames with pair-GROUPED dispatch: the
        outputs of push(f) for every frame (same pts, bit-identical
        planes -- tests/test_push_many.py), but interpolating pairs ride
        ONE fused device program per group of up to `group_size`
        (``_make_group_step``), so per-dispatch host overhead is
        paid once per group instead of once per pair.

        This is the throughput path for transcode/serving, the analog of
        the reference's async in-order queue that pays ~0 host time
        between kernels (opticalFlowCalc.c:96-124,388-391).  Realtime
        playback keeps push(): a group adds up to group_size source
        intervals of latency.

        Groups are chunked to the static sizes in _GROUP_BUCKETS (each is
        one compiled variant); pairs whose output counts differ within a
        group are padded to the group maximum (padded warps computed,
        never emitted).  The quality controller is updated once per
        group; with measure_timing the grouped duration is divided by the
        group's pair count."""
        outputs: List[OutputFrame] = []
        pending = []    # (f1, f2, blends, slots) awaiting grouped dispatch
        sbs2 = self.frame_output_mode == warp_ops.SIDE_BY_SIDE_2
        for frame in frames:
            if pending and self._fmt is not None and (
                    frame.fmt.height, frame.fmt.stride, frame.fmt.width,
                    frame.fmt.pixfmt) != (
                    self._fmt.height, self._fmt.stride, self._fmt.width,
                    self._fmt.pixfmt):
                # geometry switch resets engine state: drain the old
                # geometry's pairs first
                self._flush_group(pending, outputs, group_size)
            self._ensure_geometry(frame)
            plan = self.cadence.on_source_frame(
                frame.pts, frame.nominal_fps, first_frame_interpolates=sbs2)
            if plan.inconsistent_detected:
                log.warning("Inconsistent frame timings detected. Using "
                            "less accurate frame timing method to maintain "
                            "A/V sync.")
            if plan.passthrough:
                # emit in stream order: queued pairs precede this frame
                self._flush_group(pending, outputs, group_size)
                if self.cadence.state == InterpolationState.ACTIVE \
                        and self.cadence.source_frame_num == 1:
                    self._prev = self._cur
                    self._cur = self._upload(frame)
                outputs.append(OutputFrame(frame.pts, frame.fmt, frame.y,
                                           frame.uv, host=True))
                continue
            self._prev = self._cur
            self._cur = self._upload(frame)
            f1 = self._prev if self._prev is not None else self._cur
            pending.append((f1, self._cur,
                            [slot.blend for slot in plan.outputs],
                            plan.outputs))
            if len(pending) >= group_size:
                self._flush_group(pending, outputs, group_size)
        self._flush_group(pending, outputs, group_size)
        return outputs

    def _flush_group(self, pending, outputs, group_size: int):
        while pending:
            k = next(b for b in self._GROUP_BUCKETS
                     if b <= len(pending) and b <= max(group_size, 1))
            chunk = pending[:k]
            del pending[:k]
            outputs.extend(self._dispatch_group(chunk))

    def _dispatch_group(self, chunk) -> List[OutputFrame]:
        # controller ordering mirrors push(): previous measurement first
        self.quality.update(self._last_calc_duration, self.cadence)
        k = len(chunk)
        n_out_max = max(len(blends) for _, _, blends, _ in chunk)
        n_batch = (_bucket_size(n_out_max)
                   if self.config.batch_shapes == "bucket" else n_out_max)
        layers = self._layers_for(self.quality.search_radius)
        level = self._active_level()
        geom = self._geoms[level]
        model = self._level_models[level]
        spec_key = ("group", self.frame_output_mode, k, n_batch,
                    model, layers, level)
        was_warm = spec_key in self._warm

        t0 = time.perf_counter()
        padded = tuple(
            tuple(blends) + (blends[-1],) * (n_batch - len(blends))
            for _, _, blends, _ in chunk)
        ts = self._ts_for(padded)
        f1y = jnp.stack([c[0].y for c in chunk])
        f1uv = jnp.stack([c[0].uv for c in chunk])
        f2y = jnp.stack([c[1].y for c in chunk])
        f2uv = jnp.stack([c[1].uv for c in chunk])
        knobs = (self._dev_scalar("radius", self.quality.search_radius,
                                  jnp.int32),
                 self._dev_scalar("ds", self.delta_scalar, jnp.int32),
                 self._dev_scalar("nbs", self.neighbor_bias_scalar,
                                  jnp.int32))
        levels = (self._dev_scalar("black", self.black_level, jnp.float32),
                  self._dev_scalar("white", self.white_level, jnp.float32))
        thr = self._dev_scalar("thr", self.scene.threshold, jnp.float32)
        step = _make_group_step(geom, self.frame_output_mode,
                                self._scale_shift, self.config.cut_policy,
                                self.scene.enabled, model,
                                self.config.warp_loop,
                                self.config.subpel_flow,
                                self.config.warp_sampling, layers)
        ys, uvs, blurs, cuts = step(f1y, f1uv, f2y, f2uv, ts, *knobs,
                                    *levels, thr)
        self._blurred = blurs[k - 1]
        self._last_cut_score = cuts[k - 1]
        out_fmt = self._out_fmt()
        out: List[OutputFrame] = []
        for j, (_, _, _, slots) in enumerate(chunk):
            for i, slot in enumerate(slots):
                out.append(OutputFrame(slot.pts, out_fmt, ys, uvs,
                                       host=False, index=(j, i)))
        if self.config.measure_timing and out:
            out[-1].block()
            dur = (time.perf_counter() - t0) / k
            if was_warm and not self._bg_active:
                self._last_calc_duration = dur
                self._log_duration(dur)
            else:
                self._last_calc_duration = 0.0
            self.stats.add("outputs", len(out))
        self._warm.add(spec_key)
        return out

    def _log_duration(self, dur: float):
        self.stats.add("source_frame_time", dur)
        if self.config.stats_log_path:
            with open(self.config.stats_log_path, "a") as fh:
                fh.write(f"{dur:.6f}\n")

    # -- split flow/warp timing (see EngineConfig.split_timing) ----------

    def request_split_timing(self):
        """Called by telemetry consumers (applet, ofc-time/warp-time
        properties): enables the once-per-spec split calibration."""
        self._split_wanted = True

    def _split_fns(self, geom=None):
        geom = geom or self.geom
        flow_fn = _make_flow_step(geom, self._scale_shift,
                                  self.scene.enabled, self.config.model,
                                  self.config.subpel_flow,
                                  self._layers_for(
                                      self.quality.search_radius))
        warp_fn = _make_warp_step(geom, self.frame_output_mode,
                                  self._scale_shift, self.config.cut_policy,
                                  self.scene.enabled, self.config.model,
                                  self.config.warp_loop,
                                  self.config.warp_sampling)
        return flow_fn, warp_fn

    def _record_split(self, flow_t: float, warp_t: float, n_outputs: int):
        self.stats.add("flow_time", flow_t)
        self.stats.add("warp_total", warp_t)
        self.stats.add("warp_time", warp_t / max(n_outputs, 1))

    def _push_split(self, args, knobs, levels, thr, ts, was_warm: bool,
                    n_outputs: int, geom=None):
        flow_fn, warp_fn = self._split_fns(geom)
        t0 = time.perf_counter()
        blurred, frac, cut_score = flow_fn(*args, *knobs, thr)
        jax.block_until_ready(blurred)
        t1 = time.perf_counter()
        y, uv = warp_fn(*args, blurred, frac, cut_score, ts, *levels, thr)
        jax.block_until_ready(uv)
        t2 = time.perf_counter()
        if was_warm:
            self._record_split(t1 - t0, t2 - t1, n_outputs)
        return y, uv, blurred, cut_score, t2 - t0

    def _calibrate_split(self, args, knobs, levels, thr, ts, split_spec,
                         n_outputs: int):
        """Measure the flow/warp split once for the current spec with
        dedicated programs (the fused hot dispatch has no internal
        boundary).  Re-runs only when radius/batch/mode/model change, so
        the telemetry tracks real spec-dependent costs without taxing the
        steady state."""
        flow_fn, warp_fn = self._split_fns()
        # warm both programs so compile time never lands in the numbers
        blurred, frac, cut_score = flow_fn(*args, *knobs, thr)
        jax.block_until_ready(blurred)
        jax.block_until_ready(warp_fn(*args, blurred, frac, cut_score, ts,
                                      *levels, thr))
        t0 = time.perf_counter()
        blurred, frac, cut_score = flow_fn(*args, *knobs, thr)
        jax.block_until_ready(blurred)
        t1 = time.perf_counter()
        jax.block_until_ready(warp_fn(*args, blurred, frac, cut_score, ts,
                                      *levels, thr))
        t2 = time.perf_counter()
        self._record_split(t1 - t0, t2 - t1, n_outputs)
        self._split_cache[split_spec] = (t1 - t0, t2 - t1)

    def flush(self) -> List[OutputFrame]:
        """End-of-stream: nothing is held back.  The reference emits all
        intermediates of a pair before accepting the next source frame and
        simply forwards the EOF frame (vf_HopperRender.c:420-421,503-504),
        so there is no buffered output to drain; provided for API symmetry
        with sink.close()."""
        return []

    # telemetry used by the control surface / applet protocol
    def last_cut_score(self) -> float:
        if self._last_cut_score is None:
            return 0.0
        return float(self._last_cut_score)
