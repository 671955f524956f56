"""Multi-stream serving: K independent streams on one device.

A transcode/serving farm interpolates many independent videos at once.
This engine manages K streams behind one lockstep API:

    ms = MultiStreamEngine(EngineConfig(...), n_streams=4)
    for step_frames in zip(*sources):          # one frame per stream
        outs = ms.push_batch(step_frames)      # {stream_id: [OutputFrame]}

Each stream is a FULL InterpolationEngine -- its own cadence, quality
controller, scene state, stats, and telemetry, exactly like K instances of
the reference filter (per-instance priv of vf_HopperRender.c).  When one
stream's content gets expensive, only that stream degrades (search radius
/ TooSlow); the compiled XLA programs are shared across streams
automatically (the step factories are process-wide caches).

Dispatch strategy: sequential fused steps per stream (the default), or
one program vmapped across streams (`batch_dispatch=True`).  Which is
faster on the GPU is not measured yet.  The vmapped path carries a PER-STREAM search-radius
vector so the quality controllers still apply, but its timing signal is
the shared batch duration (lockstep dispatch has no per-stream boundary),
so per-stream degradation granularity needs the sequential mode.

Constraints: all streams share one geometry/pixfmt (farm batches by
format -- mixed formats go to separate engines); in batch_dispatch mode
per-step plans are padded to the widest stream's output count.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mpv_frame_interpolator.frame import FrameFormat, VideoFrame
from mpv_frame_interpolator.ops.flow import FlowGeometry
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine, OutputFrame, _make_source_step)
from mpv_frame_interpolator.utils import get_logger

log = get_logger("streams")


@functools.lru_cache(maxsize=32)
def _make_batched_step(geom: FlowGeometry, mode: int, scale_shift: int,
                       cut_policy: str, scene_enabled: bool, model: str):
    """The engine's fused source-step vmapped over a leading stream axis
    (radius is per-stream so each quality controller still bites)."""
    base = _make_source_step(geom, mode, scale_shift, cut_policy,
                             scene_enabled, model)

    def one(f1y, f1uv, f2y, f2uv, ts, radius, ds, nbs, black, white, thr):
        return base(f1y, f1uv, f2y, f2uv, ts, radius, ds, nbs,
                    black, white, thr)

    return jax.jit(jax.vmap(
        one, in_axes=(0, 0, 0, 0, 0, 0, None, None, None, None, None)))


class MultiStreamEngine:
    def __init__(self, config: Optional[EngineConfig] = None,
                 n_streams: int = 2, batch_dispatch: bool = False):
        self.config = config or EngineConfig()
        self.n = n_streams
        self.batch_dispatch = batch_dispatch
        # one full engine per stream: per-instance cadence/quality/scene/
        # stats, like K instances of the reference filter.  Background
        # precompile is disabled per stream -- the compiled programs are
        # process-wide, so K warm threads would be redundant AND suppress
        # K streams' quality measurements at once.
        self.engines: List[InterpolationEngine] = [
            InterpolationEngine(dataclasses.replace(
                self.config, background_precompile=False))
            for _ in range(n_streams)]
        self.geom: Optional[FlowGeometry] = None
        self._fmt: Optional[FrameFormat] = None
        self._scale_shift = 0
        # batch-dispatch state (the vmapped path manages pairs itself)
        self._prev: List[Optional[VideoFrame]] = [None] * n_streams
        self._last_batch_dur = 0.0
        self._warm = set()    # (mode, n_max, model) batch specializations

    # back-compat views over the per-stream engines ----------------------

    @property
    def cadences(self):
        return [e.cadence for e in self.engines]

    @property
    def qualities(self):
        return [e.quality for e in self.engines]

    def stats(self, sid: int):
        return self.engines[sid].stats

    # ---------------------------------------------------------------------

    def _ensure_geometry(self, frame: VideoFrame):
        fmt = frame.fmt
        if self._fmt is None:
            self.geom = FlowGeometry.create(fmt.height, fmt.stride,
                                            fmt.width,
                                            self.config.max_calc_res,
                                            self.config.num_iterations)
            self._scale_shift = 0 if fmt.pixfmt == "nv12" else 8
            self._fmt = fmt
        elif (fmt.height, fmt.stride, fmt.width, fmt.pixfmt) != (
                self._fmt.height, self._fmt.stride, self._fmt.width,
                self._fmt.pixfmt):
            raise ValueError("all streams in a batch share one geometry; "
                             "route other formats to a separate engine")

    @staticmethod
    def _planes(frame: VideoFrame):
        # interleaved chroma goes to the device whole; the fused program
        # splits it (engine._DeviceFrame rationale)
        return (jnp.asarray(frame.y), jnp.asarray(frame.uv))

    def push_batch(self, frames: Sequence[Optional[VideoFrame]]
                   ) -> Dict[int, List[OutputFrame]]:
        """One frame per stream (None = stream idle this step).  Returns
        {stream_index: [OutputFrame, ...]}."""
        assert len(frames) == self.n
        for frame in frames:
            if frame is not None:
                self._ensure_geometry(frame)
        if not self.batch_dispatch:
            # sequential fused dispatches (measured faster; see module
            # doc): each stream's own engine does cadence + quality +
            # scene + telemetry, so behavior matches K single engines
            results: Dict[int, List[OutputFrame]] = {}
            for sid, frame in enumerate(frames):
                if frame is None:
                    continue
                results[sid] = self.engines[sid].push(frame)
            return results
        return self._push_batched(frames)

    def _push_batched(self, frames) -> Dict[int, List[OutputFrame]]:
        results: Dict[int, List[OutputFrame]] = {}
        batch = []   # (stream_id, plan, f1 planes, f2 planes)

        for sid, frame in enumerate(frames):
            if frame is None:
                continue
            eng = self.engines[sid]
            # feed last batch's shared duration to this stream's
            # controller (lockstep dispatch: one timing signal)
            if self.config.measure_timing:
                eng.quality.update(self._last_batch_dur, eng.cadence)
            plan = eng.cadence.on_source_frame(frame.pts,
                                               frame.nominal_fps)
            if plan.passthrough:
                if eng.cadence.source_frame_num == 1:
                    self._prev[sid] = frame
                results[sid] = [OutputFrame(frame.pts, frame.fmt, frame.y,
                                            frame.uv, host=True)]
                continue
            f1 = self._prev[sid] if self._prev[sid] is not None else frame
            batch.append((sid, plan, self._planes(f1), self._planes(frame)))
            self._prev[sid] = frame

        if not batch:
            return results

        out_fmt = FrameFormat(self.geom.actual_width, self.geom.height,
                              self._fmt.pixfmt)
        n_max = max(len(p.outputs) for _, p, _, _ in batch)
        ts = np.zeros((len(batch), n_max), np.float32)
        radius = np.zeros((len(batch),), np.int32)
        for i, (sid, plan, _, _) in enumerate(batch):
            blends = [s.blend for s in plan.outputs]
            ts[i, :len(blends)] = blends
            # pad with the last blend (wasted slots, stable shapes)
            ts[i, len(blends):] = blends[-1] if blends else 0.0
            radius[i] = self.engines[sid].quality.search_radius

        step = _make_batched_step(self.geom, self.config.frame_output_mode,
                                  self._scale_shift, self.config.cut_policy,
                                  self.config.scene_detection,
                                  self.config.model)
        t0 = time.perf_counter()
        y, uv, _, cut_scores = step(
            *(jnp.stack([b[2][k] for b in batch]) for k in range(2)),
            *(jnp.stack([b[3][k] for b in batch]) for k in range(2)),
            jnp.asarray(ts), jnp.asarray(radius),
            jnp.int32(self.config.delta_scalar),
            jnp.int32(self.config.neighbor_bias_scalar),
            jnp.float32(self.config.black_level),
            jnp.float32(self.config.white_level),
            jnp.float32(self.config.scene_threshold))

        for i, (sid, plan, _, _) in enumerate(batch):
            results[sid] = [
                OutputFrame(slot.pts, out_fmt, y[i], uv[i], host=False,
                            index=k)
                for k, slot in enumerate(plan.outputs)]
        if self.config.measure_timing:
            jax.block_until_ready(uv)
            spec = (self.config.frame_output_mode, n_max, self.config.model)
            was_warm = spec in self._warm
            self._warm.add(spec)
            # a compile inside the dispatch is not a compute measurement
            self._last_batch_dur = (time.perf_counter() - t0) if was_warm \
                else 0.0
            for i, (sid, plan, _, _) in enumerate(batch):
                eng = self.engines[sid]
                if was_warm:
                    eng.stats.add("source_frame_time", self._last_batch_dur)
                eng.stats.add("outputs", len(plan.outputs))
                eng.scene.is_cut(float(cut_scores[i]))
        return results