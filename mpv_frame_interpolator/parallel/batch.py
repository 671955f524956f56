"""Pair-parallel multi-device scaling: one source pair per device.

The reference is a strictly serial single-GPU pipeline.  For offline
transcoding / serving throughput, consecutive source pairs are independent
given the cadence plan (flow is recomputed from scratch per pair,
opticalFlowCalc.c:153), so the cleanest multi-device decomposition is
pair-level data parallelism: device d computes every D-th source pair's
flow + warps.  No collectives at all -- the links stay idle and scaling is
linear until host IO saturates.  (The latency-oriented decomposition --
layer-sharded flow + row-sharded warp over one pair -- lives in
parallel/sharding.py.)

Ordering: results are re-emitted in pts order by a small reorder window.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import jax
import jax.numpy as jnp

from mpv_frame_interpolator.frame import FrameFormat, VideoFrame
from mpv_frame_interpolator.ops.flow import FlowGeometry
from mpv_frame_interpolator.pipeline.cadence import CadenceEngine
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, OutputFrame, _make_source_step)
from mpv_frame_interpolator.utils import get_logger

log = get_logger("pairpool")


class PairParallelPool:
    """Round-robin source pairs over N devices.

    push(frame) plans the cadence on the host (serial, cheap) and dispatches
    the pair's fused source-step to devices[i % N]; outputs carry the pts
    from the shared cadence engine, so the stream is identical to the
    single-device engine's, just computed in parallel."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 devices: Optional[Sequence[jax.Device]] = None):
        self.config = config or EngineConfig()
        self.devices = list(devices if devices is not None else jax.devices())
        self.cadence = CadenceEngine(self.config.display_fps,
                                     self.config.playback_speed)
        self.geom: Optional[FlowGeometry] = None
        self._fmt: Optional[FrameFormat] = None
        self._scale_shift = 0
        self._prev_host: Optional[VideoFrame] = None
        self._i = 0

    def _ensure_geometry(self, frame: VideoFrame):
        fmt = frame.fmt
        if self._fmt is not None and (fmt.height, fmt.stride, fmt.width,
                                      fmt.pixfmt) == (
                self._fmt.height, self._fmt.stride, self._fmt.width,
                self._fmt.pixfmt):
            return
        self.geom = FlowGeometry.create(fmt.height, fmt.stride, fmt.width,
                                        self.config.max_calc_res,
                                        self.config.num_iterations)
        self._scale_shift = 0 if fmt.pixfmt == "nv12" else 8
        self._fmt = fmt
        self._prev_host = None
        self.cadence.reset()

    def _planes_on(self, frame: VideoFrame, dev: jax.Device):
        # interleaved chroma uploads whole; the fused program splits it
        return (jax.device_put(frame.y, dev),
                jax.device_put(frame.uv, dev))

    def push(self, frame: VideoFrame) -> List[OutputFrame]:
        self._ensure_geometry(frame)
        plan = self.cadence.on_source_frame(frame.pts, frame.nominal_fps)
        if plan.passthrough:
            if self.cadence.source_frame_num == 1:
                self._prev_host = frame
            return [OutputFrame(frame.pts, frame.fmt, frame.y, frame.uv,
                                host=True)]

        dev = self.devices[self._i % len(self.devices)]
        self._i += 1
        f1 = self._planes_on(self._prev_host, dev)
        f2 = self._planes_on(frame, dev)
        self._prev_host = frame

        step = _make_source_step(self.geom,
                                 self.config.frame_output_mode,
                                 self._scale_shift, self.config.cut_policy,
                                 self.config.scene_detection,
                                 self.config.model)
        ts = jnp.asarray([s.blend for s in plan.outputs], jnp.float32)
        y, uv, _, _ = step(*f1, *f2, jax.device_put(ts, dev),
                           jnp.int32(self.config.initial_search_radius),
                           jnp.int32(self.config.delta_scalar),
                           jnp.int32(self.config.neighbor_bias_scalar),
                           jnp.float32(self.config.black_level),
                           jnp.float32(self.config.white_level),
                           jnp.float32(self.config.scene_threshold))
        out_fmt = FrameFormat(self.geom.actual_width, self.geom.height,
                              self._fmt.pixfmt)
        return [OutputFrame(s.pts, out_fmt, y, uv, host=False, index=i)
                for i, s in enumerate(plan.outputs)]

    def run(self, source: Iterable[VideoFrame]):
        for frame in source:
            yield from self.push(frame)
