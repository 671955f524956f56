"""The flagship model family: hierarchical block-matching flow + warp.

A thin, documented facade over ops/flow.py and ops/warp.py binding them
into one "model": analyze a source pair into a flow field, synthesize any
number of in-between frames from it.  The engine's fused dispatch inlines
exactly this composition (pipeline/engine.py:_make_source_step); this
module is the standalone, composable form for library users and for the
multi-chip path (parallel/sharding.py builds the sharded equivalent).

Algorithm (reference parity, SURVEY.md §2.1 "Algorithm summary"):
  1. offsets zeroed; window from next_pow2(max(lowdim))/2, halving
  2. per (iteration, step): quadratically-spaced candidate layers are
     SAD-scored per window (delta<<deltaScalar + |offset| bias + neighbor
     bias from iteration 4), first-min argmin, signed-square commit
  3. 8x8 box blur -> final field
  4. per output t: bidirectional warp (forward flow at t, reverse flow
     derived by back-projection) + fixed-point blend + levels
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from mpv_frame_interpolator.ops.flow import FlowGeometry, make_flow_fn
from mpv_frame_interpolator.ops.warp import (
    make_warp_fn, make_warp_batch_fn, BLENDED_FRAME)


@dataclasses.dataclass(frozen=True)
class HopperModel:
    """One geometry-bound instance of the block-matching interpolator."""

    geom: FlowGeometry
    search_radius: int = 16
    mode: int = BLENDED_FRAME
    scale_shift: int = 0            # 0 = 8-bit NV12, 8 = P010
    delta_scalar: int = 8
    neighbor_bias_scalar: int = 6

    @classmethod
    def for_frame(cls, height: int, width: int, stride: int = None,
                  **kw) -> "HopperModel":
        geom = FlowGeometry.create(height, stride or width, width)
        return cls(geom=geom, **kw)

    def analyze(self, f1y, f1u, f1v, f2y, f2u, f2v):
        """Source pair -> (raw offset field, blurred field), (2, lh, lw)."""
        fn = make_flow_fn(self.geom, self.search_radius, self.scale_shift)
        return fn(f1y, f1u, f1v, f2y, f2u, f2v,
                  jnp.int32(self.delta_scalar),
                  jnp.int32(self.neighbor_bias_scalar))

    def synthesize(self, f1y, f1u, f1v, f2y, f2u, f2v, blurred, t,
                   black=0.0, white=255.0):
        """One in-between frame at blend position t -> (y, u, v).

        t must be <= 1.0 (the reference rejects larger scalars,
        opticalFlowCalc.c:209-211)."""
        if float(t) > 1.0:
            raise ValueError("blending scalar must be <= 1.0")
        fn = make_warp_fn(self.geom, self.mode, self.scale_shift)
        return fn(f1y, f1u, f1v, f2y, f2u, f2v, blurred,
                  jnp.float32(t), jnp.float32(black), jnp.float32(white))

    def synthesize_batch(self, f1y, f1u, f1v, f2y, f2u, f2v, blurred, ts,
                         black=0.0, white=255.0):
        """All in-between frames of a pair in one dispatch."""
        fn = make_warp_batch_fn(self.geom, self.mode, self.scale_shift)
        return fn(f1y, f1u, f1v, f2y, f2u, f2v, blurred,
                  jnp.asarray(ts, jnp.float32),
                  jnp.float32(black), jnp.float32(white))

    def interpolate(self, f1y, f1u, f1v, f2y, f2u, f2v, ts, **kw):
        """analyze + synthesize_batch in one call."""
        _, blurred = self.analyze(f1y, f1u, f1v, f2y, f2u, f2v)
        return self.synthesize_batch(f1y, f1u, f1v, f2y, f2u, f2v,
                                     blurred, ts, **kw)
