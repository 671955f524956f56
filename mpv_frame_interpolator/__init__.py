"""mpv_frame_interpolator — a JAX video frame-interpolation framework.

Re-implements the capabilities of the HopperRender optical-flow
frame-interpolation filter that ships inside the
HopperLogger/mpv-frame-interpolator fork of mpv (reference:
video/filter/HopperRender/ in that fork).  The compute path is plain
JAX/XLA, run on a GPU; the host path is a pull-based frame pipeline
reproducing mpv's output-cadence semantics.

Layout (mirrors SURVEY.md §7):
  frame        -- NV12/P010 frame containers + colorimetry metadata
  ops          -- flow search / blur / warp (jnp/lax) and the NumPy
                  oracle they are golden-tested against
  models       -- interpolator "model families" (hopper block-matching flow)
  pipeline     -- cadence engine, interpolation engine, present clock,
                  scene-change detection, auto-quality controller
  io           -- sources (synthetic, y4m, raw, ffmpeg-if-present) and sinks
  parallel     -- device-mesh sharding of the flow/warp step
  utils        -- logging, stats registry, config
"""

__version__ = "0.1.0"

from mpv_frame_interpolator.frame import VideoFrame, FrameFormat  # noqa: F401
