"""Serving-farm example: K independent streams interpolated on one device.

Shows the MultiStreamEngine surface a transcode farm would use: each
stream keeps its own cadence/quality/scene state (one overloaded stream
degrades alone), while the compiled XLA programs are shared process-wide.

    JAX_PLATFORMS=cpu python examples/serving_farm.py   # CPU demo
    python examples/serving_farm.py                     # on the GPU
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.pipeline.engine import EngineConfig
from mpv_frame_interpolator.parallel.streams import MultiStreamEngine

N_STREAMS = 4
N_FRAMES = 24
W, H = 640, 360

sources = []
for k in range(N_STREAMS):
    cfg = synthetic.SyntheticConfig(width=W, height=H, fps=24.0, seed=k)
    sources.append(list(synthetic.gradient_pan(cfg, N_FRAMES, vx=2 + k)))

ms = MultiStreamEngine(
    EngineConfig(display_fps=60.0, auto_quality=True, measure_timing=True,
                 initial_search_radius=8),
    n_streams=N_STREAMS)

t0 = time.perf_counter()
total = 0
for step in range(N_FRAMES):
    outs = ms.push_batch([sources[k][step] for k in range(N_STREAMS)])
    for sid, frames in outs.items():
        for out in frames:
            out.block()           # a real farm would hand planes to sinks
        total += len(frames)
dt = time.perf_counter() - t0

print(f"{N_STREAMS} streams x {W}x{H} 24->60: "
      f"{total} output frames in {dt:.2f}s = {total / dt:.0f} total out-fps")
for sid, eng in enumerate(ms.engines):
    s = eng.stats.summary().get("source_frame_time", {})
    print(f"  stream {sid}: radius={eng.quality.search_radius} "
          f"state={eng.cadence.state.name} "
          f"mean={s.get('mean', 0.0) * 1e3:.2f}ms")
