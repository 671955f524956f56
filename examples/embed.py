#!/usr/bin/env python
"""Minimal embedding example: interpolate a synthetic clip via the Player
API, watch properties change, and write the result to y4m.

    PYTHONPATH=. python examples/embed.py /tmp/out.y4m
"""

import sys

from mpv_frame_interpolator.api import Player
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.y4m import Y4MWriter
from mpv_frame_interpolator.pipeline.engine import EngineConfig


def main(out_path: str = "/tmp/embed_out.y4m") -> int:
    # auto_quality off for the demo: on a slow host backend the controller
    # would (correctly) declare TooSlow and pass frames through
    player = Player(EngineConfig(display_fps=60.0, model="hopperq",
                                 auto_quality=False,
                                 initial_search_radius=8,
                                 measure_timing=False))
    player.observe_property("interpolation-state",
                            lambda k, v: print(f"  [{k}] -> {v}"))
    player.observe_property("search-radius",
                            lambda k, v: print(f"  [{k}] -> {v}"))

    cfg = synthetic.SyntheticConfig(width=640, height=360, fps=24.0)
    source = synthetic.moving_box(cfg, 24, vx=4, vy=1)

    with open(out_path, "wb") as fh:
        writer = Y4MWriter(fh, cfg.width, cfg.height, 60.0)
        n = 0
        for out in player.feed_all(source):
            writer.write(out.to_video_frame())
            n += 1
    print(f"wrote {n} frames at 60fps to {out_path}")
    print("final stats:", {k: round(v["mean"] * 1e3, 2)
                           for k, v in player.get_property("stats").items()
                           if k == "source_frame_time"})
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
