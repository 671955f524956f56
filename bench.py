#!/usr/bin/env python
"""Benchmark: interpolated frames/sec on the attached device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

vs_baseline is measured output-fps / display-fps (the reference's implicit
contract is "real-time at the display rate", BASELINE.md: it publishes no
numbers and self-degrades when it can't keep up, vf_HopperRender.c:326-345).
A value >= 1.0 means sustained real-time interpolation.

Every timing ends in jax.block_until_ready, which waits for the device.
Every line names the device it ran on: `platform`, `device_kind` and
`device_count` as JAX reports them, and `card` (name and power limit from
nvidia-smi) where there is one.

The line also carries:
  p99_block_ms / p99_e2e_latency_ms
                      per-output wait / source arrival -> output ready
  p99_pair_latency_ms source push -> the pair's last output ready
  default_config_fps  same pipeline with the PRODUCT default config
                      (measure_timing=True: push() blocks on each pair's
                      last output, the reference's blocking-download
                      cadence)
  push_ms_per_pair    host time of push() alone (enqueue, no wait)
  parity_ok           oracle bit-exactness smoke (flow + 2 warp modes on
                      2 geometries, utils/parity.py)

Env knobs:
  MFI_BENCH_WIDTH/HEIGHT/SRC_FPS/DST_FPS/FRAMES/RADIUS  override the config
  MFI_BENCH_P010=1   run the 10-bit pipeline
  MFI_BENCH_MODE     FrameOutput mode integer (default 2 = blended)
  MFI_BENCH_MODEL    hopper|hopperx|hopperq (default hopper)
  MFI_BENCH_SUBPEL=1 measured sub-pel flow
  MFI_BENCH_STREAMING=1  full end-to-end: disk y4m -> C++ demux ring ->
                     host->device staging -> fused compute
  MFI_BENCH_SKIP_PARITY=1 / MFI_BENCH_SKIP_DEFAULT=1 / MFI_BENCH_SKIP_P99=1
                     trim extras
  MFI_BENCH_GROUP=K  pair-grouped dispatch (engine.push_many, K pairs
                     per device program)
"""

import json
import os
import subprocess
import sys
import time


def build_engine(dst_fps, radius, mode, model, measure_timing):
    from mpv_frame_interpolator.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    return InterpolationEngine(EngineConfig(
        display_fps=dst_fps,
        auto_quality=False,            # fixed radius => comparable runs
        initial_search_radius=radius,
        scene_detection=True,
        measure_timing=measure_timing,
        frame_output_mode=mode,
        model=model,
        subpel_flow=bool(int(os.environ.get("MFI_BENCH_SUBPEL", "0"))),
        # warmup pushes compile what the window needs; a background
        # compile would share the device with the timed window
        background_precompile=False,
    ))


def device_fields() -> dict:
    """The device every number on the line was taken on."""
    import jax
    devs = jax.devices()
    out = {"platform": devs[0].platform,
           "device_kind": devs[0].device_kind,
           "device_count": len(devs)}
    if out["platform"] == "gpu":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


def p99(xs):
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(int(len(xs) * 0.99), len(xs) - 1)] * 1e3


def measure_staged(engine, frames, warmup, passes=2, group=1):
    """Over device-staged sources: throughput of `passes` repetitions of
    the source span (pts-shifted; identical per-pair plans, so no new
    compiles), each pushed without waiting and ended by waiting on its
    last output (the device runs in order); best pass wins.  Then one
    ungrouped span with every output waited on, for the per-output
    latencies.

    Returns (outputs, out-fps, per-output block waits, source arrival ->
    output ready latencies)."""
    import dataclasses
    if group > 1:
        outs = engine.push_many(frames[:warmup], group_size=group)
    else:
        outs = [o for f in frames[:warmup] for o in engine.push(f)]
    if outs:
        outs[-1].block()
    span = len(frames[warmup:]) / max(getattr(frames[0], "nominal_fps", 24.0)
                                      or 24.0, 1e-6)
    clock = [0.0]   # monotonically advancing pts offset across passes

    def shifted():
        clock[0] += span
        return [dataclasses.replace(f, pts=f.pts + clock[0])
                for f in frames[warmup:]]

    def one_pass():
        t0 = time.perf_counter()
        if group > 1:
            outs = engine.push_many(shifted(), group_size=group)
        else:
            outs = [o for f in shifted() for o in engine.push(f)]
        if outs:
            outs[-1].block()
        return len(outs), len(outs) / (time.perf_counter() - t0)

    n_out, fps = max([one_pass() for _ in range(passes)],
                     key=lambda r: r[1])
    lat_block, lat_e2e = [], []
    for f in shifted():
        t_in = time.perf_counter()
        for o in engine.push(f):
            s = time.perf_counter()
            o.block()
            now = time.perf_counter()
            lat_block.append(now - s)
            lat_e2e.append(now - t_in)
    return n_out, fps, lat_block, lat_e2e


def measure_streaming(path, engine):
    """Full product pipeline: C++ demux ring -> prefetcher staging ->
    fused dispatch, NullSink syncing each output."""
    from mpv_frame_interpolator.io.ingest import open_y4m
    from mpv_frame_interpolator.io.sinks import NullSink
    from mpv_frame_interpolator.pipeline.player import Pipeline

    def one_pass():
        src = open_y4m(path)
        pipe = Pipeline(src, engine, NullSink(block=True), present=None)
        t0 = time.perf_counter()
        n_out = pipe.run()
        dt = time.perf_counter() - t0
        stats = src.stats() if hasattr(src, "stats") else {}
        if hasattr(src, "close"):
            src.close()
        return n_out, n_out / dt, stats

    one_pass()                        # compile + cache warm
    return max([one_pass() for _ in range(2)], key=lambda r: r[1])


def main():
    width = int(os.environ.get("MFI_BENCH_WIDTH", 3840))
    height = int(os.environ.get("MFI_BENCH_HEIGHT", 2160))
    src_fps = float(os.environ.get("MFI_BENCH_SRC_FPS", 24.0))
    dst_fps = float(os.environ.get("MFI_BENCH_DST_FPS", 120.0))
    n_frames = int(os.environ.get("MFI_BENCH_FRAMES", 48))
    radius = int(os.environ.get("MFI_BENCH_RADIUS", 16))
    p010 = bool(int(os.environ.get("MFI_BENCH_P010", "0")))
    mode = int(os.environ.get("MFI_BENCH_MODE", 2))
    model = os.environ.get("MFI_BENCH_MODEL", "hopper")
    streaming = bool(int(os.environ.get("MFI_BENCH_STREAMING", "0")))
    group = max(int(os.environ.get("MFI_BENCH_GROUP", "1")), 1)
    warmup = 6

    from mpv_frame_interpolator.io import synthetic

    cfg = synthetic.SyntheticConfig(width=width, height=height, fps=src_fps,
                                    pixfmt="p010" if p010 else "nv12")
    extras = device_fields()
    lat_block = lat_e2e = []

    if streaming:
        # stage the content on DISK (the ingest boundary), next to the
        # checkout's other generated data
        from mpv_frame_interpolator.io.y4m import Y4MWriter
        from mpv_frame_interpolator.utils.compile_cache import CHECKOUT
        os.makedirs(CHECKOUT / ".bench_data", exist_ok=True)
        path = str(CHECKOUT / ".bench_data" /
                   f"{width}x{height}_{'p010' if p010 else 'nv12'}.y4m")
        if not os.path.exists(path):
            with open(path, "wb") as fh:
                wtr = Y4MWriter(fh, width, height, src_fps,
                                "p010" if p010 else "nv12")
                for f in synthetic.gradient_pan(cfg, warmup + n_frames,
                                                vx=3, vy=1):
                    wtr.write(f)
        engine = build_engine(dst_fps, radius, mode, model,
                              measure_timing=False)
        n_out, fps, ingest_stats = measure_streaming(path, engine)
        extras["ingest"] = {k: ingest_stats.get(k) for k in
                            ("frames_read", "recycled") if k in ingest_stats}
    else:
        # sources staged on device first: benchmarks the interpolation
        # pipeline itself (MFI_BENCH_STREAMING=1 adds ingest and upload)
        import dataclasses
        import jax.numpy as jnp
        frames = [dataclasses.replace(f, y=jnp.asarray(f.y),
                                      uv=jnp.asarray(f.uv))
                  for f in synthetic.gradient_pan(cfg, warmup + n_frames,
                                                  vx=3, vy=1)]
        engine = build_engine(dst_fps, radius, mode, model,
                              measure_timing=False)
        n_out, fps, lat_block, lat_e2e = measure_staged(
            engine, frames, warmup, group=group)
        if group > 1:
            extras["push_many_group"] = group

        if not int(os.environ.get("MFI_BENCH_SKIP_DEFAULT", "0")):
            # the PRODUCT default config: measure_timing=True blocks on
            # each pair's last output (reference blocking-download
            # cadence)
            dengine = build_engine(dst_fps, radius, mode, model,
                                   measure_timing=True)
            n_def, fps_def, _, _ = measure_staged(dengine, frames, warmup,
                                                  passes=1)
            extras["default_config_fps"] = round(fps_def, 2)

        # host cost of push() alone: enqueue a span without waiting, then
        # drain (untimed)
        span = (len(frames) - warmup) / max(src_fps, 1e-6)
        t0 = time.perf_counter()
        last = None
        for f in frames[warmup:]:
            outs = engine.push(dataclasses.replace(f, pts=f.pts + 1e4 + span))
            if outs:
                last = outs[-1]
        extras["push_ms_per_pair"] = round(
            (time.perf_counter() - t0) / max(len(frames) - warmup, 1) * 1e3,
            3)
        if last is not None:
            last.block()

        if not int(os.environ.get("MFI_BENCH_SKIP_P99", "0")):
            # per-pair latency: source push -> the pair's last output
            # ready on the device
            lats = []
            for f in frames[warmup:warmup + 30]:
                t0 = time.perf_counter()
                outs = engine.push(dataclasses.replace(
                    f, pts=f.pts + 2e4 + 2 * span))
                if outs:
                    outs[-1].block()
                    lats.append(time.perf_counter() - t0)
            if lats:
                extras["p99_pair_latency_ms"] = round(p99(lats), 3)
                extras["p99_pair_target_met"] = bool(p99(lats) <= 16.6)

    if not int(os.environ.get("MFI_BENCH_SKIP_PARITY", "0")):
        from mpv_frame_interpolator.utils.parity import parity_ok
        extras["parity_ok"] = bool(parity_ok())

    print(json.dumps({
        "metric": f"interpolated frames/sec, {width}x{height}"
                  f"{' p010' if p010 else ''} {src_fps:g}->{dst_fps:g} "
                  f"(mode {mode}, {model}, radius {radius}"
                  f"{f', grouped x{group}' if group > 1 else ''}"
                  f"{', streaming-e2e' if streaming else ''})",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / dst_fps, 4),
        "p99_block_ms": round(p99(lat_block), 3),
        "p99_e2e_latency_ms": round(p99(lat_e2e), 3),
        "source_frames": n_frames,
        "output_frames": n_out,
        **extras,
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # always emit a parseable line
        print(json.dumps({"metric": "bench-error", "value": 0,
                          "unit": "frames/sec", "vs_baseline": 0,
                          "error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
