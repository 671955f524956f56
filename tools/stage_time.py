#!/usr/bin/env python
"""Per-pair device time of the flow pyramid, the warp and the fused
source-pair step, read from a profiler trace.

    python tools/stage_time.py [--width 3840 --height 2160 --pairs 6]
                               [--out traces/stage_time]

For each synthetic content (moving_box, gradient_pan) and each warp
sampler (shift, gather) it runs, at 24->120 with the hopper family,
radius 16 and blended mode, the engine's three programs on the same
source pairs: the flow-only program, the warp-only program (the split
timing pair, engine._make_flow_step/_make_warp_step) and the fused step
the CLI runs (engine._make_source_step).  Every call ends in
block_until_ready.  One JSON line per (content, sampler, program):

  wall_ms      median host wall time per pair, dispatch to ready, with
               the profiler off
  device_ms    median device busy time per pair from the trace: the
               union of the device's kernel and copy intervals inside
               the call's span
  kernels      device kernels launched per pair (median)
  d2h          device-to-host copies per pair (median; control-flow
               predicates the host reads)
  idle_share   1 - device_ms / wall_ms
  traced_*     the same wall time and idle share inside the traced
               calls, which the profiler's host overhead stretches

The first line names the card (nvidia-smi name and power limit) and the
device JAX reports.  Needs the GPU for device numbers; on any other
backend the device columns read from whatever device plane the trace
has, and the tool says so.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

Span = Tuple[str, int, int]          # (label, start_ns, end_ns)
Event = Tuple[str, int, int]         # (name, start_ns, duration_ns)


def busy_in_span(start: int, end: int, events: Iterable[Event]
                 ) -> Tuple[int, int, int]:
    """(busy ns, kernel count, device-to-host copy count) of the device
    events that start inside [start, end): busy is the union of their
    intervals clipped to the span."""
    ivs = sorted((s, min(s + d, end), n) for n, s, d in events
                 if start <= s < end)
    busy, cur_s, cur_e = 0, None, None
    kernels = d2h = 0
    for s, e, name in ivs:
        if name.startswith("Memcpy"):
            d2h += name == "MemcpyD2H"
        else:
            kernels += 1
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, kernels, d2h


def reduce_spans(spans: List[Span], events: List[Event]
                 ) -> Dict[str, dict]:
    """Per label (the span label up to '#'): medians per call of wall
    time, device busy time, kernels and device-to-host copies."""
    per: Dict[str, List[tuple]] = {}
    for label, s, e in spans:
        b, k, c = busy_in_span(s, e, events)
        per.setdefault(label.split("#")[0], []).append((e - s, b, k, c))
    out = {}
    for label, rows in per.items():
        wall = statistics.median(r[0] for r in rows) / 1e6
        dev = statistics.median(r[1] for r in rows) / 1e6
        out[label] = {"calls": len(rows), "wall_ms": wall,
                      "device_ms": dev,
                      "kernels": statistics.median(r[2] for r in rows),
                      "d2h": statistics.median(r[3] for r in rows),
                      "idle_share": 1.0 - dev / wall if wall else 0.0}
    return out


def read_trace(trace_dir: str, prefix: str
               ) -> Tuple[List[Span], List[Event], str]:
    """Host spans whose name starts with `prefix`, every event of the
    device planes, and the device plane's name."""
    import jax
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    spans: List[Span] = []
    events: List[Event] = []
    dev_name = ""
    for plane in data.planes:
        if plane.name.startswith("/device:"):
            dev_name = plane.name
            for line in plane.lines:
                events.extend((e.name, int(e.start_ns), int(e.duration_ns))
                              for e in line.events)
        elif plane.name.startswith("/host:"):
            for line in plane.lines:
                spans.extend((e.name, int(e.start_ns),
                              int(e.start_ns + e.duration_ns))
                             for e in line.events
                             if e.name.startswith(prefix))
    return spans, events, dev_name


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default="traces/stage_time")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from mpv_frame_interpolator.io import synthetic
    from mpv_frame_interpolator.ops.flow import FlowGeometry
    from mpv_frame_interpolator.pipeline import engine as E
    from mpv_frame_interpolator.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    dev = jax.devices()[0]
    head = {"card": card_line(), "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "width": args.width, "height": args.height,
            "rates": "24->120", "model": "hopper", "radius": 16}
    print(json.dumps(head), flush=True)
    os.makedirs(args.out, exist_ok=True)
    results = [head]

    w, h = args.width, args.height
    geom = FlowGeometry.create(h, w, w)
    ts = jnp.asarray(np.arange(5, dtype=np.float32) / 5)   # 24->120
    knobs = (jnp.int32(16), jnp.int32(8), jnp.int32(6))
    levels = (jnp.float32(0.0), jnp.float32(255.0))
    thr = jnp.float32(28.0)
    flow = E._make_flow_step(geom, 0, True, "hopper", False, 16)

    for content in ("moving_box", "gradient_pan"):
        cfg = synthetic.SyntheticConfig(width=w, height=h, fps=24.0)
        host = list(getattr(synthetic, content)(cfg, args.pairs + 2))
        ups = []
        for f in host[:3]:
            t0 = time.perf_counter()
            jax.block_until_ready([jax.device_put(f.y),
                                   jax.device_put(f.uv)])
            ups.append(time.perf_counter() - t0)
        stage_ms = statistics.median(ups) * 1e3    # one frame's upload
        frames = [(jax.device_put(f.y), jax.device_put(f.uv)) for f in host]
        jax.block_until_ready(frames)
        for sampling in ("shift", "gather"):
            warp = E._make_warp_step(geom, 2, 0, "nearest", True, "hopper",
                                     "vmap", sampling)
            fused = E._make_source_step(geom, 2, 0, "nearest", True,
                                        "hopper", "vmap", False, sampling,
                                        16)
            # first-call times: compile (or a compile-cache load) + run;
            # the flow program is shared by both samplers
            compile_s = {}
            t0 = time.perf_counter()
            b, fr, cs = flow(*frames[0], *frames[1], *knobs, thr)
            jax.block_until_ready(b)
            compile_s["flow"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            jax.block_until_ready(warp(*frames[0], *frames[1], b, fr, cs,
                                       ts, *levels, thr))
            compile_s["warp"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = fused(*frames[0], *frames[1], ts, *knobs, *levels, thr)
            jax.block_until_ready(out)
            compile_s["fused"] = time.perf_counter() - t0
            cut = float(out[3]) > float(thr)

            def run_pairs(annotate):
                """Each program once per pair, each call ended by
                block_until_ready; host wall seconds per program."""
                walls = {"flow": [], "warp": [], "fused": []}
                for i in range(1, args.pairs + 1):
                    a, c = frames[i], frames[i + 1]
                    calls = (
                        ("flow", lambda: flow(*a, *c, *knobs, thr)),
                        ("warp", lambda: warp(*a, *c, b, fr, cs, ts,
                                              *levels, thr)),
                        ("fused", lambda: fused(*a, *c, ts, *knobs,
                                                *levels, thr)))
                    for name, call in calls:
                        with jax.profiler.TraceAnnotation(
                                f"mfi_{name}#{i}") if annotate else \
                                contextlib.nullcontext():
                            t0 = time.perf_counter()
                            jax.block_until_ready(call())
                            walls[name].append(time.perf_counter() - t0)
                return walls

            # wall times with the profiler off; the trace's own host
            # overhead stretches every host-driven loop
            walls = run_pairs(False)
            tdir = os.path.join(args.out, f"{content}_{sampling}")
            jax.profiler.start_trace(tdir)
            run_pairs(True)
            jax.profiler.stop_trace()
            spans, events, dev_plane = read_trace(tdir, "mfi_")
            for label, row in sorted(reduce_spans(spans, events).items()):
                prog = label[len("mfi_"):]
                wall = statistics.median(walls[prog]) * 1e3
                line = {"content": content, "sampler": sampling,
                        "program": prog, "scene_cut": cut,
                        "first_call_s": compile_s.get(prog),
                        "device_plane": dev_plane or "none",
                        "upload_ms_per_frame": stage_ms,
                        "wall_ms": wall,
                        "device_ms": row["device_ms"],
                        "kernels": row["kernels"], "d2h": row["d2h"],
                        "idle_share": 1.0 - row["device_ms"] / wall,
                        "traced_wall_ms": row["wall_ms"],
                        "traced_idle_share": row["idle_share"],
                        "pairs": row["calls"]}
                results.append(line)
                print(json.dumps(line), flush=True)
    stats = dev.memory_stats() or {}
    tail = {"peak_bytes_in_use": stats.get("peak_bytes_in_use")}
    print(json.dumps(tail), flush=True)
    results.append(tail)
    with open(os.path.join(args.out, "stage_time.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
