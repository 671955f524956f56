"""StreamFarm: per-stream async dispatch (CLAUDE.md round-3 item 6).

Each stream is a full InterpolationEngine on its own worker thread; the
farm must produce byte-identical output to independent sequential engines,
keep streams independent (rates, formats, degradation, failures), and
apply per-stream backpressure.
"""

import dataclasses as dc
import queue
import threading
import time

import numpy as np
import pytest

from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.parallel.farm import (
    StreamFarm, StreamWorkerError)
from mpv_frame_interpolator.pipeline.cadence import InterpolationState
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)

KW = dict(scene_detection=False, auto_quality=False, measure_timing=False)


def sources(small_cfg, n_streams, n_frames, fps=None):
    cfgs = [dc.replace(small_cfg, seed=small_cfg.seed + k,
                       **({"fps": fps} if fps else {}))
            for k in range(n_streams)]
    return [list(synthetic.gradient_pan(c, n_frames)) for c in cfgs]


def run_sequential(cfg, frames):
    eng = InterpolationEngine(cfg)
    out = []
    for f in frames:
        out.append(eng.push(f))
    return out


class TestOutputParity:
    def test_matches_sequential_engines(self, small_cfg):
        cfg = EngineConfig(**KW, initial_search_radius=5)
        srcs = sources(small_cfg, 3, 5)
        expect = [run_sequential(cfg, s) for s in srcs]
        with StreamFarm(cfg, n_streams=3) as farm:
            for step in range(5):
                for sid in range(3):
                    farm.submit(sid, srcs[sid][step])
            got = farm.drain_all(timeout=120.0)
        for sid in range(3):
            assert len(got[sid]) == len(expect[sid])
            for outs_g, outs_e in zip(got[sid], expect[sid]):
                assert len(outs_g) == len(outs_e)
                for a, b in zip(outs_e, outs_g):
                    va, vb = a.to_video_frame(), b.to_video_frame()
                    assert va.pts == vb.pts
                    np.testing.assert_array_equal(va.y, vb.y)
                    np.testing.assert_array_equal(va.uv, vb.uv)

    def test_mixed_formats_per_stream(self, small_cfg):
        """Unlike the lockstep engine, streams may differ in geometry and
        pixel format."""
        cfg = EngineConfig(**KW)
        cfg_a = small_cfg
        cfg_b = dc.replace(small_cfg, width=32, height=32, pixfmt="p010")
        fa = list(synthetic.gradient_pan(cfg_a, 3))
        fb = list(synthetic.gradient_pan(cfg_b, 3))
        with StreamFarm(cfg, n_streams=2) as farm:
            for step in range(3):
                farm.submit(0, fa[step])
                farm.submit(1, fb[step])
            got = farm.drain_all(timeout=120.0)
        assert got[0][0][0].fmt.pixfmt == "nv12"
        assert got[1][0][0].fmt.pixfmt == "p010"
        assert got[1][-1][-1].to_video_frame().y.dtype == np.uint16


class TestIndependence:
    def test_stalled_stream_does_not_gate_others(self, small_cfg):
        """Submit nothing to stream 1; stream 0 must complete anyway (the
        lockstep engine would wait for a frame from every stream)."""
        cfg = EngineConfig(**KW)
        srcs = sources(small_cfg, 1, 4)
        with StreamFarm(cfg, n_streams=2) as farm:
            for f in srcs[0]:
                farm.submit(0, f)
            got = farm.drain(0, timeout=120.0)
            assert farm.pending(1) == 0
        assert sum(len(o) for o in got) >= 4

    def test_per_stream_rates(self, small_cfg):
        """Stream 0 pushes 6 frames, stream 1 only 2; both get exactly
        their own results."""
        cfg = EngineConfig(**KW)
        srcs = sources(small_cfg, 2, 6)
        with StreamFarm(cfg, n_streams=2) as farm:
            for f in srcs[0]:
                farm.submit(0, f)
            for f in srcs[1][:2]:
                farm.submit(1, f)
            got = farm.drain_all(timeout=120.0)
        assert len(got[0]) == 6
        assert len(got[1]) == 2

    def test_degradation_isolated(self, small_cfg):
        """Inject over-budget timings into stream 1's controller: only
        that stream degrades (same semantics as MultiStreamEngine)."""
        cfg = EngineConfig(scene_detection=False, auto_quality=True,
                           measure_timing=True, initial_search_radius=8,
                           too_slow_patience=1000)
        srcs = sources(small_cfg, 2, 6, fps=8.0)
        farm = StreamFarm(cfg, n_streams=2)
        try:
            for step in range(3):
                farm.submit(0, srcs[0][step])
                farm.submit(1, srcs[1][step])
            farm.drain_all(timeout=120.0)
            r0 = farm.engines[0].quality.search_radius
            r1 = farm.engines[1].quality.search_radius
            for step in range(3, 6):
                # worker threads are idle here (drained), safe to poke
                farm.engines[1]._last_calc_duration = 10.0
                farm.submit(1, srcs[1][step])
                farm.drain(1, timeout=120.0)
                farm.submit(0, srcs[0][step])
                farm.drain(0, timeout=120.0)
            assert farm.engines[1].quality.search_radius <= max(r1 - 3, 5)
            assert farm.engines[0].quality.search_radius >= r0
            assert farm.engines[0].cadence.state == InterpolationState.ACTIVE
        finally:
            farm.close()

    def test_worker_error_propagates_and_is_isolated(self, small_cfg):
        cfg = EngineConfig(**KW)
        srcs = sources(small_cfg, 2, 3)
        farm = StreamFarm(cfg, n_streams=2)
        try:
            farm.submit(0, "not a frame")      # kills stream 0's worker
            with pytest.raises(StreamWorkerError) as ei:
                farm.get(0, timeout=60.0)
            assert ei.value.stream_id == 0
            with pytest.raises(StreamWorkerError):
                farm.submit(0, srcs[0][0])     # stream 0 stays dead
            for f in srcs[1]:                  # stream 1 unaffected
                farm.submit(1, f)
            got = farm.drain(1, timeout=120.0)
            assert len(got) == 3
        finally:
            farm.close()


class TestFlowControl:
    def test_backpressure_is_per_stream(self, small_cfg):
        """A full input queue blocks only that stream's producer."""
        cfg = EngineConfig(**KW)
        srcs = sources(small_cfg, 2, 8)
        farm = StreamFarm(cfg, n_streams=2, queue_depth=1)
        try:
            # block stream 0's worker by keeping its queue saturated from
            # a side thread while stream 1 makes progress
            stop = threading.Event()

            def flood():
                i = 0
                while not stop.is_set():
                    try:
                        farm.submit(0, srcs[0][i % 8], timeout=0.05)
                        i += 1
                    except queue.Full:
                        pass

            t = threading.Thread(target=flood, daemon=True)
            t.start()
            for f in srcs[1]:
                farm.submit(1, f)
            got = farm.drain(1, timeout=120.0)
            assert len(got) == 8
            stop.set()
            t.join(timeout=10.0)
        finally:
            farm.close()
            farm.drain_all(timeout=120.0)   # results survive close()

    def test_get_without_submit_raises(self, small_cfg):
        with StreamFarm(EngineConfig(**KW), n_streams=1) as farm:
            with pytest.raises(queue.Empty):
                farm.get(0)
            assert farm.try_get(0) is None

    def test_close_then_submit_raises(self, small_cfg):
        farm = StreamFarm(EngineConfig(**KW), n_streams=1)
        farm.close()
        srcs = sources(small_cfg, 1, 1)
        with pytest.raises(RuntimeError):
            farm.submit(0, srcs[0][0])

    def test_per_stream_configs(self, small_cfg):
        cfgs = [EngineConfig(**KW, display_fps=60.0),
                EngineConfig(**KW, display_fps=120.0)]
        srcs = sources(small_cfg, 2, 4)
        with StreamFarm(n_streams=2, configs=cfgs) as farm:
            for step in range(4):
                farm.submit(0, srcs[0][step])
                farm.submit(1, srcs[1][step])
            got = farm.drain_all(timeout=120.0)
        n0 = sum(len(o) for o in got[0])
        n1 = sum(len(o) for o in got[1])
        assert n1 > n0    # 120 Hz stream produces ~2x the outputs
