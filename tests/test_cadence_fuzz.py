"""Adversarial cadence fuzzing (SURVEY.md §7 hardening phase).

Feeds the cadence engine hostile PTS streams -- jitter, VFR, resets, speed
flapping, backwards timestamps -- and checks the invariants that protect
the device pipeline:

  * blending scalar always in [0, 1)
  * numIntFrames >= 1 and bounded by the fps ratio
  * every plan's blend slots are in [0, 1)
  * intermediate pts strictly increase within a plan
  * the engine never raises
"""

import math
import random

import pytest

from mpv_frame_interpolator.pipeline.cadence import CadenceEngine


def check_plan(eng, plan):
    assert 0.0 <= eng.blending_scalar < 1.0
    assert eng.num_int_frames >= 1
    for slot in plan.outputs:
        assert 0.0 <= slot.blend < 1.0
    pts = [s.pts for s in plan.outputs]
    assert pts == sorted(pts)
    if len(pts) > 1:
        steps = [b - a for a, b in zip(pts, pts[1:])]
        for s in steps:
            assert s > 0


@pytest.mark.parametrize("seed", range(8))
def test_adversarial_stream(seed):
    rng = random.Random(seed)
    eng = CadenceEngine(rng.choice([48.0, 60.0, 90.0, 120.0, 144.0]))
    pts = 0.0
    for i in range(400):
        action = rng.random()
        if action < 0.05:
            eng.set_speed(rng.choice([0.25, 0.5, 1.0, 1.5, 2.0, 4.0]))
        elif action < 0.08:
            eng.reset()
            pts += rng.uniform(-50.0, 500.0)  # seek anywhere
        fps = rng.choice([10.0, 12.0, 23.976, 24.0, 25.0, 29.97, 30.0,
                          48.0, 59.94, 60.0, 120.0, 0.0])
        jitter = rng.uniform(-0.02, 0.02) if rng.random() < 0.3 else 0.0
        plan = eng.on_source_frame(pts + jitter, fps)
        check_plan(eng, plan)
        dt = 1.0 / fps if fps > 0 else 1.0 / 24.0
        pts += dt * (1.0 if rng.random() > 0.02 else rng.uniform(0.0, 3.0))


def test_pathological_fps_values():
    eng = CadenceEngine(60.0)
    for fps in (0.0, 1e-9, 1e9, 1.0, 1000.0):
        plan = eng.on_source_frame(0.0, fps)
        check_plan(eng, plan)


def test_backwards_pts_recovers():
    eng = CadenceEngine(60.0)
    for i in range(5):
        eng.on_source_frame(i / 24, 24.0)
    # pts jumps backwards by 10s: drift > 50ms -> inconsistent fallback
    plan = eng.on_source_frame(-10.0, 24.0)
    assert plan.inconsistent_detected
    assert plan.outputs[0].pts == pytest.approx(-10.0)
    check_plan(eng, plan)


def test_output_rate_conservation_under_jitter():
    """Long-run output count tracks the ideal ratio even with pts jitter."""
    rng = random.Random(42)
    eng = CadenceEngine(60.0)
    n_out = 0
    for i in range(2000):
        plan = eng.on_source_frame(i / 24 + rng.uniform(-0.005, 0.005), 24.0)
        n_out += len(plan.outputs) if not plan.passthrough else 1
    assert abs(n_out - 2000 * 2.5) / (2000 * 2.5) < 0.01
