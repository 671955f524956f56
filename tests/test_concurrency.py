"""Concurrency smoke: control surfaces hammered while playback runs.

The reference runs the player core, VO thread, demux thread, and client
API threads against each other and ships TSAN configs to keep that honest
(SURVEY §5.2).  This test drives the rebuild's equivalent topology: the
pipeline plays on one thread while IPC-style property access, applet
codes, pause/step, and seeks hit it from others.  The contract is "no
crash, no deadlock, invariants hold" -- the same thing a sanitizer run
checks.
"""

import random
import threading
import time

import pytest

from mpv_frame_interpolator.api import Player, PropertyError
from mpv_frame_interpolator.control.applet import apply_command_code
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.io.y4m import Y4MReader, Y4MWriter
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator.pipeline.player import Pipeline


class _Sink:
    def __init__(self):
        self.count = 0

    def write(self, out):
        self.count += 1

    def close(self):
        pass


def test_control_surfaces_under_playback(small_cfg, tmp_path):
    path = tmp_path / "in.y4m"
    with open(path, "wb") as fh:
        w = Y4MWriter(fh, 64, 48, 24.0)
        for f in synthetic.moving_box(small_cfg, 120):
            w.write(f)
    rdr = Y4MReader(open(path, "rb"))
    engine = InterpolationEngine(EngineConfig(
        scene_detection=True, auto_quality=True, measure_timing=True,
        background_precompile=True))
    sink = _Sink()
    pipe = Pipeline(rdr, engine, sink, present=None)
    player = Player(engine=engine)
    player.bind_pipeline(pipe)

    # Pre-warm every (batch size x layer bucket) spec OUTSIDE the timed
    # window: on a loaded 1-core host, a cold XLA:CPU compile inside the
    # window (the bg-precompile thread's, or a radius change crossing a
    # cold bucket) starves the pipeline for minutes and the 180 s budget
    # then measures compile throughput, not concurrency (observed: 130 s
    # of bg compile -> spurious "deadlock").  The bg thread still runs --
    # it just finds everything warm -- so the thread/flag/atexit topology
    # is exercised while the clock only sees compute.
    for f in synthetic.moving_box(small_cfg, 2):
        engine.push(f)
    engine._precompile()
    engine.reset()

    stop = threading.Event()
    errors = []

    def hammer_properties(seed):
        r = random.Random(seed)
        names = player.property_names()
        while not stop.is_set():
            try:
                name = r.choice(names)
                player.get_property(name)
                if r.random() < 0.3:
                    player.set_property("speed", r.choice([1.0, 1.5, 2.0]))
                if r.random() < 0.2:
                    player.set_property("search-radius", r.randint(5, 16))
            except PropertyError:
                pass
            except Exception as e:     # noqa: BLE001 - the test's point
                errors.append(e)
                return

    def hammer_applet(seed):
        r = random.Random(seed)
        while not stop.is_set():
            try:
                apply_command_code(engine, r.randint(-5, 900))
            except Exception as e:     # noqa: BLE001
                errors.append(e)
                return
            time.sleep(0.001)

    def hammer_transport(seed):
        r = random.Random(seed)
        while not stop.is_set():
            try:
                act = r.random()
                if act < 0.3:
                    pipe.seek(r.uniform(0.0, 4.0))
                elif act < 0.6:
                    pipe.set_pause(True)
                    time.sleep(0.01)
                    pipe.frame_step()
                    pipe.set_pause(False)
                else:
                    player.command("seek-reset")
            except Exception as e:     # noqa: BLE001
                errors.append(e)
                return
            time.sleep(0.02)

    threads = [threading.Thread(target=hammer_properties, args=(1,)),
               threading.Thread(target=hammer_properties, args=(2,)),
               threading.Thread(target=hammer_applet, args=(3,)),
               threading.Thread(target=hammer_transport, args=(4,))]
    for t in threads:
        t.start()
    runner = threading.Thread(target=pipe.run)
    runner.start()
    # Liveness contract: DEADLOCK means no forward progress, not "slow".
    # A fixed 180 s wall budget failed spuriously whenever other
    # processes loaded the 1-core host (the same playback passes alone
    # in ~250 s); instead, poll output progress and only call deadlock
    # when the sink count stalls for a full 120 s while the runner is
    # still alive.  An absolute 900 s ceiling still bounds the test.
    last_count, last_progress = -1, time.monotonic()
    deadline = time.monotonic() + 900
    while runner.is_alive() and time.monotonic() < deadline:
        runner.join(timeout=5)
        if sink.count != last_count:
            last_count, last_progress = sink.count, time.monotonic()
        elif time.monotonic() - last_progress > 120:
            break
    stop.set()
    for t in threads:
        t.join(timeout=10)

    assert not runner.is_alive(), "pipeline deadlocked under concurrency"
    assert not errors, f"control-surface errors: {errors[:3]}"
    # "made real progress" -- the exact count depends on how the random
    # seeks interleave with playback and on host load (46 observed on a
    # loaded 1-core host), so keep a generous margin over zero
    assert sink.count > 20
    # invariants survived the hammering
    q = engine.quality
    assert q.min_radius <= q.search_radius <= q.max_radius
    assert 0.0 <= engine.black_level <= 255.0
    assert engine.cadence.target_frame_time > 0
