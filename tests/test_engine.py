"""End-to-end InterpolationEngine tests: cadence + flow + warp on CPU."""

import numpy as np
import pytest

from mpv_frame_interpolator.frame import FrameFormat, VideoFrame, psnr_arrays
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.ops import oracle
from mpv_frame_interpolator.ops.flow import FlowGeometry
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator.pipeline.cadence import InterpolationState


def make_engine(**kw):
    kw.setdefault("scene_detection", False)
    kw.setdefault("auto_quality", False)
    kw.setdefault("measure_timing", False)
    # deterministic timing in tests: no concurrent warm thread discarding
    # measurements (engine suppresses timings while it runs)
    kw.setdefault("background_precompile", False)
    return InterpolationEngine(EngineConfig(**kw))


def run(engine, frames):
    outs = []
    for f in frames:
        outs.extend(engine.push(f))
    return outs


class TestEngineE2E:
    def test_24_to_60_output_count_and_pts(self, small_cfg):
        eng = make_engine()
        frames = list(synthetic.moving_box(small_cfg, 5))
        outs = run(eng, frames)
        # 1 passthrough + 3+2+3+2 warps
        assert len(outs) == 11
        pts = [o.pts for o in outs]
        assert pts == sorted(pts)
        # outputs after the anchor step at 1/60
        steps = np.diff(pts[1:])
        np.testing.assert_allclose(steps, 1 / 60, atol=1e-9)

    def test_oracle_parity_full_pipeline(self, small_cfg):
        """The engine's warped outputs must match an oracle-driven
        simulation of the reference pipeline bit-exactly."""
        eng = make_engine()
        frames = list(synthetic.moving_box(small_cfg, 4))
        outs = run(eng, frames)

        geom = FlowGeometry.create(frames[0].fmt.height,
                                   frames[0].fmt.stride,
                                   frames[0].fmt.width)
        # simulate: for each consecutive pair, oracle flow + warps at the
        # cadence blend values (3 outputs then 2, starting at b=0)
        blends = [[0.0, 0.4, 0.8], [0.2, 0.6], [0.0, 0.4, 0.8]]
        k = 1  # outs[0] is the passthrough first frame
        assert np.array_equal(outs[0].to_video_frame().y, frames[0].y)
        for i, bl in enumerate(blends):
            f1, f2 = frames[i], frames[i + 1]
            _, blur = oracle.calculate_optical_flow(
                f1.y, f1.uv, f2.y, f2.uv, search_radius=5,
                res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
            for t in bl:
                ry, ruv = oracle.warp_frame(
                    f1.y, f1.uv, f2.y, f2.uv, blur, t,
                    oracle.BLENDED_FRAME, geom.res_scalar, geom.actual_width)
                got = outs[k].to_video_frame()
                np.testing.assert_array_equal(ry, got.y, err_msg=f"pair {i} t={t}")
                np.testing.assert_array_equal(ruv, got.uv, err_msg=f"pair {i} t={t}")
                k += 1
        assert k == len(outs)

    def test_bypass_high_fps(self, small_cfg):
        eng = make_engine()
        cfg60 = synthetic.SyntheticConfig(width=64, height=48, fps=60.0)
        outs = run(eng, list(synthetic.moving_box(cfg60, 3)))
        assert len(outs) == 3  # passthrough every frame
        assert eng.cadence.state == InterpolationState.NOT_NEEDED

    def test_seek_reset_reanchors(self, small_cfg):
        eng = make_engine()
        frames = list(synthetic.moving_box(small_cfg, 3))
        run(eng, frames)
        eng.reset()
        far = [f.with_pts(f.pts + 100.0) for f in
               synthetic.moving_box(small_cfg, 3)]
        for f in far:
            f.nominal_fps = 24.0
        outs2 = run(eng, far)
        assert outs2[0].pts == pytest.approx(100.0)

    def test_scene_cut_snaps_instead_of_blending(self, small_cfg):
        eng = make_engine(scene_detection=True, scene_threshold=28.0)
        frames = list(synthetic.scene_cut(small_cfg, 6, cut_at=3))
        outs = run(eng, frames)
        # engine still produces the cadence count
        assert len(outs) == 1 + 3 + 2 + 3 + 2 + 3
        # outputs for the cut pair (frames[2] -> frames[3], b = 0.0,0.4,0.8)
        # must equal zero-flow warps snapped to nearest source, not blends
        geom = FlowGeometry.create(frames[0].fmt.height,
                                   frames[0].fmt.stride, frames[0].fmt.width)
        zero_flow = np.zeros((2, geom.low_h, geom.low_w), np.int16)
        cut_outs = outs[6:9]
        for t, o in zip([0.0, 0.4, 0.8], cut_outs):
            t_snap = 1.0 if t >= 0.5 else 0.0
            ry, ruv = oracle.warp_frame(
                frames[2].y, frames[2].uv, frames[3].y, frames[3].uv,
                zero_flow, t_snap, oracle.BLENDED_FRAME,
                geom.res_scalar, geom.actual_width)
            got = o.to_video_frame()
            np.testing.assert_array_equal(ry, got.y)

    def test_p010_pipeline(self):
        cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                        pixfmt="p010")
        eng = make_engine()
        outs = run(eng, list(synthetic.moving_box(cfg, 3)))
        assert len(outs) == 1 + 3 + 2
        f = outs[2].to_video_frame()
        assert f.y.dtype == np.uint16
        # content is 8-bit shifted; outputs must stay on the 16-bit scale
        assert f.y.max() > 255

    def test_p010_flow_matches_nv12(self):
        """P010 content that is 8-bit<<8 must produce the identical flow
        field (the luma_shift folds the scale back out)."""
        cfg8 = synthetic.SyntheticConfig(width=64, height=48, fps=24.0)
        cfg16 = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                          pixfmt="p010")
        e8, e16 = make_engine(), make_engine()
        for f8, f16 in zip(synthetic.moving_box(cfg8, 3),
                           synthetic.moving_box(cfg16, 3)):
            e8.push(f8)
            e16.push(f16)
        np.testing.assert_array_equal(np.asarray(e8._blurred),
                                      np.asarray(e16._blurred))


class TestSbs2FirstFrame:
    def test_sbs2_interpolates_first_frame(self, small_cfg):
        # SideBySide2 interpolates from source frame 1
        # (vf_HopperRender.c:495); pair = frame with itself -> zero flow
        eng = make_engine(frame_output_mode=6)
        frames = list(synthetic.moving_box(small_cfg, 2))
        outs1 = eng.push(frames[0])
        assert len(outs1) == 3   # full cadence slots, not a passthrough
        got = outs1[0].to_video_frame()
        assert got.fmt.width == frames[0].fmt.width
        outs2 = eng.push(frames[1])
        assert len(outs2) == 2   # blending scalar advanced on frame 1


class TestGeometrySwitch:
    def test_resolution_change_reinits(self, small_cfg):
        eng = make_engine()
        outs = run(eng, list(synthetic.moving_box(small_cfg, 3)))
        assert len(outs) == 6
        big = synthetic.SyntheticConfig(width=128, height=96, fps=24.0)
        outs2 = run(eng, list(synthetic.moving_box(big, 3)))
        # new geometry: frame 1 is a fresh anchor passthrough
        assert len(outs2) == 6
        assert eng.geom.actual_width == 128
        f = outs2[-1].to_video_frame()
        assert f.fmt.width == 128

    def test_pixfmt_change_reinits(self, small_cfg):
        eng = make_engine()
        run(eng, list(synthetic.moving_box(small_cfg, 2)))
        p10 = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                        pixfmt="p010")
        outs = run(eng, list(synthetic.moving_box(p10, 2)))
        assert outs[-1].to_video_frame().y.dtype == np.uint16


class TestQualityController:
    def _cad(self):
        from mpv_frame_interpolator.pipeline.cadence import CadenceEngine
        c = CadenceEngine(60.0)
        c.on_source_frame(0.0, 24.0)
        return c

    def test_decrements_then_too_slow_with_patience(self):
        from mpv_frame_interpolator.pipeline.quality import QualityController
        c = self._cad()
        q = QualityController(search_radius=7, too_slow_patience=3)
        slow = c.source_frame_time  # way over budget (x1.4 > sft)
        q.update(slow, c)
        assert q.search_radius == 6
        q.update(slow, c)
        assert q.search_radius == 5
        q.update(slow, c)  # streak 1
        q.update(slow, c)  # streak 2
        assert c.state.name == "ACTIVE"
        q.update(slow, c)  # streak 3 -> TooSlow
        assert c.state.name == "TOO_SLOW"

    def test_hiccup_does_not_disable(self):
        from mpv_frame_interpolator.pipeline.quality import QualityController
        c = self._cad()
        q = QualityController(search_radius=5, too_slow_patience=3)
        fast = c.source_frame_time / 10
        q.update(c.source_frame_time, c)   # one hiccup at floor
        q.update(fast, c)
        q.update(c.source_frame_time, c)
        q.update(fast, c)
        assert c.state.name == "ACTIVE"

    def test_reference_parity_patience_1(self):
        from mpv_frame_interpolator.pipeline.quality import QualityController
        c = self._cad()
        q = QualityController(search_radius=5, too_slow_patience=1)
        q.update(c.source_frame_time, c)
        assert c.state.name == "TOO_SLOW"

    def test_recovers_radius_upward(self):
        from mpv_frame_interpolator.pipeline.quality import QualityController
        c = self._cad()
        q = QualityController(search_radius=5)
        for _ in range(20):
            q.update(c.source_frame_time / 10, c)
        assert q.search_radius == 16


class TestColorimetryPassthrough:
    def test_hdr_tags_survive(self):
        import dataclasses
        cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                        pixfmt="p010")
        frames = list(synthetic.moving_box(cfg, 3))
        hdr = dataclasses.replace(frames[0].fmt, primaries="bt.2020",
                                  transfer="pq", matrix="bt.2020nc")
        frames = [VideoFrame(f.y, f.uv, hdr, f.pts, f.nominal_fps)
                  for f in frames]
        eng = make_engine()
        outs = run(eng, frames)
        out_fmt = outs[-1].fmt
        assert (out_fmt.primaries, out_fmt.transfer, out_fmt.matrix) == \
            ("bt.2020", "pq", "bt.2020nc")


class TestConfigValidation:
    """Startup validation (vf_HopperRender.c:585-622 analog)."""

    @pytest.mark.parametrize("kw", [
        dict(max_calc_res=32),
        dict(num_iterations=-1),
        dict(initial_search_radius=1),
        dict(initial_search_radius=300),
        dict(frame_output_mode=7),
        dict(display_fps=0),
        dict(cut_policy="bogus"),
    ])
    def test_rejects_bad_config(self, kw):
        with pytest.raises(ValueError):
            EngineConfig(**kw)


class TestP010LevelsSpec:
    """The 16-bit level mapping is defined as the exact-rational
    generalization of the 8-bit formula: out = floor((b - 256k)*255/(w-k))
    clamped to [0, 65280]. Verify the device path against a direct numpy
    evaluation of that spec."""

    def test_levels16_spec(self):
        import jax.numpy as jnp
        from mpv_frame_interpolator.ops.warp import _levels_y, _levels_uv
        rng = np.random.default_rng(5)
        b = rng.integers(0, 65536, 4096).astype(np.int32)
        for k, w in ((16.0, 235.0), (0.0, 255.0), (32.0, 200.0)):
            got = np.asarray(_levels_y(jnp.asarray(b), jnp.float32(k),
                                       jnp.float32(w), 8))
            n = np.maximum((b.astype(np.int64) - (int(k) << 8)) * 255, 0)
            want = np.minimum(n // max(int(w) - int(k), 1), 255 << 8)
            np.testing.assert_array_equal(want, got)
        for w in (255.0, 219.0):
            got = np.asarray(_levels_uv(jnp.asarray(b), jnp.float32(w), 8))
            m = 128 << 8
            n = np.maximum((b.astype(np.int64) - m) * 255 + m * int(w), 0)
            want = np.minimum(n // int(w), 255 << 8)
            np.testing.assert_array_equal(want, got)


class TestStatsLog:
    def test_per_frame_stats_log(self, small_cfg, tmp_path):
        path = str(tmp_path / "ofclog.txt")
        eng = make_engine(measure_timing=True, stats_log_path=path)
        frames = list(synthetic.moving_box(small_cfg, 4))
        for f in frames:
            for o in eng.push(f):
                o.block()
        lines = open(path).read().splitlines()
        # warm-gated: at least one measured line once specialization is warm
        assert len(lines) >= 1
        assert all(float(x) >= 0 for x in lines)


class TestModeSwitchMidStream:
    def test_output_mode_change_between_frames(self, small_cfg):
        from mpv_frame_interpolator.control.applet import apply_command_code
        eng = make_engine()
        frames = list(synthetic.moving_box(small_cfg, 4))
        outs = []
        outs.extend(eng.push(frames[0]))
        outs.extend(eng.push(frames[1]))
        apply_command_code(eng, 6)   # switch to GreyFlow mid-stream
        o3 = eng.push(frames[2])
        outs.extend(o3)
        # grey-flow frames: neutral chroma everywhere
        vf = o3[0].to_video_frame()
        assert np.all(vf.uv == 128)
        apply_command_code(eng, 4)   # back to blended
        o4 = eng.push(frames[3])
        vf4 = o4[0].to_video_frame()
        assert not np.all(vf4.uv == 128)
        assert len(outs) + len(o4) == 1 + 3 + 2 + 3


class TestStageIdempotent:
    def test_stage_twice(self, small_cfg):
        import jax
        eng = make_engine()
        f = next(iter(synthetic.moving_box(small_cfg, 1)))
        s1 = eng.stage(f)
        s2 = eng.stage(s1)          # already-staged frames pass through
        assert s2 is s1
        assert isinstance(s1.y, jax.Array)
        outs = eng.push(s1)         # staged frames feed push directly
        assert len(outs) == 1


class TestStatsReset:
    def test_stats_reset(self):
        from mpv_frame_interpolator.utils import StatsRegistry
        s = StatsRegistry()
        s.add("a", 1.0)
        with s.time("b"):
            pass
        assert s.summary()
        s.reset()
        assert s.summary() == {}


class TestBatchBucketing:
    def test_bucketed_outputs_bit_exact(self, small_cfg):
        """batch_shapes='bucket' pads the warp batch but must emit exactly
        the same frames as the exact-shape mode."""
        import numpy as np
        frames = list(synthetic.gradient_pan(small_cfg, 5))
        exact = make_engine(batch_shapes="exact")
        bucket = make_engine(batch_shapes="bucket")
        outs_e, outs_b = [], []
        for f in frames:
            outs_e.extend(exact.push(f))
            outs_b.extend(bucket.push(f))
        assert len(outs_e) == len(outs_b)
        for a, b in zip(outs_e, outs_b):
            assert a.pts == b.pts
            ya, _ = a.device_planes()
            yb, _ = b.device_planes()
            np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))

    def test_vfr_uses_few_specializations(self, small_cfg):
        """A VFR source producing varied per-pair counts compiles only a
        handful of bucketed programs."""
        import dataclasses as dc
        eng = make_engine(batch_shapes="bucket", display_fps=120.0)
        pts, t = [], 0.0
        rates = [24.0, 25.0, 30.0, 20.0, 48.0]
        frames = list(synthetic.gradient_pan(small_cfg, 15))
        for i, f in enumerate(frames):
            r = rates[i % len(rates)]
            frames[i] = dc.replace(f, pts=t, nominal_fps=r)
            t += 1.0 / r
        for f in frames:
            eng.push(f)
        sizes = {spec[1] for spec in eng._warm}
        from mpv_frame_interpolator.pipeline.engine import _BUCKETS
        assert sizes <= set(_BUCKETS)
        assert len(sizes) <= 4
