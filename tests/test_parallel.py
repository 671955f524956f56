"""Multi-device sharding + pair parallelism on the 8-device virtual mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mpv_frame_interpolator.frame import split_chroma
from mpv_frame_interpolator.io import synthetic
from mpv_frame_interpolator.ops.flow import FlowGeometry, make_flow_fn
from mpv_frame_interpolator.parallel.batch import PairParallelPool
from mpv_frame_interpolator.parallel.sharding import (
    make_mesh, sharded_flow_fn)
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)

from conftest import frame_pair, planar


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """Drop every accumulated compiled executable before this module's
    big sharded compiles: XLA:CPU's codegen segfaults this host's LLVM
    deterministically at test_parallel when ~300 programs have
    accumulated in-process (backend_compile_and_load; NOT reproducible
    with a short prefix -- the module alone passes), even with
    --xla_cpu_parallel_codegen_split_count=1.  Clearing the caches
    releases the prior executables' JIT state at the cost of a few
    small-program recompiles later in the suite."""
    jax.clear_caches()
    yield


class TestLayerShardedFlow:
    def test_matches_single_device(self, small_cfg):
        assert len(jax.devices()) == 8
        f1, f2 = frame_pair(small_cfg, "gradient_pan")
        geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride, f1.fmt.width)
        mesh = make_mesh()
        radius = 16
        a = [jnp.asarray(x) for x in (*planar(f1), *planar(f2))]
        off_s, blur_s = sharded_flow_fn(geom, radius, mesh)(
            *a, jnp.int32(8), jnp.int32(6))
        off_r, blur_r = make_flow_fn(geom, radius)(
            *a, jnp.int32(8), jnp.int32(6))
        np.testing.assert_array_equal(np.asarray(off_r), np.asarray(off_s))
        np.testing.assert_array_equal(np.asarray(blur_r), np.asarray(blur_s))


class TestPairParallel:
    def test_outputs_match_single_engine(self, small_cfg):
        cfgkw = dict(scene_detection=False, auto_quality=False,
                     measure_timing=False, initial_search_radius=5)
        frames = list(synthetic.moving_box(small_cfg, 5))
        single = InterpolationEngine(EngineConfig(**cfgkw))
        outs_1 = []
        for f in frames:
            outs_1.extend(single.push(f))
        pool = PairParallelPool(EngineConfig(**cfgkw))
        outs_n = list(pool.run(frames))
        assert len(outs_1) == len(outs_n)
        for a, b in zip(outs_1, outs_n):
            assert a.pts == pytest.approx(b.pts)
            va, vb = a.to_video_frame(), b.to_video_frame()
            np.testing.assert_array_equal(va.y, vb.y)
            np.testing.assert_array_equal(va.uv, vb.uv)

    def test_uses_multiple_devices(self, small_cfg):
        pool = PairParallelPool(EngineConfig(
            scene_detection=False, auto_quality=False, measure_timing=False))
        frames = list(synthetic.moving_box(small_cfg, 4))
        outs = list(pool.run(frames))
        devs = {next(iter(o._y.devices())).id for o in outs if not o._host}
        assert len(devs) >= 2   # pairs landed on distinct devices


class TestMultiStream:
    def test_batched_matches_single(self, small_cfg):
        from mpv_frame_interpolator.parallel.streams import MultiStreamEngine
        import dataclasses as dc
        cfgs = [dc.replace(small_cfg, seed=small_cfg.seed + k)
                for k in range(3)]
        sources = [list(synthetic.gradient_pan(c, 4)) for c in cfgs]

        kw = dict(scene_detection=False, auto_quality=False,
                  measure_timing=False, initial_search_radius=5)
        # reference: three independent single engines
        singles = [InterpolationEngine(EngineConfig(**kw)) for _ in range(3)]
        expect = [[] for _ in range(3)]
        for step in range(4):
            for k in range(3):
                expect[k].extend(singles[k].push(sources[k][step]))

        ms = MultiStreamEngine(EngineConfig(**kw), n_streams=3)
        got = [[] for _ in range(3)]
        for step in range(4):
            outs = ms.push_batch([sources[k][step] for k in range(3)])
            for k, frames in outs.items():
                got[k].extend(frames)

        for k in range(3):
            assert len(expect[k]) == len(got[k])
            for a, b in zip(expect[k], got[k]):
                assert a.pts == pytest.approx(b.pts)
                va, vb = a.to_video_frame(), b.to_video_frame()
                np.testing.assert_array_equal(va.y, vb.y)
                np.testing.assert_array_equal(va.uv, vb.uv)

    def test_idle_stream_and_mixed_cadence(self, small_cfg):
        from mpv_frame_interpolator.parallel.streams import MultiStreamEngine
        ms = MultiStreamEngine(EngineConfig(
            scene_detection=False, auto_quality=False,
            measure_timing=False), n_streams=2)
        frames = list(synthetic.moving_box(small_cfg, 3))
        outs0 = ms.push_batch([frames[0], None])
        assert 0 in outs0 and 1 not in outs0
        outs1 = ms.push_batch([frames[1], frames[0]])
        assert len(outs1[0]) == 3      # stream 0 interpolating
        assert len(outs1[1]) == 1      # stream 1 anchor passthrough

    def test_geometry_mismatch_rejected(self, small_cfg):
        from mpv_frame_interpolator.parallel.streams import MultiStreamEngine
        ms = MultiStreamEngine(EngineConfig(scene_detection=False,
                                            auto_quality=False,
                                            measure_timing=False),
                               n_streams=2)
        big = synthetic.SyntheticConfig(width=128, height=96)
        f_small = next(iter(synthetic.moving_box(small_cfg, 1)))
        f_big = next(iter(synthetic.moving_box(big, 1)))
        with pytest.raises(ValueError, match="share one geometry"):
            ms.push_batch([f_small, f_big])

    def test_vmapped_dispatch_matches_sequential(self, small_cfg):
        from mpv_frame_interpolator.parallel.streams import MultiStreamEngine
        import dataclasses as dc
        kw = dict(scene_detection=False, auto_quality=False,
                  measure_timing=False, initial_search_radius=5)
        cfgs = [dc.replace(small_cfg, seed=small_cfg.seed + k)
                for k in range(2)]
        sources = [list(synthetic.gradient_pan(c, 3)) for c in cfgs]
        a = MultiStreamEngine(EngineConfig(**kw), n_streams=2)
        b = MultiStreamEngine(EngineConfig(**kw), n_streams=2,
                              batch_dispatch=True)
        for step in range(3):
            ra = a.push_batch([sources[k][step] for k in range(2)])
            rb = b.push_batch([sources[k][step] for k in range(2)])
            assert set(ra) == set(rb)
            for sid in ra:
                for x, y in zip(ra[sid], rb[sid]):
                    np.testing.assert_array_equal(
                        np.asarray(x.to_video_frame().y),
                        np.asarray(y.to_video_frame().y))


class TestRowShardedWarp:
    def test_matches_unsharded(self, small_cfg):
        import jax.numpy as jnp
        from mpv_frame_interpolator.ops import oracle
        from mpv_frame_interpolator.ops.warp import make_warp_fn, BLENDED_FRAME
        from mpv_frame_interpolator.parallel.sharding import (
            make_mesh, row_sharded_warp_fn)
        f1, f2 = frame_pair(small_cfg, "gradient_pan")
        geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride, f1.fmt.width)
        _, blur = oracle.calculate_optical_flow(
            f1.y, f1.uv, f2.y, f2.uv, search_radius=5,
            res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
        a = [jnp.asarray(x) for x in (*planar(f1), *planar(f2))]
        args = (*a, jnp.asarray(blur.astype(np.int32)), jnp.float32(0.4),
                jnp.float32(0.0), jnp.float32(255.0))
        ry, ru, rv = make_warp_fn(geom, BLENDED_FRAME)(*args)
        sy, su, sv = row_sharded_warp_fn(geom, BLENDED_FRAME, make_mesh())(*args)
        np.testing.assert_array_equal(np.asarray(ry), np.asarray(sy))
        np.testing.assert_array_equal(np.asarray(ru), np.asarray(su))
