"""NativeIndexedSource: C++ indexed pread ring over MKV/MP4 raw video.

The container is parsed once in Python (frame-offset index); the native
thread preads payloads into recycled buffers (I420 chroma interleaved to
NV12 on the same pass).  Must be byte-identical to the pure-Python
readers, recycle every buffer, and seek in O(1) via a ring restart.
"""

import numpy as np
import pytest

from mpv_frame_interpolator.io import ingest
from mpv_frame_interpolator.io.mkv import MKVReader
from mpv_frame_interpolator.io.mp4 import MP4Reader

from test_mkv import build_mkv
from test_mp4 import build_mp4

pytestmark = pytest.mark.skipif(
    not (ingest.have_native_ingest()
         and hasattr(ingest._native, "IndexedRing")),
    reason="native extension not built")


@pytest.fixture()
def frames(small_cfg):
    from mpv_frame_interpolator.io import synthetic
    return list(synthetic.moving_box(small_cfg, 7))


def collect(src, recycle=True):
    out = []
    for f in src:
        out.append((f.pts, f.y.copy(), f.uv.copy()))
        if recycle and f.recycle is not None:
            f.recycle()
    return out


class TestIndexedRingMKV:
    @pytest.mark.parametrize("colour,layout", [(b"I420", "i420"),
                                               (b"NV12", "nv12")])
    def test_matches_python_reader(self, tmp_path, frames, colour, layout):
        p = tmp_path / "t.mkv"
        p.write_bytes(build_mkv(frames, 64, 48, colour=colour,
                                layout=layout))
        expect = [(f.pts, f.y, f.uv) for f in MKVReader(str(p))]
        src = ingest.NativeIndexedSource(MKVReader(str(p)))
        got = collect(src)
        assert len(got) == len(expect) == 7
        for (pe, ye, uve), (pg, yg, uvg) in zip(expect, got):
            assert pg == pytest.approx(pe, abs=1e-9)
            np.testing.assert_array_equal(ye, yg)
            np.testing.assert_array_equal(uve, uvg)
        s = src.stats()
        assert s["frames_read"] == 7
        assert s["recycled"] == 7
        src.close()

    def test_seek(self, tmp_path, frames):
        p = tmp_path / "t.mkv"
        p.write_bytes(build_mkv(frames, 64, 48))
        src = ingest.NativeIndexedSource(MKVReader(str(p)))
        assert src.seekable() and src.n_frames() == 7
        src.seek_pts(5 / 24.0)
        got = collect(src)
        assert len(got) == 2
        np.testing.assert_array_equal(got[0][1], frames[5].y)
        src.seek_frame(0)
        assert len(collect(src)) == 7
        # pts continue on the container grid after the restart
        src.seek_frame(3)
        got = collect(src)
        assert got[0][0] == pytest.approx(3 / 24.0, abs=2e-3)
        src.close()

    def test_open_container_prefers_native(self, tmp_path, frames):
        p = tmp_path / "t.mkv"
        p.write_bytes(build_mkv(frames, 64, 48))
        src = ingest.open_container(str(p))
        assert isinstance(src, ingest.NativeIndexedSource)
        assert len(collect(src)) == 7
        src.close()


class TestIndexedRingMP4:
    @pytest.mark.parametrize("fourcc,layout", [(b"I420", "i420"),
                                               (b"NV12", "nv12")])
    def test_matches_python_reader(self, tmp_path, frames, fourcc, layout):
        p = tmp_path / "t.mp4"
        p.write_bytes(build_mp4(frames, 64, 48, fourcc=fourcc,
                                layout=layout))
        expect = [(f.pts, f.y, f.uv) for f in MP4Reader(str(p))]
        src = ingest.open_container(str(p))
        assert isinstance(src, ingest.NativeIndexedSource)
        got = collect(src)
        assert len(got) == len(expect) == 7
        for (pe, ye, uve), (pg, yg, uvg) in zip(expect, got):
            assert pg == pytest.approx(pe, abs=1e-9)
            np.testing.assert_array_equal(ye, yg)
            np.testing.assert_array_equal(uve, uvg)
        src.close()

    def test_pipeline_end_to_end(self, tmp_path, frames):
        """Full Pipeline run off the indexed ring (engine stage() calls the
        recycle hooks)."""
        from mpv_frame_interpolator.io.sinks import NullSink
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        from mpv_frame_interpolator.pipeline.player import Pipeline
        p = tmp_path / "t.mp4"
        p.write_bytes(build_mp4(frames, 64, 48))
        src = ingest.open_container(str(p))
        eng = InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False, measure_timing=False,
            background_precompile=False))
        pipe = Pipeline(src, eng, NullSink(block=True), present=None)
        n = pipe.run()
        assert n >= 7
        assert src.stats()["recycled"] >= 5
        src.close()
