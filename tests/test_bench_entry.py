"""The driver-facing artifacts must keep working: bench.py prints one JSON
line; __graft_entry__.entry() lowers."""

import importlib.util
import json
import sys

import pytest


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestBench:
    def test_bench_emits_one_json_line(self, monkeypatch, capsys):
        monkeypatch.setenv("MFI_BENCH_WIDTH", "64")
        monkeypatch.setenv("MFI_BENCH_HEIGHT", "48")
        monkeypatch.setenv("MFI_BENCH_FRAMES", "4")
        monkeypatch.setenv("MFI_BENCH_RADIUS", "5")
        bench = _load("bench.py", "bench_under_test")
        rc = bench.main()
        out = capsys.readouterr().out.strip().splitlines()
        assert rc == 0
        payload = json.loads(out[-1])
        assert payload["unit"] == "frames/sec"
        assert payload["value"] > 0
        assert "vs_baseline" in payload and "p99_e2e_latency_ms" in payload
        # every line names the device its numbers were taken on
        assert payload["platform"] == "cpu"
        assert payload["device_count"] >= 1 and payload["device_kind"]


class TestBenchHonestP99:
    def test_honest_p99_block_executes(self, monkeypatch, capsys):
        """The per-pair p99 latency path (push -> the pair's last output
        ready) must run wherever the bench runs, the CPU included: a
        path only the card executes ships broken."""
        monkeypatch.setenv("MFI_BENCH_WIDTH", "64")
        monkeypatch.setenv("MFI_BENCH_HEIGHT", "48")
        monkeypatch.setenv("MFI_BENCH_FRAMES", "8")
        monkeypatch.setenv("MFI_BENCH_RADIUS", "5")
        monkeypatch.setenv("MFI_BENCH_SKIP_DEFAULT", "1")
        bench = _load("bench.py", "bench_p99_under_test")
        assert bench.main() == 0
        payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert payload["p99_pair_latency_ms"] > 0
        assert "p99_pair_target_met" in payload
        assert payload["push_ms_per_pair"] > 0


class TestGraftEntry:
    def test_entry_lowers(self):
        import jax
        m = _load("__graft_entry__.py", "graft_entry_under_test")
        fn, args = m.entry()
        lowered = jax.jit(fn).lower(*args)
        assert lowered is not None


class TestOddGeometries:
    """Uncommon resolutions through the whole engine (geometry math:
    ceil low dims, non-pow2 windows, partial edge windows)."""

    @pytest.mark.parametrize("w,h", [(100, 56), (146, 82), (64, 36),
                                     (202, 150)])
    def test_engine_handles(self, w, h):
        from mpv_frame_interpolator.io import synthetic
        from mpv_frame_interpolator.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        cfg = synthetic.SyntheticConfig(width=w, height=h, fps=24.0)
        e = InterpolationEngine(EngineConfig(scene_detection=False,
                                             auto_quality=False,
                                             measure_timing=False))
        outs = []
        for f in synthetic.moving_box(cfg, 3):
            outs.extend(e.push(f))
        assert len(outs) == 6
        vf = outs[-1].to_video_frame()
        assert vf.fmt.width == w and vf.y.shape == (h, w)


@pytest.mark.skipif(not __import__("os").environ.get("MFI_SLOW_TESTS"),
                    reason="slow: ~3min of sharded compiles on 1 CPU core "
                           "(the driver runs dryrun_multichip itself)")
class TestDryrunMultichip:
    def test_dryrun_8(self):
        m = _load("__graft_entry__.py", "graft_entry_dryrun")
        m.dryrun_multichip(8)


class TestBenchP010:
    def test_bench_p010_knob(self, monkeypatch, capsys):
        monkeypatch.setenv("MFI_BENCH_WIDTH", "64")
        monkeypatch.setenv("MFI_BENCH_HEIGHT", "48")
        monkeypatch.setenv("MFI_BENCH_FRAMES", "3")
        monkeypatch.setenv("MFI_BENCH_RADIUS", "5")
        monkeypatch.setenv("MFI_BENCH_P010", "1")
        monkeypatch.setenv("MFI_BENCH_MODEL", "hopperq")
        bench = _load("bench.py", "bench_p010_under_test")
        assert bench.main() == 0
        payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "p010" in payload["metric"] and "hopperq" in payload["metric"]
        assert payload["value"] > 0
