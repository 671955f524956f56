"""chip_smoke.py's own logic, on the CPU: it must refuse to run anywhere
but a GPU, its last line has one fixed shape, and its CLI phase asks for
the headline configuration.  Also the compile-cache placement rule and
the block-timed samples the quality controller is fed."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path=os.path.join(ROOT, "chip_smoke.py"), name="chip_smoke_t"):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_without_gpu_exits_nonzero_and_prints_no_result(tmp_path, where):
    """No GPU (JAX_PLATFORMS=cpu), in the checkout and in a directory
    holding only the script: a non-zero exit and no `"ok": true`."""
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd, script = str(tmp_path), str(tmp_path / "chip_smoke.py")
    else:
        cwd, script = ROOT, os.path.join(ROOT, "chip_smoke.py")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_alone_with_a_device_still_fails(tmp_path, monkeypatch, capsys):
    """Past the device check, a directory without the package fails
    (no stand-in for the program) and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    mod = _load(str(tmp_path / "chip_smoke.py"), "chip_smoke_alone")
    monkeypatch.setattr(mod, "require_gpu", lambda d: {
        "platform": "gpu", "kind": "test", "count": 1})
    monkeypatch.setattr(mod, "card_line", lambda: "test card, 1 W")
    monkeypatch.setattr(mod, "build_native", lambda: (_ for _ in ()).throw(
        ImportError("No module named 'mpv_frame_interpolator'")))
    assert mod.main() == 1
    out = capsys.readouterr()
    assert '"ok": true' not in out.out
    assert "mpv_frame_interpolator" in out.err


def test_require_gpu_rejects_the_cpu():
    mod = _load()
    with pytest.raises(mod.PhaseError, match="no GPU"):
        mod.require_gpu(jax.devices())
    with pytest.raises(mod.PhaseError):
        mod.require_gpu([])


def test_last_line_shape():
    mod = _load()

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    device = mod.require_gpu([Dev()])
    line = mod.result_line(device)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3",
                               "count": 1}}


def test_cli_phase_asks_for_the_headline_configuration():
    mod = _load()
    from mpv_frame_interpolator.cli import build_parser
    args = build_parser().parse_args(mod.cli_args("moving_box", "s.json"))
    assert (args.width, args.height) == (3840, 2160)
    assert (args.fps, args.display_fps) == (24.0, 120.0)
    assert args.model == "hopper" and args.search_radius == 16
    assert args.mode == "blend" and args.no_auto_quality
    assert args.frames >= 12
    # 24->120: the first frame passes through, then 5 outputs per pair
    assert mod.expected_outputs(12) == 1 + 5 * 11


@pytest.mark.parametrize("env_dir", ["/somewhere/else", None])
def test_compile_cache_rule(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: the program sets no cache dir.
    Unset: the cache lands in <checkout>/.jax_cache, at that fixed
    path, set on JAX's config by the engine."""
    from mpv_frame_interpolator.utils import compile_cache
    from mpv_frame_interpolator.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    InterpolationEngine(EngineConfig(compile_cache=True,
                                     background_precompile=False))
    dirs = [v for k, v in updates if k == "jax_compilation_cache_dir"]
    if env_dir:
        assert compile_cache.compile_cache_dir() is None
        assert dirs == []
    else:
        want = os.path.join(ROOT, ".jax_cache")
        assert compile_cache.compile_cache_dir() == want
        assert dirs == [want]
    # the CPU suite turns it off
    updates.clear()
    InterpolationEngine(EngineConfig(compile_cache=False,
                                     background_precompile=False))
    assert updates == []


def test_block_timed_samples_reach_the_controller():
    """Every warm push feeds the quality controller the wall time until
    its last output is ready (block_until_ready), and logs it."""
    from mpv_frame_interpolator.io import synthetic
    from mpv_frame_interpolator.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    e = InterpolationEngine(EngineConfig(
        display_fps=120.0, auto_quality=False, measure_timing=True,
        background_precompile=False))
    seen = []
    update = e.quality.update

    def spy(duration, cadence):
        seen.append(duration)
        return update(duration, cadence)

    e.quality.update = spy
    blocked = []
    for f in synthetic.moving_box(cfg, 10):
        outs = e.push(f)
        if outs and not outs[-1]._host:
            blocked.append(outs[-1])
    # nothing is measured before the first pair, and the first pair
    # compiles (24->120 runs one batch size); every later push is a
    # block-timed sample
    assert len(seen) == 9 and seen[:2] == [0.0, 0.0]
    assert all(0.0 < d < 60.0 for d in seen[2:])
    assert e.stats.summary()["source_frame_time"]["count"] == 8
    assert blocked
