#!/usr/bin/env python
"""Bring-up check on one GPU: the interpolator's main path, end to end.

    python chip_smoke.py

Phases, each printing one line (the parity phase one per check):

  (a) device   JAX must find a GPU; the card's name and power limit
               (nvidia-smi), and whether the native host extension
               ``_mfi_native`` was built from ``native/*.cpp`` (built here
               with ``python setup.py build_ext --inplace``).
  (b) cli      the CLI (``cli.main``) at 3840x2160 NV12 24->120, hopper
               family, radius 16, blended mode, on ``synthetic:moving_box``
               and ``synthetic:gradient_pan``, run in this process: source
               and output frame counts and the warm wall ms per source
               pair.  Informational, not a benchmark.
  (c) parity   the engine's fused source-pair step at 4K against
               ``ops/oracle.py`` for two pairs of each content, then the
               ``utils/parity.FULL_CASES`` x every mode matrix.
  (d) tests    the ``gpu``-marked pytest tests, in this process (a second
               JAX process could not get the card's memory).

Every phase runs in this one process.  Any failure exits non-zero and
prints no result; with no GPU the script stops at (a).  The last line
of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 3840, 2160
SRC_FPS, DST_FPS = 24, 120
RADIUS = 16
CONTENTS = ("moving_box", "gradient_pan")
CLI_FRAMES = 12
PARITY_PAIRS = 2


class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def require_gpu(devices) -> dict:
    """The device record of the last line; raises unless JAX's devices
    are GPUs (no CPU stand-in)."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise PhaseError(f"no GPU: JAX's default platform is {plat}")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def result_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def build_native() -> bool:
    """Build ``_mfi_native`` in place from the committed sources (a
    compiler run, not a JAX process); False when it cannot be built --
    the package then runs its Python fallbacks."""
    r = subprocess.run([sys.executable, "setup.py", "build_ext", "--inplace"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        print(r.stderr[-2000:], file=sys.stderr)
    from mpv_frame_interpolator import native
    return bool(native.HAVE_NATIVE)


def cli_args(content: str, stats_path: str) -> list:
    return [f"synthetic:{content}", "--width", str(WIDTH),
            "--height", str(HEIGHT), "--fps", str(SRC_FPS),
            "--display-fps", str(DST_FPS), "--frames", str(CLI_FRAMES),
            "--model", "hopper", "--search-radius", str(RADIUS),
            "--no-auto-quality", "--mode", "blend", "--untimed",
            "--no-resume", "--dump-stats", stats_path]


def expected_outputs(n_src: int) -> int:
    """24->120: the first frame passes through, then 5 per source pair."""
    return 1 + (DST_FPS // SRC_FPS) * (n_src - 1)


def phase_cli(card: str):
    from mpv_frame_interpolator import cli
    for content in CONTENTS:
        with tempfile.TemporaryDirectory() as tmp:
            stats_path = os.path.join(tmp, "stats.json")
            t0 = time.perf_counter()
            rc = cli.main(cli_args(content, stats_path))
            wall = time.perf_counter() - t0
            with open(stats_path) as fh:
                stats = json.load(fh)
        n_in, n_out = stats["frames_in"], stats["frames_out"]
        pair = stats["stats"].get("source_frame_time", {})
        line = (f"(b) cli {content} {WIDTH}x{HEIGHT} {SRC_FPS}->{DST_FPS}: "
                f"{n_in} source -> {n_out} output frames, warm wall "
                f"{pair.get('mean', 0.0) * 1e3:.2f} ms/pair mean, "
                f"{pair.get('p99', 0.0) * 1e3:.2f} p99 over "
                f"{pair.get('count', 0)} pairs ({wall:.1f} s with compile) "
                f"on {card}")
        print(line, flush=True)
        if rc != 0 or n_in != CLI_FRAMES \
                or n_out != expected_outputs(n_in):
            raise PhaseError(f"cli {content}: rc={rc}, {n_in} in, "
                             f"{n_out} out, expected "
                             f"{expected_outputs(CLI_FRAMES)}")


def report(label: str, rows) -> bool:
    bad = [r for r in rows if not r[1]]
    for name, ok, n_diff, max_diff in rows:
        if n_diff:
            print(f"    {name}: {n_diff} samples differ, max |diff| "
                  f"{max_diff} -> {'within tolerance' if ok else 'FAIL'}",
                  flush=True)
    print(f"(c) parity {label}: {len(rows) - len(bad)}/{len(rows)} rows "
          f"pass", flush=True)
    return not bad


def phase_parity():
    from mpv_frame_interpolator.utils import parity
    ok = True
    for content in CONTENTS:
        rows = parity.timed_path_parity(content, n_pairs=PARITY_PAIRS,
                                        width=WIDTH, height=HEIGHT,
                                        src_fps=SRC_FPS,
                                        display_fps=DST_FPS, radius=RADIUS)
        ok &= report(f"timed path {content} {WIDTH}x{HEIGHT} "
                     f"({PARITY_PAIRS} pairs)", rows)
    rows = parity.run_parity(parity.FULL_CASES,
                             modes=tuple(parity.MODE_NAMES), levels=True)
    ok &= report("matrix FULL_CASES x modes", rows)
    if not ok:
        raise PhaseError("oracle parity failed")


class _Outcomes:
    """pytest plugin: count test outcomes of the in-process run."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1


def phase_tests():
    import pytest
    counts = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(ROOT, "tests", "test_gpu_parity.py")],
                     plugins=[counts])
    print(f"(d) tests -m gpu: {counts.passed} passed, {counts.failed} "
          f"failed, {counts.skipped} skipped (pytest rc {int(rc)})",
          flush=True)
    if rc != 0 or counts.failed or counts.skipped or not counts.passed:
        raise PhaseError("gpu-marked tests did not all pass")


def main() -> int:
    sys.path.insert(0, ROOT)
    # no background-precompile thread: it would compile every other
    # batch size and layer bucket at 4K while the phases run
    os.environ.setdefault("MFI_BG_PRECOMPILE", "0")
    try:
        import jax
        device = require_gpu(jax.devices())
        card = card_line()
        native = build_native()
        print(f"(a) device {device['platform']} {device['kind']} x"
              f"{device['count']}; card {card}; _mfi_native "
              f"{'built' if native else 'NOT built (Python fallbacks)'}",
              flush=True)
        phase_cli(card)
        phase_parity()
        phase_tests()
    except (PhaseError, ImportError, OSError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(card, flush=True)
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
