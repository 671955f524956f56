"""Test environment: the CPU backend with 8 virtual devices, so the
sharding tests run without an accelerator.  Tests that need the GPU
carry the ``gpu`` marker and skip here (see the ``gpu`` fixture)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# NO persistent compile cache under pytest (MFI_COMPILE_CACHE=0 turns
# it off): the suite is one process, so the in-memory jit cache already
# dedups every program, and the cache only adds risk -- the shared cache
# can hold AOT artifacts for a DIFFERENT host CPU ("could lead to
# execution errors such as SIGILL"), and XLA:CPU's executable.serialize()
# has segfaulted outright WRITING certain programs (observed in
# jax's compilation_cache.put_executable_and_time during
# test_parallel.py even with a fresh tempdir cache).
os.environ.setdefault("MFI_COMPILE_CACHE", "0")
# no background-precompile threads under pytest: concurrent XLA:CPU
# compiles (warm thread + test thread) have segfaulted the compiler here;
# the tests that exercise the warm path re-enable it explicitly
os.environ.setdefault("MFI_BG_PRECOMPILE", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# SERIALIZED codegen: XLA:CPU's parallel codegen (LLVM splits compiled
# modules across a thread pool) segfaults this host's compiler late in
# the suite -- deterministically at test_parallel's per-device step
# compile after ~300 accumulated programs, backtrace in
# backend_compile_and_load, NOT reproducible with a short prefix.
# split_count=1 keeps every compile single-threaded; the same suite
# then passes.  Compiles get slower (the CLI subprocess tests inherit
# this too), which the affected timeouts budget for.
if "xla_cpu_parallel_codegen_split_count" not in flags:
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags

# --- full-suite crash guard (round 5, VERDICT r4 #1) ------------------
# ROOT CAUSE of the mid-suite XLA:CPU death (r4: segfault 3x in
# TestHopperQ; r5 repro runs died at 27%/48%/56%/64% as SIGSEGV in
# _Unwind_Find_FDE, clean test failures, or an LLVM RuntimeDyld
# abort): the process hits the kernel's vm.max_map_count wall.  Every
# XLA:CPU compiled object stays loaded as an anonymous r-xp + r--p +
# rw-p mapping TRIPLE and is never unmapped; the full suite accumulates
# ~21,600 JIT objects = ~65k mappings, exactly the default 65,530
# limit (counted from the crash-time /proc/self/maps captured by
# tools/segv_backtrace.c).  Past the wall every mmap fails and the
# failure surfaces wherever the next allocation lands -- which is why
# the crash point moved between runs, every test passes alone, and
# neither executable keep-alive nor eh-frame patching (runs 2/4, see
# tests/_ehframe_patch.py for that diagnostic) could fix it.  Raise
# the limit at session start (root inside the sandbox; idempotent,
# persists per boot); if it cannot be raised, warn loudly so a future
# death at ~65k mappings is attributable in seconds.
try:
    with open("/proc/sys/vm/max_map_count", "r+") as _mmf:
        _cur = int(_mmf.read().strip())
        if _cur < 262144:
            _mmf.seek(0)
            _mmf.write("262144")
except OSError as _e:  # pragma: no cover - depends on sandbox privs
    import warnings

    warnings.warn(
        f"could not raise vm.max_map_count ({_e}); the full suite "
        "accumulates ~65k mappings of never-unloaded XLA:CPU JIT "
        "objects and will die at the default 65,530 limit")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mpv_frame_interpolator.frame import FrameFormat, VideoFrame, split_chroma  # noqa: E402
from mpv_frame_interpolator.io import synthetic  # noqa: E402


@pytest.fixture(scope="session")
def small_cfg():
    # 64x48: res_scalar = 0 path; fast on CPU
    return synthetic.SyntheticConfig(width=64, height=48, fps=24.0)


@pytest.fixture(scope="session")
def pyramid_cfg():
    # tall enough that res_scalar > 0 (height 544 >> 1 = 272 > 270 -> rs 2)
    return synthetic.SyntheticConfig(width=96, height=544, fps=24.0)


@pytest.fixture
def gpu():
    """The GPU device for ``gpu``-marked tests; skips when JAX's default
    device is anything else.  Decided here, at run time, so every xdist
    worker collects the same tests."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform}); "
                    "run `python chip_smoke.py` on the card")
    return dev


@pytest.fixture(autouse=True)
def _drain_warm_threads():
    """Join any background-precompile threads at test teardown: a warm
    thread left compiling past its test's window races later tests'
    compiles (concurrent XLA:CPU compiles have segfaulted the compiler
    on this host -- observed in jax's compilation-cache write path)."""
    yield
    from mpv_frame_interpolator.pipeline import engine as em
    if em._warm_threads:
        if em._warm_shutdown is not None:
            em._warm_shutdown.set()
        for t in em._warm_threads:
            t.join(timeout=300.0)
        em._warm_threads.clear()
        if em._warm_shutdown is not None:
            em._warm_shutdown.clear()


def frame_pair(cfg, source="moving_box", **kw):
    gen = getattr(synthetic, source)(cfg, 2, **kw)
    f1 = next(gen)
    f2 = next(gen)
    return f1, f2


def planar(frame: VideoFrame):
    u, v = split_chroma(frame.uv)
    return frame.y, u, v
