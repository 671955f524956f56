"""Device profiling hooks (the OpenCL-event-timing analog, SURVEY.md §5.1).

The reference times its kernels with CL_QUEUE_PROFILING_ENABLE events
(opticalFlowCalc.c:389-391,111-122) and exposes renderer pass timings via
VOCTRL_PERFORMANCE_DATA.  The rebuild's equivalents:

* wall timing around block_until_ready at the measurement edges (engine
  stats registry, already wired);
* this module: jax.profiler capture of full device traces for offline
  inspection (tensorboard / xprof), plus a convenience timer.
"""

from __future__ import annotations

import contextlib
import time

import jax

from mpv_frame_interpolator.utils import get_logger

log = get_logger("trace")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace of everything inside the block."""
    jax.profiler.start_trace(log_dir)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("device trace (%.2fs) written to %s",
                 time.perf_counter() - t0, log_dir)


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in profiler traces."""
    with jax.profiler.TraceAnnotation(name):
        yield


def timed_block(fn, *args, sync=True):
    """(result, seconds) with a device sync, for ad-hoc kernel timing."""
    t0 = time.perf_counter()
    out = fn(*args)
    if sync:
        jax.block_until_ready(out)
    return out, time.perf_counter() - t0
