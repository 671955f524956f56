"""Profiler tracing helpers (utils/trace.py) smoke tests."""

import jax.numpy as jnp

from mpv_frame_interpolator.utils.trace import annotate, timed_block


def test_annotate_and_timed_block():
    with annotate("test-region"):
        x = jnp.arange(16) * 2
    out, secs = timed_block(lambda a: a + 1, x)
    assert secs >= 0.0
    assert int(out[0]) == 1
