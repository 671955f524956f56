"""Device-side quality metrics.

PSNR/SAD computed on the device so quality monitoring never downloads frames
(the serving host may be remote from the consumer; BASELINE config #3
recommends keeping outputs on-device and only sampling metrics).  Used by
the PsnrSink device path and by bench/validation drives.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("peak",))
def psnr_device(a, b, peak: int = 255):
    """PSNR between two equal-shape integer planes; returns a 0-dim f32
    device scalar (inf-safe: returns 999.0 for identical planes)."""
    d = a.astype(jnp.float32) - b.astype(jnp.float32)
    mse = jnp.mean(d * d)
    return jnp.where(mse == 0, jnp.float32(999.0),
                     10.0 * jnp.log10(jnp.float32(peak * peak) / mse))


@jax.jit
def mean_abs_diff(a, b):
    """Mean |a-b| (the scene detector's metric, available standalone)."""
    return jnp.mean(jnp.abs(a.astype(jnp.int32)
                            - b.astype(jnp.int32)).astype(jnp.float32))
