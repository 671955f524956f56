"""Where the persistent XLA compile cache lives.

The rule: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and the program sets no cache directory.  Otherwise the cache goes to
``.jax_cache`` at the root of the checkout (listed in ``.gitignore``): a
fixed path, because the path is part of the cache's key, so a directory
that moves (temp, per-pid, per-run) never hits.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

CHECKOUT = Path(__file__).resolve().parents[2]


def compile_cache_dir(environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """The directory the program should set, or None when the
    environment already chooses one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Apply the rule to JAX's config; returns the directory set, if any."""
    path = compile_cache_dir()
    if path is None:
        return None
    import jax
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
