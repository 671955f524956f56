"""Cross-cutting infrastructure: hierarchical logging, stats registry,
profiler tracing (utils/trace.py)."""

from mpv_frame_interpolator.utils.logging import get_logger  # noqa: F401
from mpv_frame_interpolator.utils.stats import StatsRegistry  # noqa: F401
