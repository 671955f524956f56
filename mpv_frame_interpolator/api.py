"""Embedding API: a libmpv-style handle around the interpolation pipeline.

The reference's embedding surface is the libmpv client API
(player/client.c, include/mpv/client.h): commands, typed properties with
observers, and an event stream.  This module is the rebuild's equivalent
for hosts embedding the interpolator: a `Player` owns the engine and
exposes the runtime-mutable state as named properties (the same set the
reference exposes through filter options, applet codes and mpv properties).

    p = Player(EngineConfig(display_fps=60))
    p.observe_property("search-radius", print)
    p.set_property("speed", 2.0)
    for out in p.feed(frame):
        ...
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional

from mpv_frame_interpolator.frame import VideoFrame

from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine, OutputFrame)
from mpv_frame_interpolator.utils import get_logger

log = get_logger("api")


class EventType(enum.Enum):
    PROPERTY_CHANGE = "property-change"
    STATE_CHANGE = "state-change"
    FRAMES_OUT = "frames-out"
    SEEK_RESET = "seek-reset"
    END_OF_STREAM = "end-of-stream"


@dataclasses.dataclass
class Event:
    type: EventType
    name: str = ""
    data: Any = None


class PropertyError(KeyError):
    pass


class Player:
    """Command/property/event surface over one InterpolationEngine."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 engine: Optional[InterpolationEngine] = None):
        self.engine = engine if engine is not None \
            else InterpolationEngine(config)
        self.pipeline = None     # optional Pipeline binding (for seek etc.)
        self._observers: Dict[str, List[Callable[[str, Any], None]]] = {}
        self._events: "collections.deque[Event]" = collections.deque(maxlen=1024)
        self._event_cv = threading.Condition()
        self._last_state = self.engine.cadence.state

        e = self.engine
        # property registry: name -> (getter, setter-or-None)
        self._props = {
            "speed": (lambda: e.cadence.playback_speed, e.set_speed),
            "display-fps": (lambda: 1.0 / e.cadence.target_frame_time,
                            self._set_display_fps),
            "source-fps": (lambda: e.cadence.source_fps, None),
            "frame-output-mode": (lambda: e.frame_output_mode,
                                  self._set_mode),
            "search-radius": (lambda: e.quality.search_radius,
                              self._set_radius),
            "auto-quality": (lambda: e.quality.enabled,
                             self._set_auto_quality),
            "interpolation-state": (lambda: e.cadence.state.name, None),
            "black-level": (lambda: e.black_level,
                            lambda v: setattr(e, "black_level", float(v))),
            "white-level": (lambda: e.white_level,
                            lambda v: setattr(e, "white_level", float(v))),
            "delta-scalar": (lambda: e.delta_scalar,
                             lambda v: setattr(e, "delta_scalar", int(v))),
            "neighbor-bias-scalar": (
                lambda: e.neighbor_bias_scalar,
                lambda v: setattr(e, "neighbor_bias_scalar", int(v))),
            "scene-detection": (lambda: e.scene.enabled,
                                lambda v: setattr(e.scene, "enabled", bool(v))),
            "scene-threshold": (lambda: e.scene.threshold,
                                lambda v: setattr(e.scene, "threshold", float(v))),
            "model": (lambda: e.config.model, self._set_model),
            # mpv core pause (requires a bound Pipeline; player/command.c)
            "pause": (self._get_pause, self._set_pause),
            "max-calc-res": (lambda: e.config.max_calc_res,
                             self._set_max_calc_res),
            "blending-scalar": (lambda: e.cadence.blending_scalar, None),
            "source-frame-num": (lambda: e.cadence.source_frame_num, None),
            "num-int-frames": (lambda: e.cadence.num_int_frames, None),
            "stats": (lambda: e.stats.summary(), None),
            # telemetry mirrors of the applet status fields
            # (vf_HopperRender.c:194-202).  Reading them enables the
            # engine's split flow/warp measurement (engine.split_timing);
            # the first read may return 0.0 until a pair has been measured.
            "ofc-time": (self._split_stat("flow_time"), None),
            "warp-time": (self._split_stat("warp_time"), None),
            "total-time": (lambda: e.stats.last("source_frame_time"), None),
            "calc-res": (self._calc_res, None),
            "scene-cut-score": (e.last_cut_score, None),
            # playlist surface (player/loadfile.c playlist properties);
            # single-file playback reads pos 0 / count 1
            "playlist-pos": (self._playlist_stat("entry_index", 0), None),
            "playlist-count": (self._playlist_stat("_entries", 1,
                                                   len), None),
            "time-pos": (lambda: e.cadence.current_output_pts, None),
        }

    # ---- properties -----------------------------------------------------

    def property_names(self) -> List[str]:
        return sorted(self._props)

    def get_property(self, name: str) -> Any:
        if name not in self._props:
            raise PropertyError(name)
        return self._props[name][0]()

    def set_property(self, name: str, value: Any):
        if name not in self._props:
            raise PropertyError(name)
        setter = self._props[name][1]
        if setter is None:
            raise PropertyError(f"property {name!r} is read-only")
        setter(value)
        self._notify(name, self.get_property(name))

    def observe_property(self, name: str,
                         callback: Callable[[str, Any], None]):
        if name not in self._props:
            raise PropertyError(name)
        self._observers.setdefault(name, []).append(callback)
        callback(name, self.get_property(name))

    def _notify(self, name: str, value: Any):
        self._push_event(Event(EventType.PROPERTY_CHANGE, name, value))
        for cb in self._observers.get(name, []):
            try:
                cb(name, value)
            except Exception:  # observer bugs must not kill playback
                log.exception("property observer for %r failed", name)

    def _split_stat(self, name: str):
        def get():
            self.engine.request_split_timing()
            return self.engine.stats.last(name)
        return get

    def _playlist_stat(self, attr: str, default, fn=lambda x: x):
        def get():
            src = getattr(self.pipeline, "source", None)
            v = getattr(src, attr, None)
            return fn(v) if v is not None else default
        return get

    def _get_pause(self):
        return bool(self.pipeline.paused) if self.pipeline else False

    def _set_pause(self, v):
        if self.pipeline is None:
            raise PropertyError("no pipeline bound; pause unavailable")
        self.pipeline.set_pause(bool(v))

    def _set_mode(self, v):
        self.engine.frame_output_mode = int(v)

    def _set_radius(self, v):
        self.engine.quality.search_radius = max(
            self.engine.quality.min_radius,
            min(int(v), self.engine.quality.max_radius))

    def _set_auto_quality(self, v):
        self.engine.quality.enabled = bool(v)

    def _set_model(self, v):
        from mpv_frame_interpolator import models as _models
        self.engine.config.model = _models.validate(str(v))

    def _set_max_calc_res(self, v):
        """Quality knob beyond the reference (hard 270-row cap, config.h:2):
        raises/lowers the flow resolution; re-derives geometry on the next
        source frame (recompile, so not a per-frame knob)."""
        v = int(v)
        if v < 64:
            raise ValueError("max-calc-res must be >= 64")
        self.engine.config.max_calc_res = v
        self.engine._fmt = None   # force geometry re-derivation

    def _calc_res(self):
        g = self.engine.geom
        if g is None:
            return "0x0"
        return f"{g.stride >> g.res_scalar}x{g.height >> g.res_scalar}"

    def _set_display_fps(self, v):
        """Display refresh changed (monitor hot-swap / mode switch): the
        reference queries the VO once at filter creation
        (vf_HopperRender.c:676-682) and cannot adapt; here the cadence
        retargets and resyncs like a speed change."""
        fps = float(v)
        if fps <= 0:
            raise ValueError("display-fps must be positive")
        self.engine.cadence.target_frame_time = 1.0 / fps
        self.engine.cadence.resync = True

    # ---- commands (mpv_command analog) ----------------------------------

    def bind_pipeline(self, pipeline):
        """Attach the running Pipeline so source-level commands (seek)
        reach the demuxer, the way mpv commands reach the playloop."""
        self.pipeline = pipeline

    def command(self, name: str, *args) -> Any:
        if name == "set-property" or name == "set_property":
            return self.set_property(args[0], args[1])
        if name == "get-property" or name == "get_property":
            return self.get_property(args[0])
        if name == "seek":
            if self.pipeline is None:
                raise PropertyError("no pipeline bound; seek unavailable")
            self.pipeline.seek(float(args[0]))
            self._push_event(Event(EventType.SEEK_RESET, data=float(args[0])))
            return None
        if name == "frame-step":
            if self.pipeline is None:
                raise PropertyError("no pipeline bound; frame-step "
                                    "unavailable")
            self.pipeline.frame_step()
            return None
        if name == "seek-reset":
            self.engine.reset()
            self._push_event(Event(EventType.SEEK_RESET))
            return None
        if name == "applet-code":   # raw settings-applet protocol code
            from mpv_frame_interpolator.control.applet import (
                apply_command_code)
            return apply_command_code(self.engine, int(args[0]))
        if name in ("quit", "quit-watch-later"):
            # stop playback at the next frame boundary (player/command.c
            # quit; quit-watch-later's position save is the CLI's exit
            # path when wired with --save-position-on-quit)
            if self.pipeline is None:
                raise PropertyError("no pipeline bound; quit unavailable")
            self.pipeline.quit()
            return None
        if name == "screenshot":
            # grab the current video frame as a color PNG
            # (player/screenshot.c screenshot command; encoder is the
            # in-repo utils/png.py since FFmpeg may be absent).  Optional
            # arg = output path; default mpv-style shot_NNNN.png in cwd.
            if self.pipeline is None or self.pipeline.last_output is None:
                raise PropertyError("no frame to screenshot yet")
            from mpv_frame_interpolator.io.convert import frame_to_rgb
            from mpv_frame_interpolator.utils.png import write_png
            out = self.pipeline.last_output
            if args and args[0]:
                path = str(args[0])
            else:
                n = getattr(self, "_shot_count", 0)
                self._shot_count = n + 1
                path = f"shot_{n:04d}.png"
            return write_png(path, frame_to_rgb(out.to_video_frame()))
        raise PropertyError(f"unknown command {name!r}")

    # ---- frames ----------------------------------------------------------

    def feed(self, frame: VideoFrame) -> List[OutputFrame]:
        outs = self.engine.push(frame)
        if self.engine.cadence.state is not self._last_state:
            self._last_state = self.engine.cadence.state
            self._push_event(Event(EventType.STATE_CHANGE,
                                   data=self._last_state.name))
            self._notify("interpolation-state", self._last_state.name)
        if outs:
            self._push_event(Event(EventType.FRAMES_OUT, data=len(outs)))
        return outs

    def feed_all(self, source: Iterable[VideoFrame]):
        for frame in source:
            yield from self.feed(frame)
        self._push_event(Event(EventType.END_OF_STREAM))

    # ---- events (mpv_wait_event analog) ----------------------------------

    def _push_event(self, ev: Event):
        with self._event_cv:
            self._events.append(ev)
            self._event_cv.notify_all()

    def wait_event(self, timeout: Optional[float] = 0.0) -> Optional[Event]:
        with self._event_cv:
            if not self._events and timeout:
                self._event_cv.wait(timeout)
            return self._events.popleft() if self._events else None
