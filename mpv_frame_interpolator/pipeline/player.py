"""Pipeline orchestrator: source -> prefetch -> engine -> present -> sink.

The rebuild's playloop (player/playloop.c:1251 analog), with the reference's
thread topology mapped to an accelerator host:

* a reader thread + bounded queue stands in for the demux thread + packet
  cache (demux/demux.c:2549,1187) -- host decode overlaps device compute;
* the engine dispatches device work asynchronously; the present step is the
  single sync point per output frame (the reference's blocking
  downloadFrame, opticalFlowCalc.c:109-124, hit once per output);
* commands (speed/seek) are applied between source frames, like
  mp_output_chain_command routing into the filter
  (vf_HopperRender.c:541-555).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Optional

from mpv_frame_interpolator.frame import VideoFrame
from mpv_frame_interpolator.pipeline.engine import (
    InterpolationEngine, OutputFrame)
from mpv_frame_interpolator.pipeline.present import PresentClock
from mpv_frame_interpolator.utils import get_logger

log = get_logger("player")

_EOF = object()


class _Prefetcher:
    """Reader thread + bounded frame queue (demux-thread analog).

    With a `stage` callable (engine.stage), the async host->HBM upload is
    started from this thread, so device copies overlap both decode and
    compute -- the double-buffered upload pipeline of BASELINE config #3."""

    def __init__(self, source: Iterable[VideoFrame], depth: int = 4,
                 stage=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stage = stage
        self._thread = threading.Thread(target=self._run, args=(source,),
                                        daemon=True)
        self._stop = threading.Event()
        self._thread.start()

    def _run(self, source):
        try:
            for frame in source:
                if self._stop.is_set():
                    break
                if self._stage is not None:
                    frame = self._stage(frame)
                self._q.put(frame)
        except Exception as e:   # surface decode errors at the consumer
            self._q.put(e)
        finally:
            self._q.put(_EOF)

    def __iter__(self):
        import time as _time
        while True:
            t0 = _time.perf_counter()
            item = self._q.get()
            self.last_wait = _time.perf_counter() - t0
            if item is _EOF:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    last_wait: float = 0.0

    def stop(self):
        """Stop and JOIN the reader thread (it must not touch the source
        file handle after this returns -- a queued seek repositions it)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    item = self._q.get_nowait()
                    # return pooled buffers of frames that never reached
                    # the engine (unstaged frames still own them)
                    if getattr(item, "recycle", None) is not None:
                        item.recycle()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


class Pipeline:
    def __init__(self, source: Iterable[VideoFrame],
                 engine: InterpolationEngine, sink,
                 present: Optional[PresentClock] = None,
                 prefetch: int = 4, stage_uploads: bool = True,
                 fail_open: bool = True, adapt_display_rate: bool = True,
                 group: int = 1):
        self.source = source
        self.engine = engine
        self.sink = sink
        self.present = present
        self.prefetch = prefetch
        self.stage_uploads = stage_uploads
        # pair-grouped dispatch for the transcode path (engine.push_many):
        # one device program per `group` pairs amortizes the fixed
        # per-dispatch host cost (unmeasured on the GPU).  Adds up
        # to `group` source intervals of latency, so it is an encode-path
        # knob only -- the reference's encode path likewise rides the
        # same async in-order queue as playback rather than a per-frame
        # sync (opticalFlowCalc.c:96-124, video/out/vo_lavc.c)
        self.group = max(int(group), 1)
        # filter-failure semantics (filters/filter.h:359-362 +
        # vf_HopperRender.c ERR_CHECK): a failed filter drops out of the
        # chain and playback continues with source frames passed through
        self.fail_open = fail_open
        self.engine_failed = False
        # display-sync adaptation (vo.c:416 check_estimated_display_fps
        # analog): retarget the cadence to the MEASURED refresh when the
        # presentation feedback shows a stable, nearby estimate (e.g.
        # 59.94Hz panel driven with a nominal 60)
        self.adapt_display_rate = adapt_display_rate
        # decoder-level framedrop (check_framedrop analog,
        # player/video.c:315-332): sustained late presents shed whole
        # source frames; the cadence re-anchors over the pts gap
        self.drop_late_sources = True
        self.sources_dropped = 0
        self._late_streak = 0
        # source-underrun detection (VO-starvation analog,
        # player/video.c:1078-1088 + demux underrun states): counts frames
        # where the decoder could not keep the prefetch queue fed
        self.underruns = 0
        self.frames_in = 0
        self.frames_out = 0
        # the most recent output that reached the sink (the "current
        # video frame" the screenshot command grabs, player/screenshot.c)
        self.last_output = None
        self.seeks = 0
        self._pending_seek: Optional[float] = None
        self._commands: "queue.Queue" = queue.Queue()
        # pause state (mpv core pause, player/playloop.c pause handling):
        # cleared = paused.  frame-step = unpause for exactly one source
        # frame's outputs (player/command.c frame-step).
        self._unpaused = threading.Event()
        self._unpaused.set()
        self._step_frames = 0
        # quit request (mpv `quit` command): ends run() at the next
        # frame boundary, flushing the sink normally
        self._quit = False
        self.paused = False
        # --loop-file / --end analogs (options/options.c): loop counts
        # ADDITIONAL plays (-1 = forever); end_pts stops playback at a
        # source timestamp
        self.loop = 0
        self.end_pts: Optional[float] = None
        self._eof_stop = False

    # -- runtime command surface (mp_filter_command analog) --------------

    def set_speed(self, speed: float):
        self._commands.put(("speed", speed))

    def seek_reset(self):
        self._commands.put(("reset", None))

    def seek(self, pts: float):
        """Queue a source-side seek (execute_queued_seek analog,
        player/playloop.c:1294): flush the prefetcher, reposition the
        source, reset the engine + present clock.  Requires a seekable
        source (io/y4m.py readers); otherwise degrades to seek_reset."""
        self._commands.put(("seek", float(pts)))

    def set_pause(self, paused: bool):
        """mpv `pause` property: halt consumption between source frames;
        the present clock re-anchors on resume so the vblank grid does
        not accumulate the paused wall time."""
        self.paused = bool(paused)
        if paused:
            self._unpaused.clear()
        else:
            self._commands.put(("resync-present", None))
            self._unpaused.set()

    def quit(self):
        """Stop playback at the next frame boundary (mpv quit command);
        safe from any thread."""
        self._quit = True
        self._unpaused.set()

    def frame_step(self):
        """mpv `frame-step`: while paused, advance by one source frame's
        outputs, then stay paused."""
        self._step_frames += 1
        self._unpaused.set()

    def source_seekable(self) -> bool:
        s = self.source
        return hasattr(s, "seek_pts") and getattr(s, "seekable", lambda: False)()

    def _apply_commands(self):
        try:
            while True:
                cmd, arg = self._commands.get_nowait()
                if cmd == "speed":
                    self.engine.set_speed(arg)
                elif cmd == "reset":
                    self.engine.reset()
                    if self.present:
                        self.present.reset()
                elif cmd == "resync-present":
                    if self.present:
                        self.present.reset()
                elif cmd == "seek":
                    if self.source_seekable():
                        self._pending_seek = arg
                    else:
                        log.warning("seek requested on an unseekable "
                                    "source; resetting filter state only")
                        self.engine.reset()
                        if self.present:
                            self.present.reset()
        except queue.Empty:
            pass

    def _maybe_adapt_display_rate(self):
        """Retarget the cadence to the measured refresh rate once the
        estimate is stable and plausibly the same mode (within 5% of the
        nominal; vo.c:416-450 uses the same idea with stricter windows).
        Untimed runs never adapt (flip intervals are meaningless)."""
        pc = self.present
        if not self.adapt_display_rate or pc.untimed or pc.presented < 128:
            return
        est = pc.estimated_display_fps()
        nominal = pc.display_fps
        if est <= 0 or abs(est - nominal) / nominal > 0.05:
            return
        if pc.vsync_jitter() > 0.2 * pc.vsync_interval:
            return
        new_tft = 1.0 / est
        if abs(new_tft - self.engine.cadence.target_frame_time) > 1e-9:
            log.info("display-sync: retargeting cadence to measured "
                     "%.4f Hz (nominal %.4f)", est, nominal)
            self.engine.cadence.target_frame_time = new_tft

    def _execute_seek(self, pts: float):
        """Reposition the source + reset downstream state (the reference's
        seek path: demux_seek + reset_video_state + the filter's own seek
        reset, player/video.c:98 + vf_HopperRender.c:562-567)."""
        actual = self.source.seek_pts(pts)
        self.engine.reset()
        if self.present:
            self.present.reset()
        self.seeks += 1
        log.info("seeked to %.3fs (requested %.3fs)", actual, pts)

    def run(self, max_source_frames: Optional[int] = None):
        try:
            while True:
                restart = self._run_segment(max_source_frames)
                if restart:
                    continue
                if (self.loop != 0 and not self._eof_stop
                        and self.source_seekable()
                        and not (max_source_frames
                                 and self.frames_in >= max_source_frames)):
                    if self.loop > 0:
                        self.loop -= 1
                    log.info("looping (remaining: %s)",
                             "inf" if self.loop < 0 else self.loop)
                    self._execute_seek(0.0)
                    continue
                break
        finally:
            self.sink.close()
        return self.frames_out

    def _run_segment_grouped(self, max_source_frames: Optional[int]) -> bool:
        """Transcode fast path (self.group > 1): buffer source frames and
        dispatch them pair-grouped through engine.push_many -- identical
        outputs to push() (tests/test_push_many.py strict equivalence),
        one device program per `group` pairs.  Realtime niceties that
        need per-frame pacing (pause, seek, late-frame shedding,
        display-rate adaptation) are not available here by design; quit
        and --end are honored at group boundaries.  Present pacing is
        skipped (grouped mode implies untimed encode)."""
        self._eof_stop = False
        reader = _Prefetcher(self.source, self.prefetch,
                             stage=self.engine.stage if self.stage_uploads
                             else None)

        def _flush(buf):
            if not buf:
                return
            try:
                outs = self.engine.push_many(buf, group_size=self.group)
            except Exception:
                if not self.fail_open:
                    raise
                log.exception("grouped engine dispatch failed; passing "
                              "source frames through")
                self.engine_failed = True
                outs = [OutputFrame(f.pts, f.fmt, f.y, f.uv, host=True)
                        for f in buf]
            del buf[:]
            for out in outs:
                self.sink.write(out)
                self.last_output = out
                self.frames_out += 1

        buf: list = []
        try:
            for frame in reader:
                if self._quit or (self.end_pts is not None
                                  and frame.pts > self.end_pts):
                    self._eof_stop = True
                    if frame.recycle is not None:
                        frame.recycle()
                    break
                self._apply_commands()
                if self.engine_failed:
                    self.sink.write(OutputFrame(frame.pts, frame.fmt,
                                                frame.y, frame.uv,
                                                host=True))
                    self.frames_out += 1
                    self.frames_in += 1
                    continue
                buf.append(frame)
                self.frames_in += 1
                if len(buf) >= self.group:
                    _flush(buf)
                if max_source_frames and self.frames_in >= max_source_frames:
                    self._eof_stop = True
                    break
            _flush(buf)
        finally:
            reader.stop()
        return False

    def _run_segment(self, max_source_frames: Optional[int]) -> bool:
        """Play until EOF, frame budget, or a queued seek.  Returns True if
        a seek was executed and playback should restart from the new
        position."""
        if self.group > 1:
            return self._run_segment_grouped(max_source_frames)
        self._eof_stop = False
        reader = _Prefetcher(self.source, self.prefetch,
                             stage=self.engine.stage if self.stage_uploads
                             else None)
        try:
            for frame in reader:
                if self._quit or (self.end_pts is not None
                                  and frame.pts > self.end_pts):
                    self._eof_stop = True
                    if frame.recycle is not None:
                        frame.recycle()
                    break
                if (self.present is not None and not self.present.untimed
                        and reader.last_wait
                        > self.engine.cadence.source_frame_time):
                    self.underruns += 1
                    if self.underruns % 32 == 1:
                        log.warning("source underrun: decoder is %.1f ms "
                                    "behind the source cadence",
                                    reader.last_wait * 1e3)
                # pause gate (commands and queued seeks stay live)
                while not self._unpaused.is_set():
                    self._unpaused.wait(0.05)
                    self._apply_commands()
                    if self._pending_seek is not None or self._quit:
                        break
                self._apply_commands()
                if self._pending_seek is not None:
                    pts = self._pending_seek
                    self._pending_seek = None
                    reader.stop()
                    self._execute_seek(pts)
                    return True
                if (self.drop_late_sources and self._late_streak >= 8
                        and self.present is not None
                        and not self.present.untimed):
                    # shedding one source frame relieves ~numIntFrames of
                    # device + present work; the pts gap re-anchors cleanly
                    self.sources_dropped += 1
                    self._late_streak = 0
                    self.frames_in += 1
                    continue
                if self.engine_failed:
                    outs = [OutputFrame(frame.pts, frame.fmt, frame.y,
                                        frame.uv, host=True)]
                else:
                    try:
                        outs = self.engine.push(frame)
                    except Exception:
                        if not self.fail_open:
                            raise
                        log.exception(
                            "interpolation engine failed; passing source "
                            "frames through (filter-failure semantics)")
                        self.engine_failed = True
                        outs = [OutputFrame(frame.pts, frame.fmt, frame.y,
                                            frame.uv, host=True)]
                self.frames_in += 1
                for out in outs:
                    if self.present is not None:
                        info = self.present.present(out.pts)
                        if info.late_by > 0:
                            self._late_streak += 1
                        else:
                            self._late_streak = 0
                        if info.dropped:
                            continue
                    self.sink.write(out)
                    self.last_output = out
                    self.frames_out += 1
                if self.present is not None:
                    self._maybe_adapt_display_rate()
                if self._step_frames > 0:
                    self._step_frames -= 1
                    if self._step_frames == 0 and self.paused:
                        self._unpaused.clear()
                if max_source_frames and self.frames_in >= max_source_frames:
                    break
        finally:
            reader.stop()
        return False
