"""Playlist playback: several sources chained into one pts timeline.

The reference's player core runs a per-file lifecycle loop
(`mp_play_files` -> `play_current_file`, player/loadfile.c:2080,1630)
re-initializing the decode chain per entry; its filter instances persist
process-wide.  Here the engine (one compiled geometry) IS the expensive
persistent part, so the chain inverts: ONE engine/pipeline consumes a
ChainedSource that re-anchors each entry's timestamps onto a continuous
output timeline (gapless, like mpv with --gapless-audio's video analog).

Entries whose geometry or pixel format differ from the first entry are
bilinearly rescaled / bit-depth converted on the host (the output chain's
autoconvert job, filters/f_autoconvert.c) so the device programs never
recompile mid-playlist.

The file boundary is content-discontinuous, which is exactly what the
engine's scene-cut detection folds into the warp (a cut at the splice,
like the reference displaying the first frame of the next file).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, List, Sequence

from mpv_frame_interpolator.frame import VideoFrame
from mpv_frame_interpolator.utils import get_logger

log = get_logger("playlist")


@dataclasses.dataclass
class EDLEntry:
    """One EDL timeline segment: `path` clipped to [start, start+length)
    seconds (length None = to the end)."""
    path: str
    start: float = 0.0
    length: float = None


def parse_edl(lines: List[str], resolve) -> List[EDLEntry]:
    """mpv EDL v0 (demux/demux_edl.c): one segment per line,
    `file,start,length` positionally or `name=value` params (quoted
    `%N%...` names are supported for the file field).  Global `!`
    header lines (no_clip, new_stream, ...) configure features this
    player doesn't model and are rejected explicitly rather than
    silently mis-played."""
    if lines and lines[0].startswith("# mpv EDL"):
        lines = lines[1:]
    out = []
    for ln in lines:
        if not ln or ln.startswith("#"):
            continue
        if ln.startswith("!"):
            raise ValueError(f"EDL header {ln.split(',')[0]!r} is not "
                             f"supported (plain v0 segments only)")
        fields = []
        rest = ln
        while rest:
            if rest.startswith("%"):          # %N%<exactly N bytes>
                n_str, _, tail = rest[1:].partition("%")
                if not n_str.isdigit() or len(tail) < int(n_str):
                    raise ValueError("bad EDL quoted field")
                n = int(n_str)
                fields.append(tail[:n])
                rest = tail[n:].lstrip(",")
            else:
                field, _, rest = rest.partition(",")
                fields.append(field.strip())
        path, start, length = None, 0.0, None
        for i, f in enumerate(fields):
            key, sep, val = f.partition("=")
            if sep and key in ("file", "start", "length"):
                pos = ("file", "start", "length").index(key)
            else:
                pos, val = i, f
            try:
                if pos == 0:
                    path = val
                elif pos == 1 and val != "":
                    start = float(val)
                elif pos == 2 and val != "":
                    length = float(val)
            except ValueError:
                raise ValueError(f"bad EDL number {val!r}") from None
        if not path:
            raise ValueError(f"EDL segment without a file: {ln!r}")
        if start < 0 or (length is not None and length <= 0):
            raise ValueError(f"bad EDL segment times: {ln!r}")
        out.append(EDLEntry(resolve(path), start, length))
    if not out:
        raise ValueError("EDL with no segments")
    return out


def parse_playlist(path: str) -> List:
    """Entries of a playlist file: plain line lists, m3u/m3u8 (EXTM3U;
    `#EXT...` directives are metadata, every other non-blank line is an
    entry), pls (`[playlist]` INI, `FileN=` keys in N order), and mpv
    EDL v0 timelines (`# mpv EDL v0` header or .edl suffix; segments
    come back as EDLEntry objects) -- the formats demux_playlist.c /
    demux_edl.c cover that make sense without a URL stack.  Relative
    entries resolve against the playlist file's directory
    (demux_playlist.c's playlist_add_base), absolute paths and URLs
    (scheme://, synthetic:) pass through."""
    with open(path, encoding="utf-8", errors="replace") as fh:
        lines = [ln.strip().lstrip("﻿") for ln in fh]
    base = os.path.dirname(os.path.abspath(path))

    def resolve(entry: str) -> str:
        if ("://" in entry or entry.startswith("synthetic:")
                or os.path.isabs(entry) or entry == "-"):
            return entry
        return os.path.join(base, entry)

    low = path.lower()
    if low.endswith(".edl") or (lines and lines[0].startswith("# mpv EDL")):
        return parse_edl(lines, resolve)
    if low.endswith(".pls") or any(ln.lower() == "[playlist]"
                                   for ln in lines[:3]):
        numbered = []
        for ln in lines:
            if "=" not in ln:
                continue
            key, _, val = ln.partition("=")
            key = key.strip().lower()
            if key.startswith("file") and key[4:].isdigit() and val.strip():
                numbered.append((int(key[4:]), val.strip()))
        return [resolve(v) for _, v in sorted(numbered)]

    # m3u/m3u8 and plain line lists share one shape: '#' lines are
    # comments/directives, the rest are entries
    return [resolve(ln) for ln in lines
            if ln and not ln.startswith("#")]


class ClipSource:
    """Clip a frame source to [start, start+length) seconds of its own
    timeline (the EDL segment semantics, demux_edl.c).  Seeks to the
    in-point when the source can (O(1) on indexed containers); otherwise
    skips frames on the way in.  Geometry/fps attributes proxy through;
    emitted pts are rebased so the clip starts at 0."""

    def __init__(self, src, start: float = 0.0, length: float = None):
        self._src = src
        self._start = float(start)
        self._length = length if length is None else float(length)
        for attr in ("width", "height", "fps", "fmt", "pixfmt"):
            if hasattr(src, attr):
                setattr(self, attr, getattr(src, attr))

    def __iter__(self) -> Iterator[VideoFrame]:
        src = self._src
        start = self._start
        if start > 0 and hasattr(src, "seek_pts") \
                and getattr(src, "seekable", lambda: False)():
            src.seek_pts(start)
        end = None if self._length is None else start + self._length
        # half-frame tolerance so float pts at the boundary behave
        eps = 0.5 / self.fps if getattr(self, "fps", 0) > 0 else 1e-3
        for f in src:
            if f.pts < start - eps:
                if f.recycle is not None:
                    f.recycle()     # skipped lead-in frame
                continue
            if end is not None and f.pts >= end - eps:
                break
            yield dataclasses.replace(f, pts=f.pts - start)

    def close(self):
        if hasattr(self._src, "close"):
            self._src.close()


class ChainedSource:
    """Iterate `entries` (opaque tokens) as one continuous source.

    `open_fn(entry)` returns an iterable of VideoFrames with
    width/height/fps attributes (CLI sources).  The first entry fixes the
    output geometry; later entries are converted to it."""

    def __init__(self, entries: Sequence, open_fn: Callable,
                 loop: int = 0):
        if not entries:
            raise ValueError("empty playlist")
        self._entries = list(entries)
        self._open = open_fn
        self._current = None
        self.loop = loop            # extra whole-playlist repeats (-1 = inf)
        self.entry_index = 0        # playlist-pos property analog
        first = open_fn(self._entries[0])
        self._current = first
        for attr in ("width", "height", "fps", "fmt", "pixfmt"):
            if hasattr(first, attr):
                setattr(self, attr, getattr(first, attr))

    def _convert(self, frame: VideoFrame, scaler) -> VideoFrame:
        if scaler is not None:
            frame = scaler(frame)
        if frame.fmt.pixfmt != self.pixfmt:
            from mpv_frame_interpolator.io.convert import convert_frame
            frame = convert_frame(frame, self.pixfmt)
        return frame

    def _iter_entry(self, idx: int, offset: float):
        """Yield (frame, rebased_pts); returns the next offset."""
        src = self._current if idx == 0 and self._current is not None \
            else self._open(self._entries[idx])
        self._current = None
        self.entry_index = idx
        scaler = None
        w = getattr(src, "width", self.width)
        h = getattr(src, "height", self.height)
        if (w, h) != (self.width, self.height):
            from mpv_frame_interpolator.io.filters import scale
            scaler = scale(self.width, self.height)
            log.info("playlist entry %d: rescaling %dx%d -> %dx%d",
                     idx, w, h, self.width, self.height)
        base = None
        last = None
        dt = 1.0 / src.fps if getattr(src, "fps", 0) > 0 else 1 / 24.0
        n = 0
        try:
            for f in src:
                if base is None:
                    base = f.pts
                pts = offset + (f.pts - base)
                if last is not None and pts - last > 0:
                    dt = pts - last
                out = self._convert(f, scaler)
                if out is not f and f.recycle is not None:
                    f.recycle()     # converted copy; source buffer is free
                yield dataclasses.replace(out, pts=pts)
                last = pts
                n += 1
        finally:
            if hasattr(src, "close"):
                src.close()
        log.info("playlist entry %d done (%d frames)", idx, n)
        self._next_offset = (last + dt) if last is not None else offset

    def __iter__(self) -> Iterator[VideoFrame]:
        offset = 0.0
        rounds = 0
        while True:
            for idx in range(len(self._entries)):
                self._next_offset = offset
                yield from self._iter_entry(idx, offset)
                offset = self._next_offset
            if self.loop == -1:
                continue
            if rounds >= self.loop:
                return
            rounds += 1

    def close(self):
        if self._current is not None and hasattr(self._current, "close"):
            self._current.close()
