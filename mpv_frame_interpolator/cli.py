"""Command-line entry point.

The rebuild's player/main.c + options layer: a typed flag surface mirroring
the knobs the reference exposes (FrameOutput filter option
vf_HopperRender.c:715-716, config.h tunables, --vo-null-fps / --untimed
test switches, --o encode mode).

Examples:
  python -m mpv_frame_interpolator synthetic:moving_box --frames 48 \
      --display-fps 60 -o /tmp/out.y4m
  python -m mpv_frame_interpolator input.y4m --display-fps 120 --untimed \
      --mode 3 -o flow_vis.y4m
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from mpv_frame_interpolator.frame import NV12, P010
from mpv_frame_interpolator.io import synthetic, sinks, y4m
from mpv_frame_interpolator.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator.pipeline.player import Pipeline
from mpv_frame_interpolator.pipeline.present import PresentClock
from mpv_frame_interpolator.utils import get_logger
from mpv_frame_interpolator.utils.logging import set_verbosity

log = get_logger("cli")

MODES = {"warp12": 0, "warp21": 1, "blend": 2, "hsv": 3, "grey": 4,
         "sbs1": 5, "sbs2": 6}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpv_frame_interpolator",
        description="optical-flow video frame interpolation on an "
                    "accelerator (JAX)")
    p.add_argument("source", nargs="+",
                   help="input(s): .y4m path, media path (needs ffmpeg), or "
                        "synthetic:<moving_box|gradient_pan|noise|scene_cut>"
                        "; several inputs play as a gapless playlist "
                        "(mp_play_files analog)")
    p.add_argument("--playlist", default="",
                   help="read additional playlist entries from this file: "
                        "plain line lists, m3u/m3u8, pls, or mpv EDL v0 "
                        "timelines (segments clip to start/length; .edl "
                        "also works as a positional input); relative "
                        "entries resolve against the playlist's "
                        "directory")
    p.add_argument("--width", type=int, default=1920,
                   help="synthetic/raw width")
    p.add_argument("--height", type=int, default=1080,
                   help="synthetic/raw height")
    p.add_argument("--fps", type=float, default=24.0,
                   help="synthetic/raw source fps")
    p.add_argument("--frames", type=int, default=96,
                   help="max source frames to process (0 = all)")
    p.add_argument("--p010", action="store_true",
                   help="run the 10-bit pipeline")
    p.add_argument("--display-fps", type=float, default=60.0,
                   help="target display rate (vo_null --vo-null-fps analog)")
    p.add_argument("--untimed", action="store_true",
                   help="do not pace output to the display clock")
    p.add_argument("--no-present", action="store_true",
                   help="skip the present clock entirely (max throughput)")
    p.add_argument("--mode", default="blend",
                   help="output mode: warp12|warp21|blend|hsv|grey|sbs1|sbs2 "
                        "or FrameOutput integer 0-6 (vf_HopperRender.c:21)")
    p.add_argument("--speed", type=float, default=1.0, help="playback speed")
    p.add_argument("--model", default="hopper",
                   help="interpolator family: "
                        "hopper|hopperx|hopperq|hopperxq|blend|repeat")
    p.add_argument("--search-radius", type=int, default=5,
                   help="initial optical-flow search radius [5..16]")
    p.add_argument("--no-auto-quality", action="store_true",
                   help="disable the auto search-radius controller")
    p.add_argument("--no-scene-detection", action="store_true")
    p.add_argument("--scene-threshold", type=float, default=28.0)
    p.add_argument("--black-level", type=float, default=0.0)
    p.add_argument("--white-level", type=float, default=255.0)
    p.add_argument("--delta-scalar", type=int, default=8)
    p.add_argument("--neighbor-bias-scalar", type=int, default=6)
    p.add_argument("--max-calc-res", type=int, default=270)
    p.add_argument("--num-iterations", type=int, default=0)
    p.add_argument("--precompile", action="store_true",
                   help="compile all radii up front")
    p.add_argument("-o", "--output", default="",
                   help="write outputs to a .y4m file")
    p.add_argument("--group", type=int, default=1,
                   help="transcode throughput: dispatch N source pairs "
                        "per device program (engine.push_many; amortizes "
                        "fixed per-dispatch cost N-ways).  Adds up to N "
                        "source intervals of latency and disables pause/"
                        "seek, so it requires an encode sink (-o/--dump-*) "
                        "and implies --untimed (docs/API.md 'Grouped "
                        "dispatch')")
    p.add_argument("--osd", action="store_true",
                   help="burn a stats overlay into output frames (player "
                        "OSD stats analog)")
    p.add_argument("--dump-pgm", default="",
                   help="dump luma planes as PGM files into this directory")
    p.add_argument("--dump-png", default="",
                   help="dump outputs as color PNGs into this directory "
                        "(screenshot-subsystem analog; dependency-free "
                        "encoder)")
    p.add_argument("--applet-fifo", default="",
                   help="serve the HopperRender settings-applet protocol on "
                        "this FIFO path (e.g. /tmp/hopperrender)")
    p.add_argument("--ipc-server", default="",
                   help="serve JSON IPC on this unix socket path "
                        "(mpv --input-ipc-server analog)")
    p.add_argument("--interactive", action="store_true",
                   help="terminal keyboard control (input.c analog): "
                        "arrows seek, space pause, . frame-step, "
                        "[ ] speed, s screenshot, q quit, Q quit+save")
    p.add_argument("--input-conf", default="",
                   help="key bindings file (mpv input.conf line format: "
                        "'KEY command args'; overlays the defaults)")
    p.add_argument("--no-input-default-bindings", action="store_true",
                   help="start from an empty bindings table")
    p.add_argument("--cache", default="auto", choices=("auto", "yes", "no"),
                   help="seekable frame cache over unseekable inputs "
                        "(stdin/pipes; demuxer-cache analog). auto = only "
                        "when the source cannot seek by itself")
    p.add_argument("--ingest", default="auto",
                   choices=("auto", "native", "python"),
                   help="file ingest path (y4m + MKV/MP4 raw video): the "
                        "C++ demuxer ring with recycled buffers (native), "
                        "the Python reader (python), or native-when-built "
                        "(auto)")
    p.add_argument("--subpel-flow", action="store_true",
                   help="measured fractional-pel flow refinement: "
                        "parabolic sub-pel fit of the SAD surface; "
                        "hopperq/hopperxq warp at 1/64-pel, hopper/hopperx "
                        "get a round-to-nearest field (quality option; "
                        "changes the flow families' output)")
    p.add_argument("--warp-loop", default="vmap", choices=("vmap", "scan"),
                   help="how the per-pair warp batch is expressed in the "
                        "fused program (bit-identical outputs; compile-time "
                        "tradeoff knob)")
    p.add_argument("--warp-sampling", default="shift",
                   choices=("shift", "gather"),
                   help="warp sampler: shift = one slice + select per "
                        "distinct displacement (default), gather = "
                        "per-pixel gather (the reference's design); both "
                        "bit-exact")
    p.add_argument("--layer-buckets", default="5,8,16",
                   help="comma-separated flow layer-count variants; the "
                        "live search radius runs the smallest bucket that "
                        "covers it, so quality degradation cuts real device "
                        "work (empty = single 16-layer program)")
    p.add_argument("--degrade-rungs", default="2:2,2:2:blend",
                   help="degradation ladder beyond the radius floor, as "
                        "comma-separated iteration_delta:res_divisor"
                        "[:model] rungs (the auto-quality controller "
                        "steps down pyramid depth / calc resolution / "
                        "interpolator family when radius alone cannot "
                        "restore real-time; empty disables)")
    p.add_argument("--mf-fps", type=float, default=1.0,
                   help="frame rate for mf:// image sequences "
                        "(demux_mf's --mf-fps; default 1)")
    p.add_argument("--vf", default="",
                   help="host filter chain before interpolation, e.g. "
                        "'crop=640:360,vflip,fps=24' (user_filters analog)")
    p.add_argument("--script", default="",
                   help="run a Python script with a `player` handle bound "
                        "to the live engine (scripting-layer analog)")
    p.add_argument("--end", type=float, default=None,
                   help="stop playback at this source pts (seconds; mpv "
                        "--end analog)")
    p.add_argument("--play-direction", default="forward",
                   choices=("forward", "backward"),
                   help="backward plays a seekable source last-to-first "
                        "(chunked reverse reads, mpv --play-direction "
                        "analog); pipes spool through the cache first")
    p.add_argument("--loop", type=int, default=0,
                   help="replay the source N more times after EOF "
                        "(-1 = forever; --loop-file analog; needs a "
                        "seekable source)")
    p.add_argument("--start", type=float, default=None,
                   help="skip source frames until this pts (seconds); "
                        "defaults to a watch-later position if one exists")
    p.add_argument("--save-position-on-quit", action="store_true",
                   help="persist playback position + knobs per input file "
                        "(watch-later analog)")
    p.add_argument("--save-position-interval", type=float, default=60.0,
                   help="with --save-position-on-quit: also save the "
                        "position periodically every N seconds, so a crash "
                        "loses at most that much progress (configfiles.c "
                        "periodic save analog); 0 disables")
    p.add_argument("--no-resume", action="store_true",
                   help="ignore an existing watch-later entry")
    p.add_argument("--profile-dir", default="",
                   help="capture a jax.profiler device trace into this dir")
    p.add_argument("--dump-stats", default="",
                   help="write the stats-registry summary (JSON) to this "
                        "file at exit (--dump-stats analog)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    from mpv_frame_interpolator import __version__
    p.add_argument("--version", action="version",
                   version=f"mpv_frame_interpolator {__version__}")
    from mpv_frame_interpolator.options import add_config_flags
    add_config_flags(p)
    return p


def make_source(args):
    if isinstance(args.source, (list, tuple)):
        # nargs="+" positional; single-entry resolution (playlists fan
        # out in main() via one make_source call per entry)
        args = argparse.Namespace(**{**vars(args),
                                     "source": args.source[0]})
    if args.source.startswith("mf://") or (
            "://" not in args.source
            and not args.source.startswith("synthetic:")):
        from mpv_frame_interpolator.io import mf
        if args.source.startswith("mf://") or mf.is_image_path(args.source):
            try:
                rdr = mf.MFReader(args.source, fps=args.mf_fps,
                                  pixfmt=P010 if args.p010 else NV12)
            except mf.MFError as e:
                raise SystemExit(f"cannot open image sequence "
                                 f"{args.source!r}: {e}")
            return rdr, rdr.width, rdr.height
    if args.source.startswith("synthetic:"):
        name = args.source.split(":", 1)[1]
        cfg = synthetic.SyntheticConfig(
            width=args.width, height=args.height, fps=args.fps,
            pixfmt=P010 if args.p010 else NV12)
        gen = getattr(synthetic, name, None)
        if gen is None:
            raise SystemExit(f"unknown synthetic source {name!r}")
        n = args.frames or 1 << 30
        return gen(cfg, n), cfg.width, cfg.height
    if args.source == "-":
        from mpv_frame_interpolator.io import ingest
        raw = sys.stdin.buffer.raw
        # sniff the pipe: EBML / ISO-BMFF magic means a piped CONTAINER
        # (spool + indexed native ingest); anything else is y4m
        magic = b""
        while len(magic) < 12:
            chunk = raw.read(12 - len(magic))
            if not chunk:
                break
            magic += chunk
        is_ebml = magic.startswith(b"\x1aE\xdf\xa3")
        is_mp4 = len(magic) >= 8 and magic[4:8] == b"ftyp"
        is_avi = (len(magic) >= 12 and magic[:4] == b"RIFF"
                  and magic[8:12] == b"AVI ")
        if is_ebml or is_mp4 or is_avi:
            path = _spool_stdin_container(
                raw, magic,
                ".mkv" if is_ebml else ".avi" if is_avi else ".mp4")
            reader_cls, err_cls, name = _container_kind(path)
            try:
                rdr = _open_container_path(args, path, reader_cls)
            except err_cls as e:
                raise SystemExit(f"cannot open piped {name}: {e}")
            return rdr, rdr.width, rdr.height
        if args.ingest != "python" and ingest.have_native_ingest():
            # the C++ ring reads an fd directly (no buffered layer
            # stealing bytes); the sniffed magic is replayed through a
            # feeder pipe.  Pipes stream, they just can't seek.
            rdr = ingest.NativeY4MSource(_replay_fd(magic, raw))
        else:
            import io as _io
            rdr = y4m.Y4MReader(_io.BufferedReader(
                _io.FileIO(_replay_fd(magic, raw), "rb")))
        return rdr, rdr.width, rdr.height
    from mpv_frame_interpolator.io.stream import is_stream_url, open_stream
    if is_stream_url(args.source):
        from urllib.parse import urlparse
        upath = urlparse(args.source).path
        if upath.endswith((".mkv", ".webm", ".mp4", ".mov", ".m4v",
                           ".avi")):
            # container over http(s): byte-range seeking when the server
            # supports it (stream_lavf.c http analog), else the y4m-style
            # spool path below can't parse containers -> hard error with
            # the reason
            from mpv_frame_interpolator.io.stream import open_http_file
            fh = open_http_file(args.source)
            if fh is None:
                raise SystemExit(
                    f"{args.source!r}: server lacks byte-range support; "
                    "containers need it (serve as .y4m to stream instead)")
            if upath.endswith((".mkv", ".webm")):
                from mpv_frame_interpolator.io.mkv import MKVReader
                rdr = MKVReader(fh)
            elif upath.endswith(".avi"):
                from mpv_frame_interpolator.io.avi import AVIReader
                rdr = AVIReader(fh)
            else:
                from mpv_frame_interpolator.io.mp4 import MP4Reader
                rdr = MP4Reader(fh)
            return rdr, rdr.width, rdr.height
        rdr = y4m.Y4MReader(open_stream(args.source))
        return rdr, rdr.width, rdr.height
    if args.source.endswith(".yuv"):
        fh = open(args.source, "rb")
        rdr = y4m.RawYUVReader(fh, args.width, args.height, args.fps,
                               P010 if args.p010 else NV12)
        return rdr, args.width, args.height
    if args.source.endswith((".mjpeg", ".mjpg")):
        # raw concatenated-JPEG stream (IP-camera dump): in-process
        # baseline-JPEG decode, nominal rate from --fps
        from mpv_frame_interpolator.io.jpeg import (decode_jpeg_planes,
                                                        mjpeg_source)
        with open(args.source, "rb") as probe:
            head = probe.read(1 << 20)
        from mpv_frame_interpolator.io.jpeg import split_jpeg_stream
        import io as _io
        first = next(split_jpeg_stream(_io.BytesIO(head).read), None)
        if first is None:
            raise SystemExit(f"{args.source!r}: no JPEG frames found")
        y0, _, _ = decode_jpeg_planes(first)
        h0, w0 = y0.shape
        return (mjpeg_source(args.source, fps=args.fps),
                w0 + w0 % 2, h0 + h0 % 2)
    if args.source.endswith(".y4m"):
        from mpv_frame_interpolator.io import ingest
        if args.ingest == "python":
            rdr = y4m.Y4MReader(open(args.source, "rb"))
        elif args.ingest == "native":
            rdr = ingest.NativeY4MSource(args.source)
        else:
            rdr = ingest.open_y4m(args.source)
        return rdr, rdr.width, rdr.height
    container = _container_kind(args.source)
    if container is not None:
        reader_cls, err_cls, name = container
        try:
            rdr = _open_container_path(args, args.source, reader_cls)
            return rdr, rdr.width, rdr.height
        except err_cls as e:
            # compressed codec (or exotic layout): needs a real decoder
            from mpv_frame_interpolator.io.decode import have_ffmpeg
            if not have_ffmpeg():
                raise SystemExit(f"cannot open {args.source!r}: {e}")
            log.info("native %s demux declined (%s); using ffmpeg",
                     name, e)
    from mpv_frame_interpolator.io.decode import ffmpeg_source
    src = ffmpeg_source(args.source, P010 if args.p010 else NV12)
    return src, args.width, args.height


def _container_kind(name: str):
    if name.endswith((".mkv", ".webm")):
        from mpv_frame_interpolator.io.mkv import MKVError, MKVReader
        return (MKVReader, MKVError, "MKV")
    if name.endswith((".mp4", ".mov", ".m4v")):
        from mpv_frame_interpolator.io.mp4 import MP4Error, MP4Reader
        return (MP4Reader, MP4Error, "MP4")
    if name.endswith(".avi"):
        from mpv_frame_interpolator.io.avi import AVIError, AVIReader
        return (AVIReader, AVIError, "AVI")
    return None


def _open_container_path(args, path: str, reader_cls):
    if args.ingest == "python":
        return reader_cls(path)
    # C++ indexed pread ring over the container's frame index
    from mpv_frame_interpolator.io import ingest
    return ingest.open_container(path)


def _spool_stdin_container(raw, magic: bytes, suffix: str) -> str:
    """Piped container: spool the byte stream to a temp file so the
    indexed (pread) ingest can serve it -- the demux cache's
    make-pipes-seekable move (/root/reference/demux/cache.c), done at the
    byte layer because a container index needs random access."""
    import atexit
    import shutil
    import tempfile
    tf = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    tf.write(magic)
    shutil.copyfileobj(raw, tf)
    tf.close()
    atexit.register(lambda: os.path.exists(tf.name) and os.unlink(tf.name))
    log.info("spooled piped container to %s", tf.name)
    return tf.name


def _replay_fd(first: bytes, src) -> int:
    """Read end of a pipe that replays `first` then pumps `src` (used to
    hand sniffed stdin bytes back to fd-level consumers)."""
    import threading
    r, w = os.pipe()

    def pump():
        try:
            data = first
            while data:
                os.write(w, data)
                data = src.read(1 << 16) or b""
        except (BrokenPipeError, OSError):
            pass
        finally:
            try:
                os.close(w)
            except OSError:
                pass

    threading.Thread(target=pump, daemon=True).start()
    return r


def main(argv=None) -> int:
    from mpv_frame_interpolator.options import parse_with_config
    args = parse_with_config(build_parser(), argv)
    if args.verbose:
        set_verbosity(10)

    try:
        mode = int(args.mode)
    except ValueError:
        mode = MODES.get(args.mode)
        if mode is None:
            raise SystemExit(f"unknown mode {args.mode!r}")

    # playlist assembly (mp_play_files analog): positional entries plus
    # an optional --playlist file; one entry plays directly, several play
    # gapless through a ChainedSource on one engine
    from mpv_frame_interpolator.io.playlist import EDLEntry
    entries = list(args.source)
    if args.playlist:
        from mpv_frame_interpolator.io.playlist import parse_playlist
        try:
            entries.extend(parse_playlist(args.playlist))
        except OSError as e:
            raise SystemExit(f"cannot read playlist {args.playlist!r}: {e}")
        except ValueError as e:
            raise SystemExit(f"bad playlist {args.playlist!r}: {e}")
    # an .edl positional entry expands into its timeline segments
    expanded = []
    for e in entries:
        if isinstance(e, str) and e.lower().endswith(".edl"):
            from mpv_frame_interpolator.io.playlist import \
                parse_playlist
            try:
                expanded.extend(parse_playlist(e))
            except (OSError, ValueError) as err:
                raise SystemExit(f"bad EDL {e!r}: {err}")
        else:
            expanded.append(e)
    entries = expanded
    first = entries[0]
    # single-file surfaces (watch-later, logs)
    args.source = first.path if isinstance(first, EDLEntry) else first

    import argparse as _ap

    def _open_entry(entry):
        sub = _ap.Namespace(**vars(args))
        if isinstance(entry, EDLEntry):
            from mpv_frame_interpolator.io.playlist import ClipSource
            sub.source = entry.path
            return ClipSource(make_source(sub)[0], entry.start,
                              entry.length)
        sub.source = entry
        return make_source(sub)[0]

    if len(entries) == 1 and not isinstance(first, EDLEntry):
        source, width, height = make_source(args)
    else:
        from mpv_frame_interpolator.io.playlist import ChainedSource
        source = ChainedSource(entries, _open_entry)
        width, height = source.width, source.height
        log.info("playlist: %d entries, %dx%d timeline",
                 len(entries), width, height)

    src_seekable = (hasattr(source, "seek_pts")
                    and getattr(source, "seekable", lambda: False)())
    if args.cache == "yes" or (args.cache == "auto" and not src_seekable):
        from mpv_frame_interpolator.io.cache import CachedSource
        source = CachedSource(source)
        log.info("seekable frame cache enabled (demuxer-cache analog)")

    if args.play_direction == "backward":
        from mpv_frame_interpolator.io.reverse import (
            ReversedSource, ReverseError)
        if args.start is not None:
            log.warning("--start is ignored with --play-direction=backward")
        try:
            source = ReversedSource(source)
        except ReverseError as e:
            raise SystemExit(f"--play-direction=backward: {e}")
        log.info("backward playback (chunked reverse reads)")

    config = EngineConfig(
        display_fps=args.display_fps,
        frame_output_mode=mode,
        auto_quality=not args.no_auto_quality,
        initial_search_radius=args.search_radius,
        scene_detection=not args.no_scene_detection,
        scene_threshold=args.scene_threshold,
        delta_scalar=args.delta_scalar,
        neighbor_bias_scalar=args.neighbor_bias_scalar,
        black_level=args.black_level,
        white_level=args.white_level,
        max_calc_res=args.max_calc_res,
        num_iterations=args.num_iterations,
        playback_speed=args.speed,
        precompile=args.precompile,
        model=args.model,
        subpel_flow=args.subpel_flow,
        warp_loop=args.warp_loop,
        warp_sampling=args.warp_sampling,
        layer_buckets=tuple(int(b) for b in args.layer_buckets.split(",")
                            if b.strip()),
        degrade_rungs=tuple(
            tuple(int(x) if i < 2 else x
                  for i, x in enumerate(r.split(":", 2)))
            for r in args.degrade_rungs.split(",") if r.strip()),
    )
    engine = InterpolationEngine(config)
    if args.speed != 1.0:
        engine.set_speed(args.speed)

    # watch-later resume (player/configfiles.c analog) for file sources.
    # Multi-entry playlists are excluded: the chained timeline's pts can
    # exceed any single entry's duration, so a saved position would
    # resume a later solo play of entries[0] out of range (the backward-
    # playback path opts out for the same timeline-identity reason).
    is_file = (len(entries) == 1
               and not args.source.startswith("synthetic:"))
    start_pts = args.start
    if args.play_direction == "backward":
        start_pts = None     # reversed timeline; position resume is N/A
    elif is_file and not args.no_resume:
        from mpv_frame_interpolator.api import Player
        from mpv_frame_interpolator.pipeline import resume as _resume
        state = _resume.load(args.source)
        if state:
            pos = _resume.apply_to_player(Player(engine=engine), state)
            if start_pts is None:
                start_pts = pos
            log.info("resumed watch-later state (position %.2fs, %s)",
                     pos, {k: v for k, v in state.items() if k != "start"})

    if start_pts:
        if (hasattr(source, "seek_pts")
                and getattr(source, "seekable", lambda: False)()):
            # O(1) byte seek (demux_seek analog) -- watch-later resume of a
            # long file must not replay it from frame 0
            actual = source.seek_pts(start_pts)
            log.info("seeked source to %.3fs (requested %.3fs)",
                     actual, start_pts)
        else:
            def _skip_until(src, t0=start_pts):
                for f in src:
                    if f.pts >= t0 - 1e-9:
                        yield f
            source = _skip_until(source)

    if args.output == "-":
        from mpv_frame_interpolator.io.y4m import Y4MWriter

        class _StdoutSink:
            def __init__(self):
                self._w = Y4MWriter(sys.stdout.buffer, width, height,
                                    args.display_fps,
                                    P010 if args.p010 else NV12)

            def write(self, frame):
                self._w.write(frame.to_video_frame())

            def close(self):
                sys.stdout.buffer.flush()

        sink = _StdoutSink()
    elif args.output:
        if args.output.lower().endswith((".mkv", ".mka")):
            # archival encode: FFV1 in Matroska (vo_lavc --o analog)
            sink = sinks.FFV1MKVSink(args.output, width, height,
                                     args.display_fps,
                                     P010 if args.p010 else NV12)
        else:
            sink = sinks.Y4MFileSink(args.output, width, height,
                                     args.display_fps,
                                     P010 if args.p010 else NV12)
    elif args.dump_pgm:
        sink = sinks.PgmDumpSink(args.dump_pgm)
    elif args.dump_png:
        sink = sinks.PngDumpSink(args.dump_png)
    else:
        sink = sinks.NullSink()

    if args.osd:
        sink = sinks.OsdSink(sink, engine)

    group = max(args.group, 1)
    if group > 1 and not (args.output or args.dump_pgm or args.dump_png):
        raise SystemExit("--group requires an encode sink (-o/--dump-pgm/"
                         "--dump-png): grouped dispatch buffers N source "
                         "intervals, which realtime playback cannot absorb")

    present = None
    if not args.no_present and group == 1:
        present = PresentClock(args.display_fps, untimed=args.untimed)

    if args.vf:
        from mpv_frame_interpolator.io.filters import (
            parse_chain, apply_chain)
        source = apply_chain(parse_chain(args.vf), source)

    pipe = Pipeline(source, engine, sink, present, group=group)
    pipe.loop = args.loop
    pipe.end_pts = args.end

    if args.script:
        import threading
        from mpv_frame_interpolator.api import Player as _Player
        script_player = _Player(engine=engine)
        script_player.bind_pipeline(pipe)
        code = open(args.script).read()

        def run_script():
            exec(compile(code, args.script, "exec"),
                 {"player": script_player, "pipeline": pipe})
        threading.Thread(target=run_script, daemon=True).start()

    term_input = None
    save_on_exit = [bool(is_file and args.save_position_on_quit)]
    if args.interactive:
        from mpv_frame_interpolator.api import Player as _P
        from mpv_frame_interpolator.control.input import (
            KeyDispatcher, TerminalInput, parse_input_conf)
        key_player = _P(engine=engine)
        key_player.bind_pipeline(pipe)
        user_bindings = None
        if args.input_conf:
            user_bindings = parse_input_conf(open(args.input_conf).read())

        def _on_quit(watch_later: bool):
            if watch_later and is_file:
                save_on_exit[0] = True
            pipe.quit()

        dispatcher = KeyDispatcher(
            key_player, pipe, on_quit=_on_quit, bindings=user_bindings,
            default_bindings=not args.no_input_default_bindings)
        try:
            term_input = TerminalInput(dispatcher).start()
            log.info("terminal input active (q quits)")
        except OSError as e:
            log.warning("no controlling terminal (%s); --interactive "
                        "disabled", e)

    applet = None
    if args.applet_fifo:
        from mpv_frame_interpolator.control.applet import AppletServer
        applet = AppletServer(args.applet_fifo, engine)
        applet.start()
    ipc = None
    if args.ipc_server:
        from mpv_frame_interpolator.api import Player
        from mpv_frame_interpolator.control.ipc import IPCServer
        ipc_player = Player(engine=engine)
        ipc_player.bind_pipeline(pipe)
        ipc = IPCServer(args.ipc_server, ipc_player)
        ipc.start()

    def _watch_later_props():
        return {
            "speed": engine.cadence.playback_speed,
            "frame-output-mode": engine.frame_output_mode,
            "search-radius": engine.quality.search_radius,
            "black-level": engine.black_level,
            "white-level": engine.white_level,
            "scene-threshold": engine.scene.threshold,
        }

    save_timer_stop = None
    if (is_file and args.save_position_on_quit
            and args.save_position_interval > 0):
        import threading
        from mpv_frame_interpolator.pipeline import resume as _resume

        save_timer_stop = threading.Event()

        def _periodic_save():
            while not save_timer_stop.wait(args.save_position_interval):
                _resume.save(args.source, engine.cadence.current_output_pts,
                             _watch_later_props())

        threading.Thread(target=_periodic_save, daemon=True).start()

    profile_ctx = None
    if args.profile_dir:
        from mpv_frame_interpolator.utils.trace import device_trace
        profile_ctx = device_trace(args.profile_dir)
        profile_ctx.__enter__()

    t0 = time.perf_counter()
    try:
        n = pipe.run(max_source_frames=args.frames or None)
    finally:
        if profile_ctx:
            profile_ctx.__exit__(None, None, None)
        if applet:
            applet.stop()
        if ipc:
            ipc.stop()
        if save_timer_stop is not None:
            save_timer_stop.set()
        if term_input is not None:
            term_input.stop()
        if save_on_exit[0]:
            from mpv_frame_interpolator.pipeline import resume as _resume
            last_pts = engine.cadence.current_output_pts
            path = _resume.save(args.source, last_pts, _watch_later_props())
            log.info("watch-later state saved to %s", path)
    if args.dump_stats:
        import json
        with open(args.dump_stats, "w") as fh:
            json.dump({"stats": engine.stats.summary(),
                       "search_radius": engine.quality.search_radius,
                       "state": engine.cadence.state.name,
                       "frames_in": pipe.frames_in,
                       "frames_out": pipe.frames_out}, fh, indent=2)

    dt = time.perf_counter() - t0
    s = engine.stats.summary().get("source_frame_time", {})
    log.info("%d source -> %d output frames in %.2fs (%.1f out-fps); "
             "per-source mean=%.2fms p99=%.2fms; radius=%d",
             pipe.frames_in, n, dt, n / dt if dt else 0.0,
             s.get("mean", 0.0) * 1e3, s.get("p99", 0.0) * 1e3,
             engine.quality.search_radius)
    if present:
        log.info("present: %d flips, %d drops, est fps %.2f, jitter %.4fms",
                 present.presented, present.drops,
                 present.estimated_display_fps(),
                 present.vsync_jitter() * 1e3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
