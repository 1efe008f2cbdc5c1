"""Command-line entry point of the port (the slice of the JAX package's
``cli.main``).

Examples:
  python -m mpv_frame_interpolator_tpu_torch synthetic:moving_box \
      --width 3840 --height 2160 --display-fps 120 --search-radius 16 \
      --untimed -o out.y4m
  python -m mpv_frame_interpolator_tpu_torch synthetic:moving_box --p010 \
      --black-level 16 --white-level 235 --warp-sampling fused -o out.y4m
  python -m mpv_frame_interpolator_tpu_torch synthetic:moving_box \
      --mode hsv -o flow.y4m
  python -m mpv_frame_interpolator_tpu_torch synthetic:gradient_pan \
      --model hopperxq --mode sbs2 -o sbs.y4m
  python -m mpv_frame_interpolator_tpu_torch synthetic:moving_box \
      --model hopperq --subpel-flow --degrade-rungs 2:2,3:4:blend -o q.y4m
  python -m mpv_frame_interpolator_tpu_torch input.y4m --device cpu -o out.y4m
  python -m mpv_frame_interpolator_tpu_torch input.y4m --group 8 -o out.y4m
  python -m mpv_frame_interpolator_tpu_torch input.y4m --loop 1 --end 2.5 \
      --untimed -o out.y4m
  python -m mpv_frame_interpolator_tpu_torch archive.mkv --untimed -o out.mkv
  python -m mpv_frame_interpolator_tpu_torch a.y4m b.mkv --cache yes \
      --play-direction backward --vf crop=640:360,vflip -o out.y4m
  python -m mpv_frame_interpolator_tpu_torch mf://shots/*.png --mf-fps 24 \
      --dump-png frames/
  cat clip.mkv | python -m mpv_frame_interpolator_tpu_torch - -o - > out.y4m
  python -m mpv_frame_interpolator_tpu_torch movie.y4m --ipc-server /tmp/mfi.sock \
      --applet-fifo /tmp/hopperrender --save-position-on-quit --interactive
  python -m mpv_frame_interpolator_tpu_torch in.y4m --config examples/mfi.conf \
      --profile=baseline-2 -o out.y4m

Inputs: .y4m (the native reader ring, or the Python reader under
``--ingest python``), Matroska/WebM, AVI and MP4/MOV holding raw video,
FFV1 v0/1, Ut Video or MJPEG (decoded by the port's native host library,
built at first use with g++; ``--ingest python`` takes the Python
codecs), ``mf://`` image sequences and single images, raw .mjpeg dumps,
raw .yuv files, ``-`` (a y4m or a container on stdin), tcp/unix/http(s)
streams, playlists and mpv EDL timelines; ffmpeg decodes anything else
where it is installed.  Outputs: .y4m, ``-`` (y4m on stdout), .mkv
(FFV1), ``--dump-pgm``/``--dump-png`` directories, ``--osd`` on any of
them.

Control surfaces (the JAX CLI's): a config file with profiles
(``options.py``: ``$MFI_CONF`` or ``~/.config/mfi_tpu/mfi.conf``,
``--config``, ``--no-config``, ``--profile``), watch-later resume of a
single file (``pipeline/resume.py``; ``--no-resume``,
``--save-position-on-quit``, ``--save-position-interval``), ``--script``
(a Python file run on a thread with ``player`` and ``pipeline`` bound),
``--interactive`` keys (``--input-conf``, ``--no-input-default-bindings``),
the settings applet's FIFOs (``--applet-fifo``), JSON IPC on a unix
socket (``--ipc-server``) and a ``torch.profiler`` trace
(``--profile-dir``).  Every server and thread stops when the run ends,
also when it fails.  ``--precompile``, ``--warp-loop`` and
``--timing-source`` are accepted and ignored, as their engine knobs are
(``convert.NO_OP_KNOBS``).

The device is explicit: ``--device cuda`` (the default) needs a card and
fails if there is none; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import threading
import time
from typing import Optional

import torch

from mpv_frame_interpolator_tpu_torch import __version__, options
from mpv_frame_interpolator_tpu_torch.api import Player
from mpv_frame_interpolator_tpu_torch.control import count_failure
from mpv_frame_interpolator_tpu_torch.frame import NV12, P010
from mpv_frame_interpolator_tpu_torch.io import (
    cache, decode, filters, ingest, jpeg, mf, playlist, reverse, sinks,
    stream, synthetic, y4m)
from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool
from mpv_frame_interpolator_tpu_torch.models import MODELS
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator_tpu_torch.pipeline import resume
from mpv_frame_interpolator_tpu_torch.pipeline.player import Pipeline
from mpv_frame_interpolator_tpu_torch.pipeline.present import PresentClock
from mpv_frame_interpolator_tpu_torch.utils import get_logger
from mpv_frame_interpolator_tpu_torch.utils.logging import set_verbosity

log = get_logger("cli")

# the JAX CLI's output modes (vf_HopperRender.c:21)
MODES = {"warp12": 0, "warp21": 1, "blend": 2, "hsv": 3, "grey": 4,
         "sbs1": 5, "sbs2": 6}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpv_frame_interpolator_tpu_torch",
        description="optical-flow frame interpolation on PyTorch + CUDA")
    p.add_argument("source", nargs="+",
                   help="input(s): a media path (.y4m, .mkv/.webm, .avi, "
                        ".mp4/.mov, .mjpeg, .yuv, images, mf://...), - "
                        "for stdin, a tcp/unix/http(s) URL or "
                        "synthetic:<moving_box|gradient_pan|noise|"
                        "scene_cut>; several inputs play as one gapless "
                        "playlist, .edl inputs expand into their segments")
    p.add_argument("--playlist", default="",
                   help="read more entries from this file: plain lists, "
                        "m3u/m3u8, pls or mpv EDL v0 timelines; relative "
                        "entries resolve against its directory")
    p.add_argument("--width", type=int, default=1920,
                   help="synthetic/raw .yuv width")
    p.add_argument("--height", type=int, default=1080,
                   help="synthetic/raw .yuv height")
    p.add_argument("--fps", type=float, default=24.0,
                   help="synthetic/raw .yuv/.mjpeg source fps")
    p.add_argument("--frames", type=int, default=96,
                   help="max source frames to process (0 = all)")
    p.add_argument("--p010", action="store_true",
                   help="run the 10-bit pipeline")
    p.add_argument("--display-fps", type=float, default=60.0,
                   help="target display rate")
    p.add_argument("--untimed", action="store_true",
                   help="do not pace output to the display clock")
    p.add_argument("--no-present", action="store_true",
                   help="skip the present clock entirely (max throughput)")
    p.add_argument("--mode", default="blend",
                   help="output mode: warp12|warp21|blend|hsv|grey|sbs1|sbs2 "
                        "or FrameOutput integer 0-6")
    p.add_argument("--speed", type=float, default=1.0, help="playback speed")
    p.add_argument("--model", default="hopper", choices=MODELS,
                   help="interpolator family: " + "|".join(MODELS))
    p.add_argument("--search-radius", type=int, default=5,
                   help="initial optical-flow search radius [2..256]; the "
                        "auto-quality controller moves it within [5..16]")
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
                   help="accepted and ignored: the port compiles nothing "
                        "per radius (its kernels build once, at first "
                        "use)")
    p.add_argument("--warp-sampling", default="pair",
                   choices=("pair", "shift", "gather", "pallas", "fused"),
                   help="blend-mode warp kernel of hopper, blend and "
                        "repeat: pair/shift/gather = every blend position "
                        "of a pair in one launch, fused = one launch per "
                        "position, pallas = two one-direction launches and "
                        "one blend launch per position (identical "
                        "outputs); hopperx, hopperq and hopperxq take "
                        "their own route under any sampler")
    p.add_argument("--subpel-flow", action="store_true",
                   help="measured fractional-pel flow refinement: "
                        "parabolic sub-pel fit of the SAD surface; "
                        "hopperq/hopperxq warp at 1/64-pel, hopper/hopperx "
                        "get a round-to-nearest field (quality option; "
                        "changes the flow families' output)")
    p.add_argument("--warp-loop", default="vmap", choices=("vmap", "scan"),
                   help="accepted and ignored: how the JAX package "
                        "expresses its warp batch")
    p.add_argument("--timing-source", default="auto",
                   choices=("auto", "block", "amortized"),
                   help="accepted and ignored: the port times each pair "
                        "with CUDA events")
    p.add_argument("--layer-buckets", default="5,8,16",
                   help="comma-separated flow layer counts; the live search "
                        "radius runs the smallest that covers it, so a lower "
                        "radius cuts the flow kernel's work (empty = 16 "
                        "layers up to radius 16)")
    p.add_argument("--degrade-rungs", default="2:2,2:2:blend",
                   help="degradation ladder beyond the radius floor, as "
                        "comma-separated iteration_delta:res_divisor"
                        "[:model] rungs (the auto-quality controller "
                        "steps down pyramid depth / calc resolution / "
                        "interpolator family when radius alone cannot "
                        "restore real-time; empty disables)")
    p.add_argument("-o", "--output", default="",
                   help="write outputs to a .y4m file, to stdout as y4m "
                        "(-), or FFV1 in Matroska (.mkv)")
    p.add_argument("--dump-pgm", default="",
                   help="dump luma planes as PGM files into this directory")
    p.add_argument("--dump-png", default="",
                   help="dump outputs as colour PNGs into this directory")
    p.add_argument("--osd", action="store_true",
                   help="burn a stats line into the output frames")
    p.add_argument("--group", type=int, default=1,
                   help="encode throughput: dispatch N source pairs per "
                        "group (engine.push_many; on the card one CUDA "
                        "graph replay a group).  Adds up to N source "
                        "intervals of latency and disables pause/seek, so "
                        "it requires an encode sink (-o/--dump-pgm/"
                        "--dump-png) and implies --untimed")
    p.add_argument("--loop", type=int, default=0,
                   help="replay the source N more times after EOF "
                        "(-1 = forever; --loop-file analog; needs a "
                        "seekable source)")
    p.add_argument("--start", type=float, default=None,
                   help="start at this source pts (seconds): a seek where "
                        "the source can, else the frames before it are "
                        "skipped; defaults to a watch-later position if "
                        "one exists")
    p.add_argument("--end", type=float, default=None,
                   help="stop playback at this source pts (seconds; mpv "
                        "--end analog)")
    p.add_argument("--play-direction", default="forward",
                   choices=("forward", "backward"),
                   help="backward plays a seekable source last-to-first "
                        "(chunked reverse reads); pipes spool through the "
                        "cache first")
    p.add_argument("--cache", default="auto", choices=("auto", "yes", "no"),
                   help="seekable frame cache over the source (spooled to "
                        "a temporary file); auto = only when the source "
                        "cannot seek by itself (pipes, streams, synthetic "
                        "clips)")
    p.add_argument("--ingest", default="auto",
                   choices=("auto", "native", "python"),
                   help="host ingest: the native library's reader rings "
                        "(page-locked buffers on a card) and codecs "
                        "(native), the Python readers and codecs (python), "
                        "or native with the Python y4m reader for "
                        "odd-sized y4m (auto)")
    p.add_argument("--mf-fps", type=float, default=1.0,
                   help="frame rate of mf:// image sequences")
    p.add_argument("--vf", default="",
                   help="host filter chain before interpolation, e.g. "
                        "'crop=640:360,vflip,fps=24'")
    p.add_argument("--applet-fifo", default="",
                   help="serve the HopperRender settings-applet protocol on "
                        "this FIFO path (e.g. /tmp/hopperrender)")
    p.add_argument("--ipc-server", default="",
                   help="serve JSON IPC on this unix socket path "
                        "(mpv --input-ipc-server analog)")
    p.add_argument("--interactive", action="store_true",
                   help="terminal keyboard control: arrows seek, space "
                        "pause, . frame-step, [ ] speed, s screenshot, q "
                        "quit, Q quit+save")
    p.add_argument("--input-conf", default="",
                   help="key bindings file (mpv input.conf line format: "
                        "'KEY command args'; overlays the defaults)")
    p.add_argument("--no-input-default-bindings", action="store_true",
                   help="start from an empty bindings table")
    p.add_argument("--script", default="",
                   help="run a Python script on a thread with `player` (an "
                        "api.Player) and `pipeline` bound to the live run")
    p.add_argument("--save-position-on-quit", action="store_true",
                   help="persist playback position + knobs per input file "
                        "(watch-later)")
    p.add_argument("--save-position-interval", type=float, default=60.0,
                   help="with --save-position-on-quit: also save the "
                        "position every N seconds, so a crash loses at "
                        "most that much progress; 0 disables")
    p.add_argument("--no-resume", action="store_true",
                   help="ignore an existing watch-later entry")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the run (host "
                        "ops, and every kernel with its device time on a "
                        "card) to DIR/trace.json, with the engine's mfi.* "
                        "spans (listed in utils/trace.py) on the same "
                        "clock")
    p.add_argument("--no-stage-uploads", action="store_true",
                   help="upload each frame on the engine's thread instead "
                        "of the prefetch thread")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (default cuda)")
    p.add_argument("--dump-stats", default="",
                   help="write the run's stats (JSON) to this file at exit")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--version", action="version",
                   version=f"mpv_frame_interpolator_tpu_torch {__version__}")
    options.add_config_flags(p)
    return p


def make_source(args, entry: Optional[str] = None):
    """(frame iterator, width, height) of one input (default: the first
    positional one).  Readers of files that go to a card read into
    page-locked buffers; `--ingest python` takes the Python readers and
    codecs, anything else the native ones."""
    if entry is None:
        entry = args.source[0]
    pixfmt = P010 if args.p010 else NV12
    use_native = args.ingest != "python"
    if entry.startswith("mf://") or (
            "://" not in entry and not entry.startswith("synthetic:")
            and mf.is_image_path(entry)):
        try:
            rdr = mf.MFReader(entry, fps=args.mf_fps, pixfmt=pixfmt,
                              use_native=use_native)
        except mf.MFError as e:
            raise SystemExit(f"cannot open image sequence {entry!r}: {e}")
        return rdr, rdr.width, rdr.height
    if entry.startswith("synthetic:"):
        name = entry.split(":", 1)[1]
        gen = getattr(synthetic, name, None)
        if gen is None:
            raise SystemExit(f"unknown synthetic source {name!r}")
        cfg = synthetic.SyntheticConfig(width=args.width, height=args.height,
                                        fps=args.fps, pixfmt=pixfmt)
        return (_SyntheticClip(gen(cfg, args.frames or 1 << 30), cfg),
                cfg.width, cfg.height)
    if entry == "-":
        return _stdin_source(args)
    if stream.is_stream_url(entry):
        return _stream_source(entry)
    if entry.endswith(".yuv"):
        rdr = y4m.RawYUVReader(open(entry, "rb"), args.width, args.height,
                               args.fps, pixfmt)
        return rdr, args.width, args.height
    if entry.endswith((".mjpeg", ".mjpg")):
        # raw concatenated JPEGs (an IP camera's dump); the rate is --fps
        with open(entry, "rb") as probe:
            head = probe.read(1 << 20)
        first = next(jpeg.split_jpeg_stream(io.BytesIO(head).read), None)
        if first is None:
            raise SystemExit(f"{entry!r}: no JPEG frames found")
        h0, w0 = jpeg.decode_jpeg_planes(first, use_native)[0].shape
        return (jpeg.mjpeg_source(entry, fps=args.fps, use_native=use_native),
                w0 + w0 % 2, h0 + h0 % 2)
    if entry.endswith(".y4m"):
        if args.ingest == "python":
            rdr = y4m.Y4MReader(open(entry, "rb"),
                                pool=PinnedPool(8, device=args.device))
        elif args.ingest == "native":
            rdr = ingest.NativeY4MSource(entry, device=args.device)
        else:
            rdr = ingest.open_y4m(entry, device=args.device)
        return rdr, rdr.width, rdr.height
    kind = ingest.container_reader(entry)
    if kind is not None:
        err_cls = kind[1]
        try:
            rdr = _open_container_path(args, entry, kind[0])
            return rdr, rdr.width, rdr.height
        except err_cls as e:
            # a codec no native decoder takes: ffmpeg's job
            if not decode.have_ffmpeg():
                raise SystemExit(f"cannot open {entry!r}: {e}")
            log.info("native %s demux declined (%s); using ffmpeg",
                     kind[2], e)
    if not decode.have_ffmpeg():
        raise SystemExit(f"cannot open {entry!r}: the port reads .y4m, "
                         ".yuv, .mjpeg, images and MKV/MP4/AVI with raw "
                         "video, FFV1, Ut Video or MJPEG; anything else "
                         "needs ffmpeg, which is not installed")
    return decode.ffmpeg_source(entry, pixfmt), args.width, args.height


class _SyntheticClip:
    """A synthetic clip with the attributes a reader has (width, height,
    fps, pixfmt), which a playlist reads from its first entry."""

    def __init__(self, frames, cfg):
        self._frames = frames
        self.width, self.height = cfg.width, cfg.height
        self.fps, self.pixfmt = cfg.fps, cfg.pixfmt

    def __iter__(self):
        return self._frames


def _open_container_path(args, path: str, reader_cls):
    if args.ingest == "python":
        return reader_cls(path, use_native=False)
    # raw video through the native indexed ring, compressed video
    # through the reader's native decoders
    return ingest.open_container(path, device=args.device)


def _stdin_source(args):
    """A y4m stream or a container piped on stdin."""
    raw = sys.stdin.buffer.raw
    # sniff the pipe: EBML / ISO-BMFF / RIFF-AVI magic means a piped
    # container (spooled to a file for the indexed readers); anything
    # else is y4m
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
            raw, magic, ".mkv" if is_ebml else ".avi" if is_avi else ".mp4")
        reader_cls, err_cls, name = ingest.container_reader(path)
        try:
            rdr = _open_container_path(args, path, reader_cls)
        except err_cls as e:
            raise SystemExit(f"cannot open piped {name}: {e}")
        return rdr, rdr.width, rdr.height
    if args.ingest != "python":
        # the C++ ring reads an fd directly (no buffered layer stealing
        # bytes); the sniffed magic is replayed through a feeder pipe.
        # Pipes stream, they just cannot seek.
        rdr = ingest.NativeY4MSource(_replay_fd(magic, raw),
                                     device=args.device)
    else:
        rdr = y4m.Y4MReader(io.BufferedReader(
            io.FileIO(_replay_fd(magic, raw), "rb")),
            pool=PinnedPool(8, device=args.device))
    return rdr, rdr.width, rdr.height


def _stream_source(url: str):
    """A tcp/unix/http(s) stream: y4m, or a container over http(s) with
    byte-range seeking."""
    from urllib.parse import urlparse
    upath = urlparse(url).path
    kind = ingest.container_reader(upath)
    if kind is not None and url.startswith("http"):
        fh = stream.open_http_file(url)
        if fh is None:
            raise SystemExit(
                f"{url!r}: server lacks byte-range support; containers "
                "need it (serve as .y4m to stream instead)")
        rdr = kind[0](fh)
        return rdr, rdr.width, rdr.height
    rdr = y4m.Y4MReader(stream.open_stream(url))
    return rdr, rdr.width, rdr.height


def _spool_stdin_container(raw, magic: bytes, suffix: str) -> str:
    """A piped container spooled to a temporary file (removed at exit),
    so the indexed readers can serve it: the demux cache's
    make-pipes-seekable move, done at the byte layer because a container
    index needs random access."""
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
    """Read end of a pipe that replays `first` then pumps `src` (hands
    sniffed stdin bytes back to fd-level readers)."""
    r, w = os.pipe()

    def pump():
        try:
            data = first
            while data:
                os.write(w, data)
                data = src.read(1 << 16) or b""
        except OSError:
            pass
        finally:
            os.close(w)

    threading.Thread(target=pump, daemon=True).start()
    return r


def playlist_entries(args) -> list:
    """The playlist's entries: the positional inputs, --playlist's and
    the segments of .edl inputs."""
    entries = list(args.source)
    if args.playlist:
        try:
            entries.extend(playlist.parse_playlist(args.playlist))
        except OSError as e:
            raise SystemExit(f"cannot read playlist {args.playlist!r}: {e}")
        except ValueError as e:
            raise SystemExit(f"bad playlist {args.playlist!r}: {e}")
    expanded = []
    for e in entries:
        if isinstance(e, str) and e.lower().endswith(".edl"):
            try:
                expanded.extend(playlist.parse_playlist(e))
            except (OSError, ValueError) as err:
                raise SystemExit(f"bad EDL {e!r}: {err}")
        else:
            expanded.append(e)
    return expanded


def open_entries(args, expanded: list):
    """The playlist's entries opened as one source: (source, width,
    height)."""
    if len(expanded) == 1 and not isinstance(expanded[0],
                                             playlist.EDLEntry):
        return make_source(args, expanded[0])

    def open_entry(entry):
        if isinstance(entry, playlist.EDLEntry):
            return playlist.ClipSource(make_source(args, entry.path)[0],
                                       entry.start, entry.length)
        return make_source(args, entry)[0]

    source = playlist.ChainedSource(expanded, open_entry)
    log.info("playlist: %d entries, %dx%d timeline", len(expanded),
             source.width, source.height)
    return source, source.width, source.height


def _seekable(source) -> bool:
    return (hasattr(source, "seek_pts")
            and getattr(source, "seekable", lambda: False)())


def source_options(args, source):
    """--cache and --play-direction around the opened source.  ``--cache
    auto`` caches any source that cannot seek by itself: a pipe, a stream,
    a synthetic clip (the JAX CLI's rule)."""
    if args.cache == "yes" or (args.cache == "auto"
                               and not _seekable(source)):
        source = cache.CachedSource(source)
        log.info("seekable frame cache enabled")
    if args.play_direction == "backward":
        if args.start is not None:
            log.warning("--start is ignored with --play-direction=backward")
        try:
            return reverse.ReversedSource(source)
        except reverse.ReverseError as e:
            raise SystemExit(f"--play-direction=backward: {e}")
    return source


def start_at(source, start_pts: float):
    """The source from `start_pts` on: a seek where the source can, else
    the frames before it are skipped."""
    if _seekable(source):
        actual = source.seek_pts(start_pts)
        log.info("seeked source to %.3fs (requested %.3fs)", actual,
                 start_pts)
        return source
    return _skip_until(source, start_pts)


def _skip_until(src, t0: float):
    for f in src:
        if f.pts >= t0 - 1e-9:
            yield f
        elif f.recycle is not None:
            f.recycle()


def make_sink(args, width: int, height: int, engine):
    pixfmt = P010 if args.p010 else NV12
    if args.output == "-":
        sink = sinks.Y4MFileSink(sys.stdout.buffer, width, height,
                                 args.display_fps, pixfmt)
    elif args.output.lower().endswith((".mkv", ".mka")):
        sink = sinks.FFV1MKVSink(args.output, width, height,
                                 args.display_fps, pixfmt)
    elif args.output:
        sink = sinks.Y4MFileSink(args.output, width, height,
                                 args.display_fps, pixfmt)
    elif args.dump_pgm:
        sink = sinks.PgmDumpSink(args.dump_pgm)
    elif args.dump_png:
        sink = sinks.PngDumpSink(args.dump_png)
    else:
        sink = sinks.NullSink()
    return sinks.OsdSink(sink, engine) if args.osd else sink


def _watch_later_props(engine) -> dict:
    return {"speed": engine.cadence.playback_speed,
            "frame-output-mode": engine.frame_output_mode,
            "search-radius": engine.quality.search_radius,
            "black-level": engine.black_level,
            "white-level": engine.white_level,
            "scene-threshold": engine.scene.threshold}


def _save_on_exit(engine, media: str, save_on_exit: list):
    if save_on_exit[0]:
        path = resume.save(media, engine.cadence.current_output_pts,
                           _watch_later_props(engine))
        log.info("watch-later state saved to %s", path)


def _start_surfaces(args, stack: contextlib.ExitStack, engine, pipe,
                    media: str, is_file: bool, save_on_exit: list):
    """Start the control surfaces the flags ask for (JAX cli.py:632-708),
    each with its stop pushed on `stack`.  Each surface drives the engine
    through its own api.Player bound to the pipeline."""

    def player():
        p = Player(engine=engine)
        p.bind_pipeline(pipe)
        return p

    if args.script:
        with open(args.script) as fh:
            code = compile(fh.read(), args.script, "exec")
        scope = {"player": player(), "pipeline": pipe}

        def run_script():
            try:
                exec(code, scope)
            except Exception:   # noqa: BLE001 - a control thread's boundary
                count_failure(engine, f"--script {args.script}")

        script = threading.Thread(target=run_script, name="mfi-script",
                                  daemon=True)
        script.start()
        stack.callback(_join, script, "the --script thread")
    if args.interactive:
        from mpv_frame_interpolator_tpu_torch.control.input import (
            KeyDispatcher, TerminalInput, parse_input_conf)
        bindings = None
        if args.input_conf:
            with open(args.input_conf) as fh:
                bindings = parse_input_conf(fh.read())

        def on_quit(watch_later: bool):
            if watch_later and is_file:
                save_on_exit[0] = True
            pipe.quit()

        dispatcher = KeyDispatcher(
            player(), pipe, on_quit=on_quit, bindings=bindings,
            default_bindings=not args.no_input_default_bindings)
        try:
            stack.callback(TerminalInput(dispatcher).start().stop)
            log.info("terminal input active (q quits)")
        except OSError as e:
            log.warning("no controlling terminal (%s); --interactive "
                        "disabled", e)
    if args.applet_fifo:
        from mpv_frame_interpolator_tpu_torch.control.applet import (
            AppletServer)
        applet = AppletServer(args.applet_fifo, engine)
        applet.start()
        stack.callback(applet.stop)
    if args.ipc_server:
        from mpv_frame_interpolator_tpu_torch.control.ipc import IPCServer
        ipc = IPCServer(args.ipc_server, player())
        ipc.start()
        stack.callback(ipc.stop)
    if is_file and args.save_position_on_quit \
            and args.save_position_interval > 0:
        stop = threading.Event()

        def periodic_save():
            while not stop.wait(args.save_position_interval):
                try:
                    resume.save(media, engine.cadence.current_output_pts,
                                _watch_later_props(engine))
                except OSError:
                    count_failure(engine, "the watch-later save")

        saver = threading.Thread(target=periodic_save, name="mfi-save",
                                 daemon=True)
        saver.start()
        stack.callback(_join, saver, "the watch-later save thread")
        stack.callback(stop.set)


def _join(thread: threading.Thread, what: str, timeout: float = 2.0):
    thread.join(timeout)
    if thread.is_alive():
        log.warning("%s is still running at exit (a daemon thread: it "
                    "ends with the process)", what)


def main(argv=None) -> int:
    args = options.parse_with_config(build_parser(), argv)
    if args.verbose:
        set_verbosity(10)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available on "
                         "this machine (pass --device cpu to run the plain "
                         "PyTorch path)")

    try:
        mode = int(args.mode)
    except ValueError:
        mode = MODES.get(args.mode)
        if mode is None:
            raise SystemExit(f"unknown mode {args.mode!r}")

    group = max(args.group, 1)
    if group > 1 and not (args.output or args.dump_pgm or args.dump_png):
        raise SystemExit("--group requires an encode sink (-o/--dump-pgm/"
                         "--dump-png): grouped dispatch buffers N source "
                         "intervals, which realtime playback cannot absorb")
    entries = playlist_entries(args)
    first = entries[0]
    # the single-file surfaces (watch-later) key on the first entry
    media = first.path if isinstance(first, playlist.EDLEntry) else first
    source, width, height = open_entries(args, entries)
    opened = [source]
    source = source_options(args, source)
    opened.append(source)
    engine = InterpolationEngine(EngineConfig(
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
        model=args.model,
        subpel_flow=args.subpel_flow,
        warp_sampling=args.warp_sampling,
        layer_buckets=tuple(int(b) for b in args.layer_buckets.split(",")
                            if b.strip()),
        degrade_rungs=tuple(
            tuple(int(x) if i < 2 else x
                  for i, x in enumerate(r.split(":", 2)))
            for r in args.degrade_rungs.split(",") if r.strip()),
        device=args.device))
    if args.speed != 1.0:
        engine.set_speed(args.speed)

    # watch-later resume (JAX cli.py:541-560) of a single file: a chained
    # timeline's pts can exceed any one entry's duration, and backward
    # play has a reversed timeline, so neither resumes
    is_file = len(entries) == 1 and not media.startswith("synthetic:")
    start_pts = args.start
    if args.play_direction == "backward":
        start_pts = None
    elif is_file and not args.no_resume:
        state = resume.load(media)
        if state:
            pos = resume.apply_to_player(Player(engine=engine), state)
            if start_pts is None:
                start_pts = pos
            log.info("resumed watch-later state (position %.2fs, %s)",
                     pos, {k: v for k, v in state.items() if k != "start"})
    if start_pts:
        source = start_at(source, start_pts)
    if args.vf:
        source = filters.apply_chain(filters.parse_chain(args.vf), source)
    sink = make_sink(args, width, height, engine)
    present = None
    if not args.no_present and group == 1:
        present = PresentClock(args.display_fps, untimed=args.untimed)
    pipe = Pipeline(source, engine, sink, present,
                    stage_uploads=not args.no_stage_uploads, group=group)
    pipe.loop = args.loop
    pipe.end_pts = args.end

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        # unwound in reverse, also when the run fails: the trace ends, the
        # control surfaces stop, the position is saved, the sources close
        for src in opened:
            if hasattr(src, "close"):
                stack.callback(src.close)
        save_on_exit = [is_file and args.save_position_on_quit]
        stack.callback(_save_on_exit, engine, media, save_on_exit)
        _start_surfaces(args, stack, engine, pipe, media, is_file,
                        save_on_exit)
        if args.profile_dir:
            from mpv_frame_interpolator_tpu_torch.utils.trace import (
                device_trace)
            stack.enter_context(device_trace(args.profile_dir))
        n = pipe.run(max_source_frames=args.frames or None)
    dt = time.perf_counter() - t0
    summary = engine.stats.summary()
    s = summary.get("source_frame_time", {})
    failures = pipe.engine_failures()
    if args.dump_stats:
        upload = summary.get("upload_time", {})
        with open(args.dump_stats, "w") as fh:
            json.dump({"stats": summary,
                       "search_radius": engine.quality.search_radius,
                       "level": engine.quality.level,
                       "state": engine.cadence.state.name,
                       "frames_in": pipe.frames_in,
                       "frames_out": pipe.frames_out,
                       "scene_cuts": engine.scene_cuts(),
                       "engine_failures": failures,
                       "control_failures":
                           engine.stats.count("control_failures"),
                       "underruns": pipe.underruns,
                       "sources_dropped": pipe.sources_dropped,
                       "seeks": pipe.seeks,
                       "group": group,
                       "group_stats": engine.group_stats,
                       "plan_stats": engine.plan_stats,
                       "graphs": [dict(g, key=list(g["key"]))
                                  for g in engine.graph_stats()],
                       # seconds over the run: the reader thread's in the
                       # source and in uploads (overlapping the rest),
                       # the copies' device time, the engine calls', and
                       # the sink's downloads and writes
                       "wall": {
                           "read": pipe.read_time,
                           "stage": pipe.stage_time,
                           "upload_device": upload.get("mean", 0.0)
                           * upload.get("count", 0),
                           "engine": pipe.engine_time,
                           "download": getattr(sink, "download_time", 0.0),
                           "write": getattr(sink, "write_time", 0.0)},
                       "device": str(engine.device),
                       "seconds": dt}, fh, indent=2)
    log.info("%d source -> %d output frames in %.2fs (%.1f out-fps); "
             "per-pair mean=%.2fms p99=%.2fms; radius=%d; engine failures "
             "%d", pipe.frames_in, n, dt, n / dt if dt else 0.0,
             s.get("mean", 0.0) * 1e3, s.get("p99", 0.0) * 1e3,
             engine.quality.search_radius, failures)
    return 0


if __name__ == "__main__":
    sys.exit(main())
