"""Command-line entry point of the port (the slice of the JAX package's
``cli.main``).

Examples:
  python -m mpv_frame_interpolator_tpu_torch synthetic:moving_box \
      --width 3840 --height 2160 --display-fps 120 --search-radius 16 \
      --untimed -o out.y4m
  python -m mpv_frame_interpolator_tpu_torch synthetic:moving_box --p010 \
      --black-level 16 --white-level 235 --warp-sampling fused -o out.y4m
  python -m mpv_frame_interpolator_tpu_torch input.y4m --device cpu -o out.y4m

The device is explicit: ``--device cuda`` (the default) needs a card and
fails if there is none; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mpv_frame_interpolator_tpu_torch.frame import NV12, P010
from mpv_frame_interpolator_tpu_torch.io import sinks, synthetic, y4m
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator_tpu_torch.pipeline.player import Pipeline
from mpv_frame_interpolator_tpu_torch.pipeline.present import PresentClock
from mpv_frame_interpolator_tpu_torch.utils import get_logger
from mpv_frame_interpolator_tpu_torch.utils.logging import set_verbosity

log = get_logger("cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpv_frame_interpolator_tpu_torch",
        description="optical-flow frame interpolation on PyTorch + CUDA")
    p.add_argument("source",
                   help="input: a .y4m path or synthetic:<moving_box|"
                        "gradient_pan|noise|scene_cut>")
    p.add_argument("--width", type=int, default=1920,
                   help="synthetic width")
    p.add_argument("--height", type=int, default=1080,
                   help="synthetic height")
    p.add_argument("--fps", type=float, default=24.0,
                   help="synthetic source fps")
    p.add_argument("--frames", type=int, default=96,
                   help="max source frames to process (0 = all)")
    p.add_argument("--p010", action="store_true",
                   help="run the 10-bit pipeline")
    p.add_argument("--display-fps", type=float, default=60.0,
                   help="target display rate")
    p.add_argument("--search-radius", type=int, default=5,
                   help="initial optical-flow search radius [5..16]")
    p.add_argument("--no-auto-quality", action="store_true",
                   help="disable the auto search-radius controller")
    p.add_argument("--no-scene-detection", action="store_true")
    p.add_argument("--black-level", type=float, default=0.0)
    p.add_argument("--white-level", type=float, default=255.0)
    p.add_argument("--warp-sampling", default="pair",
                   choices=("pair", "shift", "gather", "fused"),
                   help="warp kernel: pair/shift/gather = every blend "
                        "position of a pair in one launch (identical "
                        "outputs), fused = one launch per position")
    p.add_argument("--untimed", action="store_true",
                   help="do not pace output to the display clock")
    p.add_argument("-o", "--output", default="",
                   help="write outputs to a .y4m file")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (default cuda)")
    p.add_argument("--dump-stats", default="",
                   help="write the run's stats (JSON) to this file at exit")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def make_source(args):
    """(frame iterator, width, height) for a synthetic or .y4m source."""
    if args.source.startswith("synthetic:"):
        name = args.source.split(":", 1)[1]
        gen = getattr(synthetic, name, None)
        if gen is None:
            raise SystemExit(f"unknown synthetic source {name!r}")
        cfg = synthetic.SyntheticConfig(width=args.width, height=args.height,
                                        fps=args.fps,
                                        pixfmt=P010 if args.p010 else NV12)
        return gen(cfg, args.frames or 1 << 30), cfg.width, cfg.height
    if args.source.endswith(".y4m"):
        rdr = y4m.Y4MReader(open(args.source, "rb"))
        return rdr, rdr.width, rdr.height
    raise SystemExit(f"unsupported source {args.source!r} (the port reads "
                     ".y4m files and synthetic:<name>)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose:
        set_verbosity(10)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available on "
                         "this machine (pass --device cpu to run the plain "
                         "PyTorch path)")

    source, width, height = make_source(args)
    engine = InterpolationEngine(EngineConfig(
        display_fps=args.display_fps,
        auto_quality=not args.no_auto_quality,
        initial_search_radius=args.search_radius,
        scene_detection=not args.no_scene_detection,
        black_level=args.black_level,
        white_level=args.white_level,
        warp_sampling=args.warp_sampling,
        device=args.device))
    sink = (sinks.Y4MFileSink(args.output, width, height, args.display_fps,
                              P010 if args.p010 else NV12)
            if args.output else sinks.NullSink())
    present = PresentClock(args.display_fps, untimed=args.untimed)
    pipe = Pipeline(source, engine, sink, present)

    t0 = time.perf_counter()
    n = pipe.run(max_source_frames=args.frames or None)
    dt = time.perf_counter() - t0
    s = engine.stats.summary().get("source_frame_time", {})
    if args.dump_stats:
        with open(args.dump_stats, "w") as fh:
            json.dump({"stats": engine.stats.summary(),
                       "search_radius": engine.quality.search_radius,
                       "state": engine.cadence.state.name,
                       "frames_in": pipe.frames_in,
                       "frames_out": pipe.frames_out,
                       "scene_cuts": engine.scene_cuts(),
                       "device": str(engine.device),
                       "seconds": dt}, fh, indent=2)
    log.info("%d source -> %d output frames in %.2fs (%.1f out-fps); "
             "per-pair mean=%.2fms p99=%.2fms; radius=%d",
             pipe.frames_in, n, dt, n / dt if dt else 0.0,
             s.get("mean", 0.0) * 1e3, s.get("p99", 0.0) * 1e3,
             engine.quality.search_radius)
    return 0


if __name__ == "__main__":
    sys.exit(main())
