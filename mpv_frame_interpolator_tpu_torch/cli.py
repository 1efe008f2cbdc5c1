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
from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool
from mpv_frame_interpolator_tpu_torch.models import MODELS
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)
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
                   help="write outputs to a .y4m file")
    p.add_argument("--group", type=int, default=1,
                   help="encode throughput: dispatch N source pairs per "
                        "group (engine.push_many; on the card one CUDA "
                        "graph replay a group).  Adds up to N source "
                        "intervals of latency and disables pause/seek, so "
                        "it requires -o and implies --untimed")
    p.add_argument("--loop", type=int, default=0,
                   help="replay the source N more times after EOF "
                        "(-1 = forever; --loop-file analog; needs a "
                        "seekable source: a .y4m file)")
    p.add_argument("--end", type=float, default=None,
                   help="stop playback at this source pts (seconds; mpv "
                        "--end analog)")
    p.add_argument("--no-stage-uploads", action="store_true",
                   help="upload each frame on the engine's thread instead "
                        "of the prefetch thread")
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
        # page-locked read buffers when the frames go to a card
        rdr = y4m.open_source(args.source,
                              pool=PinnedPool(8, device=args.device))
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

    try:
        mode = int(args.mode)
    except ValueError:
        mode = MODES.get(args.mode)
        if mode is None:
            raise SystemExit(f"unknown mode {args.mode!r}")

    group = max(args.group, 1)
    if group > 1 and not args.output:
        raise SystemExit("--group requires -o: grouped dispatch buffers N "
                         "source intervals, which realtime playback cannot "
                         "absorb")
    source, width, height = make_source(args)
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
    sink = (sinks.Y4MFileSink(args.output, width, height, args.display_fps,
                              P010 if args.p010 else NV12)
            if args.output else sinks.NullSink())
    present = None
    if not args.no_present and group == 1:
        present = PresentClock(args.display_fps, untimed=args.untimed)
    pipe = Pipeline(source, engine, sink, present,
                    stage_uploads=not args.no_stage_uploads, group=group)
    pipe.loop = args.loop
    pipe.end_pts = args.end

    t0 = time.perf_counter()
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
                       "underruns": pipe.underruns,
                       "sources_dropped": pipe.sources_dropped,
                       "seeks": pipe.seeks,
                       "group": group,
                       "group_stats": engine.group_stats,
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
