"""Device breakdown of the engine's source pairs on the card.

    python -m mpv_frame_interpolator_tpu_torch.profile_pair [--trace t.json]
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --p010 \
        --warp-sampling fused --black-level 16 --white-level 235
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --mode warp12
    python -m mpv_frame_interpolator_tpu_torch.profile_pair \
        --warp-sampling pallas
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --mode hsv
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --model hopperxq
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --mode sbs2
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --search-radius 5
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --model hopperq \
        --subpel-flow
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --level 2
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --group 8
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --stage

Stages a synthetic ``moving_box`` clip at the main path's shape (4K,
24 -> 120 fps, radius 16 or --search-radius; 8-bit NV12, or P010 with
--p010; output mode --mode, blend by default; model family --model, hopper
by default; the sub-pel option with --subpel-flow; the degradation
ladder's rung --level N of the default ladder, 0 by default, pinned) on
the card, pushes WARM pairs through the
engine, then pushes PAIRS more under ``torch.profiler`` with one
synchronise at the end.  With --group N the pairs go through
``push_many`` N at a time (the warm pairs too, so each group replays a
captured CUDA graph); with --stage the frames wait on the host in
page-locked buffers and each is uploaded by ``engine.stage`` inside the
profiled window (the copy stream's copies and split show in the rows).
Prints the wall per pair, the card's own time
per pair (the sum of every kernel's and memset's device time as CUPTI
reports it), the share of the wall the card was busy, and the device
time and count per pair of each kernel, and under --group the host's
launches a pair (graph replays and copies).  The
profiler adds host cost per launch, so the wall here is longer than an
unprofiled run's; the device times are the card's alone.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from mpv_frame_interpolator_tpu_torch import cli
from mpv_frame_interpolator_tpu_torch.models import MODELS
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)

WIDTH, HEIGHT, DISPLAY_FPS = 3840, 2160, 120.0
WARM, PAIRS = 3, 10


def self_device_us(evt) -> float:
    """Device time of a kernel, memset or copy row; 0 for a host row (an
    aten op or a CUDA runtime call also carries the device time of what
    it launched, which would count that work twice)."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def pinned_frames(frames):
    """Host frames copied into page-locked pool buffers, each with the
    recycle hook that hands them back."""
    from mpv_frame_interpolator_tpu_torch.frame import VideoFrame
    from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool
    pool = PinnedPool(2 * len(frames), device="cuda")
    out = []
    for f in frames:
        y = pool.get(f.y.shape, f.y.dtype)
        uv = pool.get(f.uv.shape, f.uv.dtype)
        y[:], uv[:] = f.y, f.uv

        def recycle(y=y, uv=uv):
            pool.give_back(y)
            pool.give_back(uv)

        out.append(VideoFrame(y, uv, f.fmt, f.pts, f.nominal_fps, recycle))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="profile_pair", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--trace", default="",
                   help="write a Chrome trace of the profiled pairs here")
    p.add_argument("--p010", action="store_true", help="10-bit frames")
    p.add_argument("--mode", default="blend", choices=list(cli.MODES))
    p.add_argument("--model", default="hopper", choices=MODELS)
    p.add_argument("--warp-sampling", default="pair",
                   choices=("pair", "fused", "pallas"))
    p.add_argument("--black-level", type=float, default=0.0)
    p.add_argument("--white-level", type=float, default=255.0)
    p.add_argument("--search-radius", type=int, default=16)
    p.add_argument("--subpel-flow", action="store_true")
    p.add_argument("--level", type=int, default=0,
                   help="pin the degradation ladder's level (0 = the "
                        "configured quality, 1-3 the default rungs)")
    p.add_argument("--group", type=int, default=1,
                   help="push_many groups of N pairs (CUDA graph replays)")
    p.add_argument("--stage", action="store_true",
                   help="upload each frame (engine.stage, from page-locked "
                        "buffers) inside the profiled window")
    return p


def profile(argv=None, opening=None) -> dict:
    """Push the profiled pairs (see the module's docstring); returns the
    parsed arguments ("args"), the engine ("engine"), the pairs profiled
    ("pairs"), the wall in seconds ("wall"), the device ms of the window
    ("device_ms"), its device rows [(name, count, device us)] longest
    first ("rows") and, under --group, the host's launches ("group").
    `opening`, if given, runs spin kernels (``torch.cuda._sleep``) inside
    the trace before the pairs, and their rows are left out: a trace late
    in a long process loses the first device records it takes."""
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pair: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile

    eng = InterpolationEngine(EngineConfig(
        display_fps=DISPLAY_FPS, frame_output_mode=cli.MODES[args.mode],
        model=args.model, auto_quality=False,
        initial_search_radius=args.search_radius,
        warp_sampling=args.warp_sampling, subpel_flow=args.subpel_flow,
        black_level=args.black_level, white_level=args.white_level,
        device="cuda"))
    if not 0 <= args.level <= len(eng.config.degrade_rungs):
        raise SystemExit(f"profile_pair: --level {args.level} is not a "
                         "level of the ladder")
    eng.quality.level = args.level
    group = max(args.group, 1)
    # whole groups only: a partial group would capture a graph of its own
    # inside the window
    pairs = group * -(-PAIRS // group)
    warm = WARM if group == 1 else 2 * group
    src = list(cli.make_source(cli.build_parser().parse_args(
        ["synthetic:moving_box", "--width", str(WIDTH), "--height",
         str(HEIGHT), "--fps", "24", "--frames", str(1 + warm + pairs)]
        + (["--p010"] if args.p010 else [])))[0])
    frames = [eng.stage(f) for f in src[:1 + warm]]
    frames += pinned_frames(src[1 + warm:]) if args.stage else \
        [eng.stage(f) for f in src[1 + warm:]]

    def push(chunk):
        if group == 1:
            for f in chunk:
                eng.push(f)
        else:
            eng.push_many(chunk, group_size=group)

    push(frames[:1 + warm])
    torch.cuda.synchronize()
    before = dict(eng.group_stats)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if opening is not None:
            opening()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        todo = frames[1 + warm:]
        for i in range(0, len(todo), group):
            chunk = todo[i:i + group]
            push([eng.stage(f) for f in chunk] if args.stage else chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rows = sorted(((e.key, e.count, self_device_us(e))
                   for e in prof.key_averages() if self_device_us(e) > 0
                   and (opening is None or "spin" not in e.key)),
                  key=lambda r: -r[2])
    if not rows:
        raise SystemExit("profile_pair: the profiler recorded no device "
                         "activity")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return {"args": args, "engine": eng, "pairs": pairs, "wall": wall,
            "device_ms": sum(r[2] for r in rows) / 1e3, "rows": rows,
            "group": {k: eng.group_stats[k] - before[k] for k in before}}


def main(argv=None) -> int:
    r = profile(argv)
    args, eng, pairs, wall = r["args"], r["engine"], r["pairs"], r["wall"]
    device_ms, rows, group = r["device_ms"], r["rows"], max(args.group, 1)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"{WIDTH}x{HEIGHT} {'P010' if args.p010 else 'NV12'} -> "
          f"{DISPLAY_FPS:g} fps, radius {args.search_radius}, mode "
          f"{args.mode}, model {args.model}, warp_sampling "
          f"{args.warp_sampling}, subpel_flow {args.subpel_flow}, ladder "
          f"level {args.level}, levels ({args.black_level:g}, "
          f"{args.white_level:g}), group {group}, staged uploads in the "
          f"window {args.stage}: {pairs} pairs under the profiler")
    print(f"wall {wall * 1e3:.3f} ms = {wall / pairs * 1e3:.3f} ms/pair")
    print(f"device {device_ms:.3f} ms = {device_ms / pairs:.3f} ms/pair; "
          f"busy share {device_ms / (wall * 1e3):.3f}")
    if group > 1:
        d = r["group"]
        print(f"host launches/pair: graph replays {d['replays'] / pairs:.3f}"
              f" + copies {d['copies'] / pairs:.3f}; graphs "
              f"{eng.graph_stats()}")
    print("device ms/pair  launches/pair  kernel")
    for key, count, us in rows:
        print(f"{us / 1e3 / pairs:14.4f}  {count / pairs:13.2f}  {key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
