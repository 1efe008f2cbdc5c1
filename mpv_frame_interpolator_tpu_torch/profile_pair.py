"""Device breakdown of the engine's source pairs on the card.

    python -m mpv_frame_interpolator_tpu_torch.profile_pair [--trace t.json]
    python -m mpv_frame_interpolator_tpu_torch.profile_pair --p010 \
        --warp-sampling fused --black-level 16 --white-level 235

Stages a synthetic ``moving_box`` clip at the main path's shape (4K,
24 -> 120 fps, radius 16; 8-bit NV12, or P010 with --p010) on the card, pushes WARM pairs through the
engine, then pushes PAIRS more under ``torch.profiler`` with one
synchronise at the end.  Prints the wall per pair, the card's own time
per pair (the sum of every kernel's and memset's device time as CUPTI
reports it), the share of the wall the card was busy, and the device
time and count per pair of each kernel.  The
profiler adds host cost per launch, so the wall here is longer than an
unprofiled run's; the device times are the card's alone.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from mpv_frame_interpolator_tpu_torch import cli
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)

WIDTH, HEIGHT, DISPLAY_FPS, RADIUS = 3840, 2160, 120.0, 16
WARM, PAIRS = 3, 10


def _self_device_us(evt) -> float:
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_pair", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--trace", default="",
                   help="write a Chrome trace of the profiled pairs here")
    p.add_argument("--p010", action="store_true", help="10-bit frames")
    p.add_argument("--warp-sampling", default="pair",
                   choices=("pair", "fused"))
    p.add_argument("--black-level", type=float, default=0.0)
    p.add_argument("--white-level", type=float, default=255.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pair: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile

    eng = InterpolationEngine(EngineConfig(
        display_fps=DISPLAY_FPS, auto_quality=False,
        initial_search_radius=RADIUS, warp_sampling=args.warp_sampling,
        black_level=args.black_level, white_level=args.white_level,
        device="cuda"))
    src = cli.make_source(cli.build_parser().parse_args(
        ["synthetic:moving_box", "--width", str(WIDTH), "--height",
         str(HEIGHT), "--fps", "24", "--frames", str(1 + WARM + PAIRS)]
        + (["--p010"] if args.p010 else [])))[0]
    staged = [eng.stage(f) for f in src]
    for f in staged[:1 + WARM]:
        eng.push(f)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in staged[1 + WARM:]:
            eng.push(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rows = sorted(((e.key, e.count, _self_device_us(e))
                   for e in prof.key_averages() if _self_device_us(e) > 0),
                  key=lambda r: -r[2])
    if not rows:
        raise SystemExit("profile_pair: the profiler recorded no device "
                         "activity")
    device_ms = sum(r[2] for r in rows) / 1e3
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"{WIDTH}x{HEIGHT} {'P010' if args.p010 else 'NV12'} -> "
          f"{DISPLAY_FPS:g} fps, radius {RADIUS}, warp_sampling "
          f"{args.warp_sampling}, levels ({args.black_level:g}, "
          f"{args.white_level:g}): {PAIRS} pairs under the profiler")
    print(f"wall {wall * 1e3:.3f} ms = {wall / PAIRS * 1e3:.3f} ms/pair")
    print(f"device {device_ms:.3f} ms = {device_ms / PAIRS:.3f} ms/pair; "
          f"busy share {device_ms / (wall * 1e3):.3f}")
    print("device ms/pair  launches/pair  kernel")
    for key, count, us in rows:
        print(f"{us / 1e3 / PAIRS:14.4f}  {count / PAIRS:13.2f}  {key[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
