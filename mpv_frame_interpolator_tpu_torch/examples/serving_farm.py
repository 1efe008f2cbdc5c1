"""Serving-farm example: K independent streams interpolated on one card
(the port's counterpart of the JAX repository's
``examples/serving_farm.py``).

    python -m mpv_frame_interpolator_tpu_torch.examples.serving_farm [--device cuda|cpu]

Shows the MultiStreamEngine surface a transcode farm would use: each
stream keeps its own cadence, quality and scene state (one overloaded
stream degrades alone), while the kernels are built once per process.
Four gradient pans of 24 frames at 640x360, 24 -> 60 fps, auto-quality
on from radius 8.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List

from mpv_frame_interpolator_tpu_torch.convert import require_device
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.parallel.streams import (
    MultiStreamEngine)
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, OutputFrame)

N_STREAMS = 4
N_FRAMES = 24
W, H = 640, 360


def config(device: str = "cuda") -> EngineConfig:
    return EngineConfig(display_fps=60.0, auto_quality=True,
                        measure_timing=True, initial_search_radius=8,
                        device=str(require_device(device)))


def run(device: str = "cuda", n_streams: int = N_STREAMS,
        n_frames: int = N_FRAMES, width: int = W,
        height: int = H) -> Dict[int, List[OutputFrame]]:
    """Every stream's output frames, in order ({stream id: frames})."""
    srcs = [list(synthetic.gradient_pan(
        synthetic.SyntheticConfig(width=width, height=height, fps=24.0,
                                  seed=k), n_frames, vx=2 + k))
        for k in range(n_streams)]
    ms = MultiStreamEngine(config(device), n_streams=n_streams)
    outputs: Dict[int, List[OutputFrame]] = {k: [] for k in range(n_streams)}
    t0 = time.perf_counter()
    for step in range(n_frames):
        outs = ms.push_batch([srcs[k][step] for k in range(n_streams)])
        for sid, frames in outs.items():
            for out in frames:
                out.block()       # a real farm would hand planes to sinks
            outputs[sid].extend(frames)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in outputs.values())
    print(f"{n_streams} streams x {width}x{height} 24->60: "
          f"{total} output frames in {dt:.2f}s = {total / dt:.0f} total "
          f"out-fps")
    for sid, eng in enumerate(ms.engines):
        s = eng.stats.summary().get("source_frame_time", {})
        print(f"  stream {sid}: radius={eng.quality.search_radius} "
              f"state={eng.cadence.state.name} "
              f"mean={s.get('mean', 0.0) * 1e3:.2f}ms")
    return outputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
