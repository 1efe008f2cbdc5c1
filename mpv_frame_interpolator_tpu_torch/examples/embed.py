"""Minimal embedding example: interpolate a synthetic clip through the
Player API, watch properties change, and write the result to y4m (the
port's counterpart of the JAX repository's ``examples/embed.py``).

    python -m mpv_frame_interpolator_tpu_torch.examples.embed [OUT.y4m] [--device cuda|cpu]

A 640x360 moving box, 24 frames at 24 fps, model hopperq at search radius
8, out at 60 fps.  OUT defaults to ``embed_out.y4m`` in the temporary
directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from mpv_frame_interpolator_tpu_torch.api import Player
from mpv_frame_interpolator_tpu_torch.convert import require_device
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MWriter
from mpv_frame_interpolator_tpu_torch.pipeline.engine import EngineConfig


def config(device: str = "cuda") -> EngineConfig:
    # auto_quality off for the demo: on a slow host the controller would
    # (correctly) declare TooSlow and pass frames through
    return EngineConfig(display_fps=60.0, model="hopperq",
                        auto_quality=False, initial_search_radius=8,
                        measure_timing=False,
                        device=str(require_device(device)))


def run(out_path: str = None, device: str = "cuda", width: int = 640,
        height: int = 360, frames: int = 24) -> int:
    """Writes the interpolated clip to `out_path`; returns the number of
    frames written."""
    out_path = out_path or os.path.join(tempfile.gettempdir(),
                                        "embed_out.y4m")
    player = Player(config(device))
    player.observe_property("interpolation-state",
                            lambda k, v: print(f"  [{k}] -> {v}"))
    player.observe_property("search-radius",
                            lambda k, v: print(f"  [{k}] -> {v}"))
    cfg = synthetic.SyntheticConfig(width=width, height=height, fps=24.0)
    source = synthetic.moving_box(cfg, frames, vx=4, vy=1)
    with open(out_path, "wb") as fh:
        writer = Y4MWriter(fh, width, height, 60.0)
        n = 0
        for out in player.feed_all(source):
            writer.write(out.to_video_frame())
            n += 1
    print(f"wrote {n} frames at 60fps to {out_path}")
    print("final stats:", {k: round(v["mean"] * 1e3, 2)
                           for k, v in player.get_property("stats").items()
                           if k == "source_frame_time"})
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
