"""The sharded step and the pair pool across every visible card.

    python -m mpv_frame_interpolator_tpu_torch.tools.multi_card

On a host with several cards: the sharded step of one 4K pair
(``moving_box``, radius 16, blended) on NCCL at world sizes 1, 2, 4, ...
up to the card count, a rank a card, each rank holding its offset and
outputs against the single-device path, with ms a pair; the dry run on
every card; and the pair pool over every card against one engine (4K
24 -> 120, radius 16: 8 frames warm each path, 12 are timed), every
output equal, with out-fps.  Prints the cards' name and power limit
first; exits non-zero on a mismatch, and without a card.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016


def _timed(run, warm, timed):
    """run(warm), then run(timed) on the wall clock up to its last output
    finished: (every output, the timed outputs, seconds)."""
    outs = run(warm)
    for o in outs:
        o.block()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    more = run(timed)
    for o in more:
        o.block()
    return outs + more, len(more), time.perf_counter() - t0


def main() -> int:
    from mpv_frame_interpolator_tpu_torch.io import synthetic
    from mpv_frame_interpolator_tpu_torch.parallel import dryrun
    from mpv_frame_interpolator_tpu_torch.parallel.batch import (
        PairParallelPool)
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    if not torch.cuda.is_available():
        raise SystemExit("multi_card: CUDA is not available")
    cards = torch.cuda.device_count()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = synthetic.SyntheticConfig(width=3840, height=2160, seed=SEED)
    f1, f2 = list(synthetic.moving_box(src, 2))
    planes = (f1.y, f1.uv[:, 0::2], f1.uv[:, 1::2],
              f2.y, f2.uv[:, 0::2], f2.uv[:, 1::2])
    world = 1
    while world <= cards:
        t0 = time.perf_counter()
        res = dryrun.run_sharded(world, planes, 16, (2,), 0.4, "cuda",
                                 "nccl", reps=10, arrays=False)
        print(f"sharded step 4K, nccl, {world} card(s): equal "
              f"{res['equal']}; ms a pair by rank "
              f"{[round(m, 3) for m in res['ms_by_rank']]}; every rank "
              f"started, joined and done at "
              f"{[round(x, 1) for x in res['seconds']]} s "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not res["equal"]:
            return 1
        world *= 2
    dryrun.dryrun_multichip(cards, device="cuda", backend="nccl")
    config = EngineConfig(display_fps=120.0, auto_quality=False,
                          measure_timing=False, initial_search_radius=16)
    frames = list(synthetic.moving_box(src, 20))
    warm, timed = range(8), range(8, 20)
    engine = InterpolationEngine(config)
    one, n1, s1 = _timed(
        lambda steps: [o for i in steps for o in engine.push(frames[i])],
        warm, timed)
    pool = PairParallelPool(config)
    pooled, n2, s2 = _timed(
        lambda steps: list(pool.run(frames[i] for i in steps)), warm, timed)
    same = len(one) == len(pooled) and all(
        a.pts == b.pts and all(np.array_equal(p, q) for p, q in zip(
            (a.to_video_frame().y, a.to_video_frame().uv),
            (b.to_video_frame().y, b.to_video_frame().uv)))
        for a, b in zip(one, pooled))
    print(f"pair pool over {len(pool.devices)} card(s), pairs a slot "
          f"{pool.pairs_per_slot()}: equal {same}; {n2 / s2:.1f} out-fps "
          f"against {n1 / s1:.1f} for one engine", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
