"""The control of the check: the plain reference put in the program's place,
in the nearest lower precision than the configuration states, on the
pairs a run of the cell samples, at the cell's own sizes.  The reference
is the one that judges the configuration (``reference.models``), and the
lower precision its ``outputs_lower`` -- for hopper's blend, bfloat16 in
place of the exact fixed-point blend of the float32 positions; a
reference without one has no control here, and the command says so and
stops.  The check (``check.compare_outputs``) has to find the control
wrong: its ``samples_differing`` is the upper reading that the limit (0)
sits below.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

prints one line of readings a seed and, last, a JSON object of them.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from portbench import spec


class _Output:
    """An output made in the program's place: its pts and its planes."""

    def __init__(self, pts, y, uv):
        self.pts, self._planes = pts, (y, uv)

    def device_planes(self):
        return self._planes


def first_window_frame(traffic: dict) -> int:
    """The stream index of the window's first frame (``driver.Driver``:
    the warm-up's first call takes the stream's first frame as well)."""
    per = int(traffic["frames_per_call"])
    many = traffic["api"] == "push_many"
    return 1 + (per if many else 0) + int(traffic["warm_calls"]) * per


def readings(cell_name: str, seed: int, device: str = "cuda",
             overrides: Optional[dict] = None) -> dict:
    from portbench import check, content, run
    from portbench.reference import models
    from portbench.reference import pair as ref

    _, cfg, traffic, ring_params, sample = spec.settings(cell_name,
                                                         overrides)
    _, cfg = run.engine_config(cfg, device)
    reference = models.for_config(cfg)
    if reference.lower is None:
        raise spec.SetupError(f"reference {reference.name!r} has no "
                              f"lower-precision variant: no control")
    scale_shift = 0 if cfg["pixfmt"] == "nv12" else 8
    geom = ref.geometry(cfg["height"], cfg["width"], cfg["width"],
                        cfg["max_calc_res"], cfg["num_iterations"])
    levels = ref.level_ints(cfg["black_level"], cfg["white_level"])
    ring = content.make_ring(cfg["width"], cfg["height"], cfg["pixfmt"],
                             content.RingParams(**ring_params), seed, device)
    first = first_window_frame(traffic)
    frames = check.sample_frames(seed, first, sample,
                                 int(ring_params["frames_per_shot"]))
    plan = check.plan_for(max(frames) + 1, cfg)
    n = len(ring)
    outputs = {}
    for f in frames:
        want = plan[f] or []
        f1, f2 = ring[(f - 1) % n], ring[f % n]
        folded = ref.prologue(f1, f2, geom, [b for _, b in want],
                              scale_shift, bool(cfg["scene_detection"]),
                              float(cfg["scene_threshold"]))
        made = reference.lower(f1, f2, geom, folded, cfg, scale_shift,
                               levels)
        outputs[f] = [_Output(pts, *planes)
                      for (pts, _), planes in zip(want, made)]
    cuts = check.transition_cuts(ring, geom, scale_shift,
                                 float(cfg["scene_threshold"]),
                                 bool(cfg["scene_detection"]))
    px = check.compare_outputs(ring, cfg, geom, plan, outputs, cuts,
                               scale_shift, levels)
    return {"seed": seed, "samples_differing": px.differing,
            "pairs": px.pairs, "wrong_pairs": px.wrong_pairs,
            "cut_pairs": px.cut_pairs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("portbench.control: CUDA is not available", file=sys.stderr)
            return 3
    out = []
    for seed in args.seeds:
        try:
            r = readings(args.workload, seed, args.device)
        except spec.SetupError as e:
            print(f"portbench.control: {e}", file=sys.stderr)
            return 2
        print(f"control {args.workload} seed {seed}: samples_differing "
              f"{r['samples_differing']} over {r['pairs']} pairs "
              f"({r['wrong_pairs']} wrong, {r['cut_pairs']} across a cut)",
              flush=True)
        out.append(r)
    print(json.dumps({"workload": args.workload, "control": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
