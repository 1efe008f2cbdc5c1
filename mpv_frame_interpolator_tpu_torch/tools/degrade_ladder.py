"""What each degradation lever buys on the card (the port's counterpart of
the JAX repository's ``tools/degrade_ladder.py``).

    python -m mpv_frame_interpolator_tpu_torch.tools.degrade_ladder [WxH]

Times the engine's pair body (5 blend positions a pair) for each rung of
``LADDER`` -- a (search radius, K1 layers, pyramid depth, calc
resolution, model) state -- with ``utils/chiptime.chip_pair_seconds``
(CUDA graphs of 4 and 12 pair bodies, one replay each), and prints the
device ms a pair and the speedup over the first rung, after the card's
name and power limit.  The levers are the radius, the pyramid depth
(``num_iterations``) and the calc resolution (``max_calc_res``), and the
last rung's cheaper family, which the quality controller's ladder
(``EngineConfig.degrade_rungs``) steps through.  Default size 3840x2160.
Card only: the timing replays CUDA graphs, and without a card it raises.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

from mpv_frame_interpolator_tpu_torch.convert import require_device
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step
from mpv_frame_interpolator_tpu_torch.utils.chiptime import chip_pair_seconds

# (tag, radius, layers, num_iterations (0 = full depth), max_calc_res,
# model)
LADDER = [
    ("full r16",            16, 16, 0, 270, "hopper"),
    ("r5",                   5,  5, 0, 270, "hopper"),
    ("r5 depth-1",           5,  5, 7, 270, "hopper"),
    ("r5 depth-2",           5,  5, 6, 270, "hopper"),
    ("r5 depth-3",           5,  5, 5, 270, "hopper"),
    ("r5 res/2",             5,  5, 0, 135, "hopper"),
    ("r5 res/2 depth-2",     5,  5, 5, 135, "hopper"),
    # the shipped ladder's middle rung (EngineConfig.degrade_rungs
    # (3, 4)): depth-3 at quarter calc-res, still flow-bearing
    ("r5 res/4 depth-3",     5,  5, 5,  67, "hopper"),
    ("blend rung",           5,  5, 5,  67, "blend"),
]


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run(width: int = 3840, height: int = 2160) -> List[Dict]:
    """Each rung's seconds a pair on the card, printed as they come:
    [{"tag", "radius", "layers", "num_iterations", "max_calc_res",
    "model", "seconds", "flow_launches"}]; flow_launches counts K1's
    launches while the rung was timed (its graphs' captures and warm-up
    included)."""
    require_device("cuda")
    print(f"card: {card_line()}", flush=True)
    rows, base = [], None
    for tag, radius, layers, iters, mcr, model in LADDER:
        k1 = flow_step.counts.kernel
        sec = chip_pair_seconds(width, height, 5, radius, model=model, k1=4,
                                k2=12, repeats=1, layers=layers,
                                num_iterations=iters, max_calc_res=mcr)
        base = base or sec
        print(f"{tag:18s}: {sec*1e3:8.3f} ms/pair  "
              f"(speedup {base/sec:5.2f}x)", flush=True)
        rows.append({"tag": tag, "radius": radius, "layers": layers,
                     "num_iterations": iters, "max_calc_res": mcr,
                     "model": model, "seconds": sec,
                     "flow_launches": flow_step.counts.kernel - k1})
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    size = argv[0] if argv else "3840x2160"
    w, h = map(int, size.split("x"))
    run(w, h)
    return 0


if __name__ == "__main__":
    sys.exit(main())
