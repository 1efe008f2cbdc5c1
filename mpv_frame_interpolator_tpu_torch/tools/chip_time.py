"""Per-pair device time of the engine's pair body at a frame size.

    python -m mpv_frame_interpolator_tpu_torch.tools.chip_time [WxH] [N] [radius]

Counterpart of the JAX package's ``tools/chip_time.py``: one CUDA graph of
k pair bodies replayed as a single launch, so that the host cannot pace
the card, and the difference of two such replays (k1 and k2 pairs) over
k2 - k1 (``utils/chiptime.chip_pair_seconds``).  Defaults: 3840x2160, 5
outputs a pair, radius 16, on the card (it raises without one).
"""

from __future__ import annotations

import sys

from mpv_frame_interpolator_tpu_torch.utils.chiptime import chip_pair_seconds


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    size = argv[0] if len(argv) > 0 else "3840x2160"
    n = int(argv[1]) if len(argv) > 1 else 5
    radius = int(argv[2]) if len(argv) > 2 else 16
    w, h = map(int, size.split("x"))
    sec = chip_pair_seconds(w, h, n, radius)
    print(f"{w}x{h} radius{radius} {n} outputs/pair: {sec*1e3:.3f} ms/pair "
          f"= {sec/n*1e6:.0f} us/output = {n/sec:.0f} out-fps device-bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
