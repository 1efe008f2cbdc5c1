"""Operations and bytes of the port's kernels, counted from the algorithm
at a cell's shapes, never from a kernel's instructions: a kernel written
again later meets the same yardstick.

Bytes count each input the function needs read once and each output
written once, whatever a kernel reads again.  Operations count the
arithmetic the algorithm defines on its values; address arithmetic
(mirroring, clamping, indexing) is not counted, and neither is work an
implementation may share (a displacement computed once a flow cell serves
every sample of the cell).  The least time of a kernel is the larger of
its operations over the chip's peak integer operations a second and its
bytes over its peak bytes a second (``peaks.json``).  Every operation
counted here is an integer one (sums of absolute differences, shifts,
fixed-point blends, level maps), so the peak is the card's INT32 rate,
not its FP32 rate.

Each count is the work of one source pair, whatever launches carry it: a
roofline share is the pair's least time times the pairs of the traced
stretch over the device time of the kernel's rows there.

* C1, the pair's prologue: the cut score over the luma samples of the
  score's grid, the fold of the positions and f2's probe for the flow.
* K1, the flow pyramid with its blur: every candidate of every layer of
  every step -- the SAD of three planes, the shifts, |offset| and, from
  iteration 4, the neighbour bias against four neighbours -- each summed
  once into its window, a comparison a window and layer for the first
  minimum, the commit a pixel and step; then the separable 8x8 box blur
  of both planes.
* the warp layer of a pair (K2 in one launch, or K4 once a position):
  both planes of every blended output of the pair's N positions -- the two
  sources read once, the field, each output sample's fixed-point blend and
  its level map, each output written once.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"

# operations, counted on the algorithm's values
SAD_OPS = 8                 # 3 differences, 3 absolute values, 2 additions
DELTA_SHIFT_OPS = 1         # << delta_scalar
LUMA_SHIFT_OPS = 1          # >> 8 for P010
OFFSET_BIAS_OPS = 2         # |offset| and its addition
WINDOW_SUM_OPS = 1          # the partial added into its window's sum
NEIGHBOR_OPS = 13           # 4 differences, 4 absolutes, 3 additions,
#                             the shift and the addition to the partial
ARGMIN_OPS = 1              # a comparison a window and layer
COMMIT_OPS = 1              # an addition a pixel and step
BLUR_OPS = 15               # separable 8x8 box: 7 + 7 additions, a division
BLEND_OPS = 4               # 2 multiplications, an addition, a shift
CAP_OPS = 1                 # the clip to the cap at the default levels
LEVEL_OPS = 5               # subtraction, multiplication, clip, division,
#                             cap at other levels
SCORE_OPS = 4               # difference, absolute value, shift, addition
FIRST_NEIGHBOR_ITERATION = 4


@dataclasses.dataclass(frozen=True)
class Work:
    ops: float
    nbytes: float


@dataclasses.dataclass(frozen=True)
class Peaks:
    int_ops_per_s: float
    bytes_per_s: float


def peaks_for(kind: str) -> Optional[Peaks]:
    """The published peaks of the card named `kind` (as
    ``torch.cuda.get_device_name`` gives it), or None for a card the
    table does not hold."""
    table = json.loads(PEAKS_FILE.read_text())
    for name, p in table.items():
        if name == kind:
            return Peaks(float(p["int_ops_per_s"]), float(p["bytes_per_s"]))
    return None


def least_s(work: Work, peaks: Peaks) -> float:
    return max(work.ops / peaks.int_ops_per_s,
               work.nbytes / peaks.bytes_per_s)


def bound_by(work: Work, peaks: Peaks) -> str:
    return ("bytes" if work.nbytes / peaks.bytes_per_s
            >= work.ops / peaks.int_ops_per_s else "operations")


def _plane_samples(height: int, stride: int):
    """(luma, interleaved chroma) samples of one frame."""
    return height * stride, (height // 2) * stride


def c1(height: int, stride: int, rs: int, lh: int, lw: int, item: int,
       n_positions: int) -> Work:
    """The prologue with scene detection and the probe."""
    sh, sw = -(-height // (1 << rs)), -(-stride // (1 << rs))
    # both luma planes on the score's grid (which holds the probe's luma
    # samples), f2's chroma at the probe's cells once each
    rows = len({(cy << rs) >> 1 for cy in range(lh)})
    cols = len({(cx << rs) & ~1 for cx in range(lw)})
    nbytes = (2 * sh * sw * item + 2 * rows * cols * item
              + 3 * lh * lw * item          # the probe written
              + 2 * 4 * n_positions         # positions read and written
              + 4 + 4 + 4)                  # score, flag, count
    ops = SCORE_OPS * sh * sw + 2 + n_positions
    return Work(float(ops), float(nbytes))


def k1(height: int, stride: int, lh: int, lw: int,
       windows: Sequence[int], radius: int, item: int,
       luma_shift: int) -> Work:
    """One flow pyramid at `radius` with its blur."""
    pixels = lh * lw
    per_candidate = (SAD_OPS + DELTA_SHIFT_OPS + OFFSET_BIAS_OPS
                     + WINDOW_SUM_OPS + (LUMA_SHIFT_OPS if luma_shift else 0))
    ops = 0
    candidates = 0
    for iteration, window in enumerate(windows):
        per = per_candidate + (NEIGHBOR_OPS if iteration
                               >= FIRST_NEIGHBOR_ITERATION else 0)
        n_windows = -(-lh // window) * -(-lw // window)
        for _ in range(2):          # the x step and the y step
            candidates += radius * pixels
            ops += (radius * pixels * per + radius * n_windows * ARGMIN_OPS
                    + pixels * COMMIT_OPS)
    ops += 2 * pixels * BLUR_OPS
    luma, chroma = _plane_samples(height, stride)
    # f1's samples the candidates reach, each at most once; f2's probe
    # (three low-res planes); the field written, before and after the blur
    nbytes = ((min(luma, candidates) + min(chroma, 2 * candidates)) * item
              + 3 * pixels * item + 2 * 2 * pixels * 4)
    return Work(float(ops), float(nbytes))


def warp(height: int, width: int, stride: int, lh: int, lw: int,
         item: int, n_positions: int, levels) -> Work:
    """Every blended output of one pair, both planes: the same count
    whether one launch does every position (K2) or one launch each (K4)."""
    luma, chroma = _plane_samples(height, stride)
    out_samples = n_positions * (height * width + (height // 2) * width)
    per_sample = BLEND_OPS + (CAP_OPS if tuple(levels) == (0, 255)
                              else LEVEL_OPS)
    nbytes = (2 * (luma + chroma) * item      # both sources once
              + 2 * lh * lw * 4               # the blurred field
              + 4 * n_positions               # the positions
              + out_samples * item)           # every output once
    return Work(float(out_samples * per_sample), float(nbytes))
