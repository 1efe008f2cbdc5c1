"""Operations and bytes of the bilinear families' kernels -- S1, the
sub-pel refinement inside K1's launch, and Q1, the 1/64-pel bilinear
blend -- counted from the algorithm at a cell's shapes, on the yardstick
of ``work.py`` (its ``Work``, ``Peaks``, constants and rules): each input
read once and each output written once, integer operations on the
algorithm's values, no address arithmetic (mirroring, clamping, indexing,
the tap positions) and no work an implementation may share (a
displacement, its weights and its back-projected cell, computed once a
flow cell, serve every sample of the cell).

* S1, a low-res pixel: nine probes, each the SAD of three planes (and
  the P010 shift) and its 8x8 window mean (a separable box sum and a
  shift); the integer quadratic fit of the nine means (finite
  differences, the determinant, two numerators, two quotients, the gates
  and the clips); the 1/64-pel field (offset << 6) + frac of both
  planes.  Inside K1's launch S1 reads nothing K1 does not read already
  and its field is the one K1's blur phase reads: K1 with S1's phases
  (``k1_subpel``) is K1's bytes and the sum of the operations.
* Q1, a pair: both planes of every output of the pair's positions -- the
  two sources read once, the 1/64-pel field once, the positions, every
  output written once; a sample's two bilinear samples (four taps a
  direction weighted by the fraction), the occlusion correction
  (hopperxq) and its level map.  The float32 blend of the two samples
  (and the float rounding of each for the correction) is left out of the
  operations: ``peaks.json`` holds the card's INT32 rate and no FP32
  rate, so leaving it out keeps the least time a lower bound and the
  share under the truth.
"""

from __future__ import annotations

from portbench import work

# S1, a low-res pixel
PROBES = 9
WINDOW_OPS = 15             # separable 8x8 box: 7 + 7 additions, the >> 6
FIT_OPS = 43                # 2 gradients (a subtraction each), 3 second
#                             differences (3 each), det16 (3 products and
#                             a subtraction), 2 numerators (4 each), the
#                             floor of det16 at 1, 2 quotients (a product,
#                             a division, a product each), the 4 gates
#                             and their 3 ands, 2 clips of 2, 2 choices
FIELD_OPS = 4               # (offset << 6) + frac, two planes

# Q1, an output sample
TAP_OPS = 9                 # a direction: 6 multiplications, 3 additions
OCCLUSION_OPS = 12          # difference, absolute value, - 32, * 4, the
#                             clip (2), the nearer sample's choice,
#                             256 - a, 2 multiplications, the addition,
#                             >> 8 (the P010 shift counted besides)


def s1(lh: int, lw: int, height: int, stride: int, item: int,
       luma_shift: int) -> work.Work:
    """S1 on its own: the refinement of one committed field."""
    pixels = lh * lw
    per_probe = (work.SAD_OPS + (work.LUMA_SHIFT_OPS if luma_shift else 0)
                 + WINDOW_OPS)
    ops = pixels * (PROBES * per_probe + FIT_OPS + FIELD_OPS)
    luma = height * stride
    chroma = (height // 2) * stride
    # the offset read, f1's samples the nine probes reach (each at most
    # once), f2's probe (three low-res planes), the field written
    nbytes = (2 * pixels * 4
              + (min(luma, PROBES * pixels)
                 + min(chroma, 2 * PROBES * pixels)) * item
              + 3 * pixels * item + 2 * pixels * 4)
    return work.Work(float(ops), float(nbytes))


def k1_subpel(height: int, stride: int, lh: int, lw: int, windows,
              radius: int, item: int, luma_shift: int) -> work.Work:
    """K1's launch under ``subpel_flow``: the flow pyramid, S1's phases
    and the blur of the 1/64-pel field.  The bytes are K1's (S1 reads the
    frames and the probe K1 reads, and its field is the one the blur
    reads); the operations are both."""
    k1 = work.k1(height, stride, lh, lw, windows, radius, item, luma_shift)
    return work.Work(k1.ops + s1(lh, lw, height, stride, item,
                                 luma_shift).ops, k1.nbytes)


def q1(height: int, width: int, stride: int, lh: int, lw: int, item: int,
       n_positions: int, levels, occlusion: bool,
       luma_shift: int) -> work.Work:
    """Every blended output of one pair, both planes, at 1/64 pel."""
    luma = height * stride
    chroma = (height // 2) * stride
    out_samples = n_positions * (height * width + (height // 2) * width)
    per_sample = (2 * TAP_OPS
                  + ((OCCLUSION_OPS + (work.LUMA_SHIFT_OPS if luma_shift
                                       else 0)) if occlusion else 0)
                  + (work.CAP_OPS if tuple(levels) == (0, 255)
                     else work.LEVEL_OPS))
    nbytes = (2 * (luma + chroma) * item      # both sources once
              + 2 * lh * lw * 4               # the 1/64-pel field
              + 4 * n_positions               # the positions
              + out_samples * item)           # every output once
    return work.Work(float(out_samples * per_sample), float(nbytes))
