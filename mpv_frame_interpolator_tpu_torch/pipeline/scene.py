"""Scene-change detection (counterpart of the JAX package's
``pipeline/scene.py``).

When the mean per-pixel luma difference between consecutive source frames,
measured at the flow's calc resolution, exceeds a threshold, the engine
folds a cut into the warp: the flow is zeroed and every blend position
snaps to the nearer source frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def cut_score(y1: torch.Tensor, y2: torch.Tensor, res_scalar: int,
              bit_shift: int = 0) -> torch.Tensor:
    """Mean |y1 - y2| >> bit_shift over the stride-2**res_scalar
    subsample of two (H, stride) luma planes (uint8 NV12, or uint16 P010
    with bit_shift 8, so the score stays on the 8-bit scale), as a 0-dim
    float32 tensor on their device (no host sync).

    Each difference is shifted before the sum, as the JAX package does;
    the sum is taken exactly in int64, rounded to float32 and multiplied
    by the float32 reciprocal of the element count: XLA compiles the JAX
    package's mean (a float32 sum divided by the count) into that
    multiply, which can differ from a true division in the last bit.  The
    JAX package sums in float32 in XLA's order, so the two agree exactly
    while the sum stays below 2**24 and within an ulp or so above it; the
    cut decision is the same wherever the score is not within an ulp of
    the threshold.  On the card the pair's prologue kernel computes the
    same bits (ops/cuda/prologue.py)."""
    s = 1 << res_scalar
    a = y1[::s, ::s].to(torch.int32)
    b = y2[::s, ::s].to(torch.int32)
    total = ((a - b).abs_() >> bit_shift).sum(dtype=torch.int64)
    # the reciprocal is a float32 value, so the product with a float32
    # tensor is one float32 multiply on any device
    recip = np.float32(1.0) / np.float32(a.numel())
    return total.to(torch.float32) * float(recip)



@dataclasses.dataclass
class SceneChangeDetector:
    """The runtime switch and threshold of scene-cut handling (the JAX
    package's ``SceneChangeDetector``): the engine reads both every pair
    and folds the cut in on the device; `last_score` is the last score
    read back to the host."""

    enabled: bool = True
    threshold: float = 28.0     # mean |Y1-Y2| per low-res pixel, 8-bit scale
    last_score: float = 0.0

    def is_cut(self, score_value: float) -> bool:
        """Record a score read back to the host; whether it is a cut (the
        batched multi-stream path feeds each stream's score here)."""
        self.last_score = float(score_value)
        return self.enabled and self.last_score > self.threshold
