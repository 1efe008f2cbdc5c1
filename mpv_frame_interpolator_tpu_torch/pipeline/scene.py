"""Scene-change detection (counterpart of the JAX package's
``pipeline/scene.py``).

When the mean per-pixel luma difference between consecutive source frames,
measured at the flow's calc resolution, exceeds a threshold, the engine
folds a cut into the warp: the flow is zeroed and every blend position
snaps to the nearer source frame.
"""

from __future__ import annotations

import dataclasses

import torch


def cut_score(y1: torch.Tensor, y2: torch.Tensor, res_scalar: int,
              bit_shift: int = 0) -> torch.Tensor:
    """Mean |y1 - y2| >> bit_shift over the stride-2**res_scalar
    subsample of two (H, stride) luma planes (uint8 NV12, or uint16 P010
    with bit_shift 8, so the score stays on the 8-bit scale), as a 0-dim
    float32 tensor on their device (no host sync).

    Each difference is shifted before the sum, as the JAX package does;
    the sum is taken exactly in int64 and divided once in float32.  The
    JAX package reduces in float32 in XLA's order, so the two agree
    exactly while the sum stays below 2**24 and within an ulp or so
    above it; the cut decision is the same wherever the score is not
    within an ulp of the threshold."""
    s = 1 << res_scalar
    a = y1[::s, ::s].to(torch.int32)
    b = y2[::s, ::s].to(torch.int32)
    total = ((a - b).abs_() >> bit_shift).sum(dtype=torch.int64)
    return total.to(torch.float32) / a.numel()



@dataclasses.dataclass
class SceneChangeDetector:
    """The runtime switch and threshold of scene-cut handling (the JAX
    package's ``SceneChangeDetector``): the engine reads both every pair
    and folds the cut in on the device; `last_score` is the last score
    read back to the host."""

    enabled: bool = True
    threshold: float = 28.0     # mean |Y1-Y2| per low-res pixel, 8-bit scale
    last_score: float = 0.0
