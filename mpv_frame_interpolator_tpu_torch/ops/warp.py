"""Bidirectional warp + blend, blended mode only (counterpart of the JAX
package's ``ops/warp.py``).

The pieces of the reference's warpFrameKernel.cl for output mode 2, as
plain tensor functions: the flow lookup at each output pixel's low-res
cell (``upsample_y`` / ``upsample_uv``), the reverse flow read back
through it (``reverse_fields``), the two mirrored nearest samples
(``mirror_edge2``, ``iround``), the fixed-point blend (``blend_weights``,
``blend_fix``) and the exact-integer black/white level maps
(``levels_y``, ``levels_uv``).  Chroma is sampled in the interleaved
NV12/P010 plane directly (``nv12_column``), so its output comes out
interleaved.

8-bit NV12 has scale_shift 0; 10-bit P010 (uint16 samples, value in the
top bits) has scale_shift 8: the blend keeps 16 fraction bits instead of
24 so the weighted sum fits uint32, levels are given on the 8-bit scale,
and the output cap is 255 << scale_shift.

The kernels that run all of it on the card are ops/cuda/warp_pair.py
(every blend position of a pair) and ops/cuda/warp_fused.py (one
position); their plain versions compose these functions.  Other output
modes are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

BLENDED_FRAME = 2


def mirror_edge2(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Reflect, then clamp into [1, dim - 2] (the warp's mirror)."""
    res = torch.where(pos >= dim - 1, pos - (pos - (dim - 2)) * 2, pos)
    res = torch.where(pos < 1, -pos + 1, res)
    return res.clamp(1, dim - 2)


def iround(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 rounding half away from zero (OpenCL round())."""
    return (torch.sign(x) * torch.floor(x.abs() + 0.5)).to(torch.int32)


def reverse_fields(blurred: torch.Tensor, rs: int):
    """Low-res forward flow (ox12, oy12) and the reverse flow
    (ox21, oy21) read at each cell minus the flow >> rs, clamped."""
    _, lh, lw = blurred.shape
    ox12, oy12 = blurred[0], blurred[1]
    ly = torch.arange(lh, device=blurred.device)[:, None]
    lx = torch.arange(lw, device=blurred.device)[None, :]
    bscy = (ly - (oy12 >> rs)).clamp(0, lh - 1)
    bscx = (lx - (ox12 >> rs)).clamp(0, lw - 1)
    return ox12, oy12, ox12[bscy, bscx], oy12[bscy, bscx]


def upsample_y(plane: torch.Tensor, rs: int, rows: int, width: int):
    """The luma grid's flow: value at (cy, cx) is plane[cy >> rs, cx >> rs]."""
    lh, lw = plane.shape
    iy = (torch.arange(rows, device=plane.device) >> rs).clamp(max=lh - 1)
    ix = (torch.arange(width, device=plane.device) >> rs).clamp(max=lw - 1)
    return plane[iy[:, None], ix[None, :]]


def upsample_uv(plane: torch.Tensor, rs: int, rows: int, width: int):
    """The interleaved chroma grid's flow: value at (cy, cx) is
    plane[(cy >> rs) << 1, (cx >> rs) & ~1]."""
    lh, lw = plane.shape
    iy = ((torch.arange(rows, device=plane.device) >> rs) << 1).clamp(
        max=lh - 1)
    ix = ((torch.arange(width, device=plane.device) >> rs) & ~1).clamp(
        max=lw - 1)
    return plane[iy[:, None], ix[None, :]]


def nv12_column(ncx: torch.Tensor, cx: torch.Tensor) -> torch.Tensor:
    """Column of the interleaved NV12 plane that output column cx samples
    at warped column ncx: (ncx & ~1) + (cx & 1), u on even, v on odd."""
    return (ncx & ~1) + (cx & 1)


def blend_fraction_bits(scale_shift: int) -> int:
    """24 fraction bits for 8-bit samples, 16 for 16-bit ones, so the
    weighted sum fits uint32 (ops/warp._blend_fix)."""
    return 24 - (8 if scale_shift else 0)


def blend_weights(ts: torch.Tensor, scale_shift: int = 0):
    """(w1, T) int64 per blend position: T = clip(round_half_even(t *
    2^frac), 0, 2^frac) in float32 and w1 = 2^frac - T."""
    one = 1 << blend_fraction_bits(scale_shift)
    T = torch.round(ts.to(torch.float32) * one).clamp(0, one).to(torch.int64)
    return one - T, T


def blend_fix(s12: torch.Tensor, s21: torch.Tensor, w1: torch.Tensor,
              T: torch.Tensor, scale_shift: int = 0) -> torch.Tensor:
    """(s12 * w1 + s21 * T) >> frac, exact in int64 (it fits uint32)."""
    return (s12.to(torch.int64) * w1 + s21.to(torch.int64) * T) \
        >> blend_fraction_bits(scale_shift)


def level_ints(black: float, white: float):
    """(k, w): the black and white levels rounded half to even in float32,
    as ``jnp.round`` rounds the JAX engine's float32 level scalars (so
    16.5 maps to 16 and 235.5 to 236)."""
    return (int(np.rint(np.float32(black))),
            int(np.rint(np.float32(white))))


def levels_y(b: torch.Tensor, k: int, w: int, scale_shift: int = 0):
    """Exact-integer luma level map (ops/warp._levels_y): floor(max((b -
    (k << ss)) * 255, 0) / max(w - k, 1)), capped at 255 << ss.  At the
    default levels (0, 255) it is the clip to the cap."""
    d = max(w - k, 1)
    n = ((b.to(torch.int64) - (k << scale_shift)) * 255).clamp(min=0)
    return torch.div(n, d, rounding_mode="floor").clamp(
        max=255 << scale_shift)


def levels_uv(b: torch.Tensor, w: int, scale_shift: int = 0):
    """Exact-integer chroma level map (ops/warp._levels_uv): with the
    chroma mid m = 128 << ss, floor(max((b - m) * 255 + m * w, 0) /
    max(w, 1)), capped at 255 << ss."""
    w = max(w, 1)
    m = 128 << scale_shift
    n = ((b.to(torch.int64) - m) * 255 + m * w).clamp(min=0)
    return torch.div(n, w, rounding_mode="floor").clamp(
        max=255 << scale_shift)
