"""Bidirectional warp + blend, blended mode only (counterpart of the JAX
package's ``ops/warp.py``).

The pieces of the reference's warpFrameKernel.cl for output mode 2 on
8-bit NV12, as plain tensor functions: the flow lookup at each output
pixel's low-res cell (``upsample_y`` / ``upsample_uv``), the reverse flow
read back through it (``reverse_fields``), the two mirrored nearest
samples (``mirror_edge2``, ``iround``), the 24-bit fixed-point blend
(``blend_fix``) and the default-levels clip (``levels_clip``).  Chroma is
sampled in the interleaved NV12 plane directly (``nv12_column``), so its
output comes out interleaved.  The kernel that runs all of it on the card
is ops/cuda/warp_pair.py; its plain version composes these functions.

Other output modes, non-default levels and P010 are not ported yet.
"""

from __future__ import annotations

import torch

BLENDED_FRAME = 2
BLEND_FRACTION_BITS = 24


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


def blend_weights(ts: torch.Tensor):
    """(w1, T) int64 per blend position: T = clip(round_half_even(t *
    2^24), 0, 2^24) and w1 = 2^24 - T (ops/oracle.blend_weights)."""
    one = 1 << BLEND_FRACTION_BITS
    T = torch.round(ts.to(torch.float32) * one).clamp(0, one).to(torch.int64)
    return one - T, T


def blend_fix(s12: torch.Tensor, s21: torch.Tensor, w1: torch.Tensor,
              T: torch.Tensor) -> torch.Tensor:
    """(s12 * w1 + s21 * T) >> 24, exact in int64 (it fits uint32)."""
    return (s12.to(torch.int64) * w1 + s21.to(torch.int64) * T) \
        >> BLEND_FRACTION_BITS


def levels_clip(b: torch.Tensor) -> torch.Tensor:
    """The level mapping at the default black 0 / white 255: a clip."""
    return b.clamp(0, 255)
