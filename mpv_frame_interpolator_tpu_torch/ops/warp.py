"""Bidirectional warp, blend and flow views (counterpart of the JAX
package's ``ops/warp.py``), output modes 0-4.

The pieces of the reference's warpFrameKernel.cl as plain tensor
functions: the flow lookup at each output pixel's low-res cell
(``upsample_y`` / ``upsample_uv``), the reverse flow read back through it
(``reverse_fields``), the mirrored nearest sample of one direction
(``mirror_edge2``, ``iround``, ``sample_coords``, ``sample_dir``), the
fixed-point blend (``blend_weights``, ``blend_fix``), the exact-integer
black/white level maps (``levels_y``, ``levels_uv``), the HSV flow view
(``visualize_flow``) and the grey flow view (``grey_planes``).  Chroma is
sampled in the interleaved NV12/P010 plane directly (``nv12_column``), so
its output comes out interleaved.

8-bit NV12 has scale_shift 0; 10-bit P010 (uint16 samples, value in the
top bits) has scale_shift 8: the blend keeps 16 fraction bits instead of
24 so the weighted sum fits uint32, levels are given on the 8-bit scale,
and the output cap is 255 << scale_shift.

The kernels that run the sampling on the card are ops/cuda/warp_pair.py
(every blended position of a pair), ops/cuda/warp_fused.py (one blended
position) and ops/cuda/warp_sample.py (the raw samples of one direction
at one position, which modes 0, 1, 3 and the "pallas" sampler of mode 2
compose); their plain versions compose these functions.  The side-by-side
modes 5 and 6 are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

WARPED_FRAME_12 = 0
WARPED_FRAME_21 = 1
BLENDED_FRAME = 2
HSV_FLOW = 3
GREY_FLOW = 4
SIDE_BY_SIDE_1 = 5
SIDE_BY_SIDE_2 = 6


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


def sample_coords(fx, fy, s, backward: bool, rows: int, wa: int,
                  chroma: bool):
    """(row, column) each output pixel of a plane samples at: p +
    iround(flow * s) (forward, direction 12) or p - iround(flow * s)
    (backward, direction 21), mirrored; chroma halves the vertical
    product and keeps the output column's u/v parity.  fx, fy are the
    float32 flow on the plane's grid, s a float32 scale; any leading
    batch dimensions broadcast."""
    dy = fy * s
    if chroma:
        dy = dy * 0.5
    cy = torch.arange(rows, device=fx.device)[:, None]
    cx = torch.arange(wa, device=fx.device)[None, :]
    ddx, ddy = iround(fx * s), iround(dy)
    if backward:
        ddx, ddy = -ddx, -ddy
    x = mirror_edge2(cx + ddx, wa)
    y = mirror_edge2(cy + ddy, rows)
    if chroma:
        x = nv12_column(x, cx)
    return y, x


def sample_dir(f1y, f1uv, f2y, f2uv, blurred, t, direction: int, rs: int,
               actual_width: int):
    """Raw nearest samples of one direction at blend position t: (y (H,
    Wa), uv (H/2, Wa) interleaved) of the planes' dtype.  Direction 12
    samples f1 at mirror_edge2(p + iround(flow12 * t)), direction 21
    samples f2 at mirror_edge2(p - iround(flow21 * (1 - t))); no blend,
    no levels, no cap (ops/warp._sample_all_planes of the JAX package,
    one direction)."""
    if direction not in (12, 21):
        raise ValueError(f"direction must be 12 or 21, got {direction}")
    ox12, oy12, ox21, oy21 = reverse_fields(blurred, rs)
    t = t.to(torch.float32).reshape(())
    if direction == 12:
        fx, fy, s, src_y, src_uv = ox12, oy12, t, f1y, f1uv
    else:
        fx, fy, s, src_y, src_uv = ox21, oy21, 1.0 - t, f2y, f2uv
    H, hc = src_y.shape[0], src_uv.shape[0]
    backward = direction == 21
    out = []
    for src, rows, up, chroma in ((src_y, H, upsample_y, False),
                                  (src_uv, hc, upsample_uv, True)):
        y, x = sample_coords(up(fx, rs, rows, actual_width).float(),
                             up(fy, rs, rows, actual_width).float(), s,
                             backward, rows, actual_width, chroma)
        # widened before indexing: CUDA does not index uint16
        out.append(src.to(torch.int32)[y, x].to(src.dtype))
    return out[0], out[1]


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
    default levels (0, 255) it is the clip to the cap, and takes that
    shortcut (ops/warp._levels_y_rt)."""
    if (k, w) == (0, 255):
        return b.to(torch.int64).clamp(0, 255 << scale_shift)
    d = max(w - k, 1)
    n = ((b.to(torch.int64) - (k << scale_shift)) * 255).clamp(min=0)
    return torch.div(n, d, rounding_mode="floor").clamp(
        max=255 << scale_shift)


def levels_uv(b: torch.Tensor, w: int, scale_shift: int = 0):
    """Exact-integer chroma level map (ops/warp._levels_uv): with the
    chroma mid m = 128 << ss, floor(max((b - m) * 255 + m * w, 0) /
    max(w, 1)), capped at 255 << ss; at w = 255 the clip to the cap
    (ops/warp._levels_uv_rt)."""
    if w == 255:
        return b.to(torch.int64).clamp(0, 255 << scale_shift)
    w = max(w, 1)
    m = 128 << scale_shift
    n = ((b.to(torch.int64) - m) * 255 + m * w).clamp(min=0)
    return torch.div(n, w, rounding_mode="floor").clamp(
        max=255 << scale_shift)


def visualize_flow(off_x, off_y, curr_8, channel, res_impact: int):
    """The reference's visualizeFlow (warpFrameKernel.cl:21-111), as the
    JAX package computes it in float32 (ops/warp._visualize_flow).

    off_x/off_y int32 flow (negated by the caller), curr_8 the blended
    sample on the 8-bit scale, channel 0 (Y), 1 (U) or 2 (V), an int or a
    tensor that broadcasts (interleaved chroma: 1 + (cx & 1)).  Returns
    int32 in [0, 255]."""
    zero_flow = (off_x.abs() < 1) & (off_y.abs() < 1)
    fx = off_x.to(torch.float32)
    fy = off_y.to(torch.float32)
    angle = torch.atan2(fy, fx) * np.float32(180.0 / np.pi)
    angle = torch.where(angle < 0, angle + 360.0, angle)
    angle = torch.where(angle >= 360.0, angle - 360.0, angle)
    hue = angle / np.float32(360.0)
    h_i = (hue * 6.0).to(torch.int32)
    f = hue * 6.0 - h_i.to(torch.float32)
    q = 1.0 - f
    f255 = torch.trunc(f * 255.0)
    q255 = torch.trunc(q * 255.0)
    sector = torch.remainder(h_i, 6)
    zeros = torch.zeros_like(f255)
    full = torch.full_like(f255, 255.0)

    def select(*vals):
        out = zeros
        for k, v in enumerate(vals):
            out = torch.where(sector == k, v, out)
        return out

    r = select(full, q255, zeros, zeros, f255, full)
    g = select(f255, full, full, q255, zeros, zeros)
    b = select(zeros, zeros, f255, full, full, q255)
    mag = (fx.abs() + fy.abs()) * np.float32(res_impact)
    r = torch.trunc((r / 255.0 * mag).clamp(0.0, 255.0))
    g = torch.trunc((g / 255.0 * fy.abs() * 2.0
                     * np.float32(res_impact)).clamp(0.0, 255.0))
    b = torch.trunc((b / 255.0 * mag).clamp(0.0, 255.0))
    r = torch.where(zero_flow, 0.0, r)
    g = torch.where(zero_flow, 0.0, g)
    b = torch.where(zero_flow, 0.0, b)
    y = (torch.trunc((r * 0.299 + g * 0.587 + b * 0.114).clamp(0.0, 255.0))
         .to(torch.int32) >> 1) + (curr_8.to(torch.int32) >> 1)
    u = torch.trunc((r * -0.168736 + g * -0.331264 + b * 0.5 + 128.0)
                    .clamp(0.0, 255.0)).to(torch.int32)
    v = torch.trunc((r * 0.5 + g * -0.418688 + b * -0.081312 + 128.0)
                    .clamp(0.0, 255.0)).to(torch.int32)
    channel = torch.as_tensor(channel, device=y.device)
    return torch.where(channel == 0, y, torch.where(channel == 1, u, v))


def hsv_planes(b_y, b_uv, blurred, rs: int, actual_width: int,
               scale_shift: int):
    """Mode 3 before the level maps: the blended planes (int, device
    scale) recoloured by the flow at each output pixel, luma channel 0
    and interleaved chroma channel 1 + (cx & 1), on the 8-bit scale and
    shifted back by scale_shift (ops/warp._warp_sample, HSV_FLOW); the
    magnitude gain is 4 at res scalars 0-2, else 1."""
    ri = 4 if rs <= 2 else 1
    out = []
    for b, up, chroma in ((b_y, upsample_y, False), (b_uv, upsample_uv, True)):
        rows = b.shape[-2]
        ox = up(blurred[0], rs, rows, actual_width)
        oy = up(blurred[1], rs, rows, actual_width)
        channel = 0
        if chroma:
            cx = torch.arange(actual_width, device=b.device)[None, :]
            channel = 1 + (cx & 1)
        out.append(visualize_flow(-ox, -oy, b >> scale_shift, channel, ri)
                   << scale_shift)
    return out[0], out[1]


def grey_planes(blurred, rs: int, rows: int, actual_width: int,
                scale_shift: int, dtype):
    """Mode 4, which samples nothing: luma min((|ox12| + |oy12|) << 2,
    255) << scale_shift on the luma grid, chroma the mid value 128 <<
    scale_shift; no level map (ops/warp._warp_sample, GREY_FLOW)."""
    ox = upsample_y(blurred[0], rs, rows, actual_width)
    oy = upsample_y(blurred[1], rs, rows, actual_width)
    grey = ((ox.abs() + oy.abs()) << 2).clamp(max=255) << scale_shift
    uv = torch.full((rows // 2, actual_width), 128 << scale_shift,
                    dtype=dtype, device=blurred.device)
    return grey.to(dtype), uv
