"""Bidirectional warp, blend and flow views (counterpart of the JAX
package's ``ops/warp.py``), output modes 0-6 and every model family.

The pieces of the reference's warpFrameKernel.cl as plain tensor
functions: the flow lookup at each output pixel's low-res cell
(``upsample_y`` / ``upsample_uv``), the reverse flow read back through it
(``reverse_fields``), the mirrored nearest sample of one direction
(``mirror_edge2``, ``iround``, ``sample_coords``, ``sample_dir``), the
fixed-point blend (``blend_weights``, ``blend_fix``), the exact-integer
black/white level maps (``levels_y``, ``levels_uv``), the HSV flow view
(``visualize_flow``) and the grey flow view (``grey_planes``).  Chroma is
sampled in the interleaved NV12/P010 plane directly (``nv12_column``), so
its output comes out interleaved.  Beside them, the model families'
pieces: the occlusion correction of ``hopperx`` (``occlusion_adjust``),
the 1/64-pel bilinear sample and blend of ``hopperq`` / ``hopperxq``
(``bilinear_sample``, ``bilinear_blend``), and the side-by-side views of
modes 5 and 6 (``warp_sbs``).

8-bit NV12 has scale_shift 0; 10-bit P010 (uint16 samples, value in the
top bits) has scale_shift 8: the blend keeps 16 fraction bits instead of
24 so the weighted sum fits uint32, levels are given on the 8-bit scale,
and the output cap is 255 << scale_shift.

The kernels that run the sampling on the card are ops/cuda/warp_pair.py
(every blended position of a pair), ops/cuda/warp_fused.py (one blended
position), ops/cuda/warp_sample.py (the raw samples of one direction at
one position, which modes 0, 1, hopperx and the "pallas" sampler of mode
2 compose), ops/cuda/warp_bilinear.py (one bilinear blended position) and
ops/cuda/warp_views.py (the side-by-side views of modes 5/6 and the HSV
view of mode 3 at one position; the JAX package computes them with XLA
gathers and float ops, not a Pallas kernel); their plain versions compose
these functions.
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


def back_cells(blurred: torch.Tensor, rs: int):
    """(bscy, bscx): each low-res cell minus the flow >> rs, clamped to
    the field -- where the reverse flow is read."""
    _, lh, lw = blurred.shape
    ly = torch.arange(lh, device=blurred.device)[:, None]
    lx = torch.arange(lw, device=blurred.device)[None, :]
    return ((ly - (blurred[1] >> rs)).clamp(0, lh - 1),
            (lx - (blurred[0] >> rs)).clamp(0, lw - 1))


def reverse_fields(blurred: torch.Tensor, rs: int):
    """Low-res forward flow (ox12, oy12) and the reverse flow
    (ox21, oy21) read at each cell minus the flow >> rs, clamped."""
    ox12, oy12 = blurred[0], blurred[1]
    bscy, bscx = back_cells(blurred, rs)
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
    if isinstance(channel, int):
        # no host scalar copied to the device: the grouped path captures
        # this in a CUDA graph, which refuses a synchronous copy
        return (y, u, v)[channel]
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


def occlusion_adjust(blended: torch.Tensor, s12: torch.Tensor,
                     s21: torch.Tensor, t: torch.Tensor,
                     scale_shift: int = 0) -> torch.Tensor:
    """The occlusion correction of the hopperx families
    (ops/warp._occlusion_adjust), in exact integers: where the two
    directions' samples disagree by d8 = |s12 - s21| >> scale_shift, the
    blend moves toward the temporally nearer source (s12 where t < 0.5,
    else s21) by a = clip((d8 - 32) * 4, 0, 256) / 256:
    (blended * (256 - a) + near * a) >> 8.  int64 out."""
    s12 = s12.to(torch.int64)
    s21 = s21.to(torch.int64)
    near = torch.where(t.reshape(()) < 0.5, s12, s21)
    a = ((((s12 - s21).abs() >> scale_shift) - 32) * 4).clamp(0, 256)
    return (blended.to(torch.int64) * (256 - a) + near * a) >> 8


def bilinear_sample(plane: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                    dim_y: int, dim_x: int) -> torch.Tensor:
    """The hopperq families' sub-pixel sample (ops/warp._bilinear_sample):
    py/px int32 positions in 1/64 pel, taps at (p >> 6) and (p >> 6) + 1
    (an arithmetic shift: it floors negatives), each mirrored with
    mirror_edge2 over dim_y x dim_x, weighted by the fraction p & 63.
    Returns the sample in 1/4096 units, int32."""
    y0, x0 = py >> 6, px >> 6
    fy, fx = py & 63, px & 63
    y0m, y1m = mirror_edge2(y0, dim_y), mirror_edge2(y0 + 1, dim_y)
    x0m, x1m = mirror_edge2(x0, dim_x), mirror_edge2(x0 + 1, dim_x)
    src = plane.to(torch.int32)     # CUDA does not index uint16
    top = src[y0m, x0m] * (64 - fx) + src[y0m, x1m] * fx
    bot = src[y1m, x0m] * (64 - fx) + src[y1m, x1m] * fx
    return top * (64 - fy) + bot * fy


_INV4096 = np.float32(1.0 / 4096.0)


def _bilinear_mix(q12: torch.Tensor, q21: torch.Tensor, t: torch.Tensor,
                  scale_shift: int, occlusion: bool) -> torch.Tensor:
    """The float32 blend of two 1/4096-unit samples in the JAX order,
    floor((q12 * (1 - t) + q21 * t) / 4096 + 0.5), and for hopperxq the
    occlusion correction on the two samples rounded the same way."""
    a, b = q12.to(torch.float32), q21.to(torch.float32)
    val = (a * (1.0 - t) + b * t) * _INV4096
    blended = torch.floor(val + 0.5).to(torch.int64)
    if occlusion:
        blended = occlusion_adjust(
            blended, torch.floor(a * _INV4096 + 0.5),
            torch.floor(b * _INV4096 + 0.5), t, scale_shift)
    return blended


def bilinear_blend(f1y, f1uv, f2y, f2uv, blurred, t, rs: int,
                   actual_width: int, scale_shift: int = 0,
                   levels=(0, 255), occlusion: bool = False,
                   subpel: bool = False):
    """One blended position of the hopperq (occlusion=False) or hopperxq
    (occlusion=True) family: (y (H, Wa), uv (H/2, Wa) interleaved) of the
    planes' dtype (ops/warp._warp_sample, bilinear=True).

    Luma samples f1 at (p << 6) + iround(flow12 * (t * 64)) and f2 at
    (p << 6) - iround(flow21 * ((1 - t) * 64)), in 1/64 pel.  Chroma is
    sampled in the planar half-width domain: column (cx >> 1) << 6 plus
    iround(flow * (t * 32)), rows likewise, mirrored over (H/2, Wa/2), u
    from the u samples and v from the v samples of the interleaved plane,
    each output column with the flow of its own interleaved column.  Then
    _bilinear_mix and the level maps.  t is a one-element float32
    tensor.

    With `subpel`, `blurred` is the sub-pel flow's (2, lh, lw) int32
    field b in 1/64 pel (the subpel_flow option; the JAX branch with its
    FX fields, which takes the engine's split flow = b >> 6, frac = b -
    (flow << 6) as (flow << 6) + frac, b itself): the reverse value is read
    at the cell back-projected by b >> 6, and the positions are p << 6
    plus iround(b * t) (chroma: * (t * 0.5)); at b = flow << 6 they are
    the positions above."""
    k, w = levels
    if subpel:
        bscy, bscx = back_cells(blurred >> 6, rs)
        fields = (blurred[0], blurred[1], blurred[0][bscy, bscx],
                  blurred[1][bscy, bscx])
    else:
        fields = reverse_fields(blurred, rs)
    units = (1.0, 0.5) if subpel else (64.0, 32.0)
    t = t.to(torch.float32).reshape(())
    fs21 = 1.0 - t
    H, dev, dtype = f1y.shape[0], f1y.device, f1y.dtype
    hc, wc = H // 2, actual_width >> 1

    def positions(up, rows, base_y, base_x, unit):
        s12, s21 = t * unit, fs21 * unit
        grid = [up(f, rs, rows, actual_width).to(torch.float32)
                for f in fields]
        return ((base_y + iround(grid[1] * s12), base_x + iround(grid[0] * s12)),
                (base_y - iround(grid[3] * s21), base_x - iround(grid[2] * s21)))

    cy = torch.arange(H, device=dev, dtype=torch.int32)[:, None]
    cx = torch.arange(actual_width, device=dev, dtype=torch.int32)[None, :]
    p12, p21 = positions(upsample_y, H, cy << 6, cx << 6, units[0])
    b_y = _bilinear_mix(bilinear_sample(f1y, *p12, H, actual_width),
                        bilinear_sample(f2y, *p21, H, actual_width), t,
                        scale_shift, occlusion)

    cy = torch.arange(hc, device=dev, dtype=torch.int32)[:, None]
    p12, p21 = positions(upsample_uv, hc, cy << 6, (cx >> 1) << 6,
                         units[1])
    planes = []
    for par in (0, 1):      # u on the even columns, v on the odd
        def at(p):
            return p[0][:, par::2], p[1][:, par::2]
        planes.append(_bilinear_mix(
            bilinear_sample(f1uv[:, par::2], *at(p12), hc, wc),
            bilinear_sample(f2uv[:, par::2], *at(p21), hc, wc), t,
            scale_shift, occlusion))
    b_uv = torch.stack(planes, dim=-1).reshape(hc, 2 * wc)
    return (levels_y(b_y, k, w, scale_shift).to(dtype),
            levels_uv(b_uv, w, scale_shift).to(dtype))


def warp_sbs(mode: int, f1y, f1uv, f2y, f2uv, blurred, t, rs: int,
             actual_width: int, scale_shift: int = 0, levels=(0, 255)):
    """The side-by-side views (warpFrameKernel.cl:131-148;
    ops/warp._warp_sbs) at one blend position: (y (H, Wa), uv (H/2, Wa)
    interleaved) of the planes' dtype.

    Mode 5 (SBS1) copies f1 verbatim into the left half (columns below
    Wa >> 1) and warps the rest.  Mode 6 (SBS2) puts the source at half
    size into a band of rows on the left and the warp of the picture at
    doubled coordinates on the right, splitting at the STRIDE W >> 1 (not
    at Wa); outside the band, luma is 0 and chroma 128 << scale_shift.
    The warp is the nearest blend of the blended mode at each pixel's
    adjusted coordinate, whose flow is looked up with clipping and whose
    reverse flow is read back per pixel; then the level maps."""
    k, w = levels
    H, W = f1y.shape
    _, lh, lw = blurred.shape
    t = t.to(torch.float32).reshape(())
    fs21 = 1.0 - t
    w1, T = blend_weights(t, scale_shift)
    dev, dtype, wa = f1y.device, f1y.dtype, actual_width
    outs = []
    for cz, p1, p2 in ((0, f1y, f2y), (1, f1uv, f2uv)):
        rows = H >> cz
        src1, src2 = p1.to(torch.int32), p2.to(torch.int32)
        # int32 coordinates, as the JAX package computes them: half the
        # bytes of PyTorch's default int64 in every pass below
        cy = torch.arange(rows, device=dev, dtype=torch.int32)[:, None]
        cx = torch.arange(wa, device=dev, dtype=torch.int32)[None, :]
        cy, cx = cy.expand(rows, wa), cx.expand(rows, wa)

        def fetch(src, ry, rx):
            # chroma: u on even output columns, v on odd
            return src[ry, nv12_column(rx, cx) if cz else rx]

        if mode == SIDE_BY_SIDE_1:
            forced = cx < (wa >> 1)
            forced_val = fetch(src1, cy, cx)
            adj_cy, adj_cx = cy, cx
        elif mode == SIDE_BY_SIDE_2:
            top = (H >> 2) >> cz
            in_rows = (cy >= top) & (cy < top + (H >> (1 + cz)))
            in_left = in_rows & (cx < (W >> 1))
            in_right = in_rows & (cx >= (W >> 1)) & (cx < W)
            ly = ((cy - top) * 2).clamp(0, rows - 1)
            lx = (cx * 2 + ((cx & 1) if cz else 0)).clamp(0, W - 1)
            forced = ~in_right
            # the lanes outside the band's left part are discarded; under
            # an odd stride chroma's column of one of them would be W
            forced_val = torch.where(
                in_left, src1[ly, (nv12_column(lx, cx) if cz else lx)
                              .clamp(max=W - 1)],
                torch.full_like(cx, (128 << scale_shift) if cz else 0))
            adj_cx = torch.where(in_right, (cx - (wa >> 1)) * 2, cx)
            adj_cy = torch.where(in_right, (cy - top) * 2, cy)
        else:
            raise ValueError(f"mode {mode} is not a side-by-side mode")

        if cz:
            scx = ((adj_cx >> rs) & ~1).clamp(0, lw - 1)
            scy = ((adj_cy >> rs) << 1).clamp(0, lh - 1)
        else:
            scx = (adj_cx >> rs).clamp(0, lw - 1)
            scy = (adj_cy >> rs).clamp(0, lh - 1)
        ox12, oy12 = blurred[0][scy, scx], blurred[1][scy, scx]
        bscy = (scy - (oy12 >> rs)).clamp(0, lh - 1)
        bscx = (scx - (ox12 >> rs)).clamp(0, lw - 1)
        ox21, oy21 = blurred[0][bscy, bscx], blurred[1][bscy, bscx]
        dy12, dy21 = oy12.to(torch.float32) * t, oy21.to(torch.float32) * fs21
        if cz:
            dy12, dy21 = dy12 * 0.5, dy21 * 0.5
        s12 = fetch(src1,
                    mirror_edge2(adj_cy + iround(dy12), rows),
                    mirror_edge2(adj_cx + iround(ox12.to(torch.float32) * t),
                                 wa))
        s21 = fetch(src2,
                    mirror_edge2(adj_cy - iround(dy21), rows),
                    mirror_edge2(adj_cx - iround(ox21.to(torch.float32)
                                                 * fs21), wa))
        b = blend_fix(s12, s21, w1, T, scale_shift)
        val = levels_uv(b, w, scale_shift) if cz else \
            levels_y(b, k, w, scale_shift)
        outs.append(torch.where(forced, forced_val.to(torch.int64), val)
                    .to(dtype))
    return outs[0], outs[1]
