"""The plain reference of the bilinear families (hopperq, hopperxq) in
mode 2, with or without the measured sub-pel flow.

Plain PyTorch in int64 (float32 where the interpolator states a float
blend), on the device of the planes, written from the stated semantics of
the interpolator's quality tier: the 1/64-pel bilinear warp, the float32
blend, the occlusion correction and the sub-pel refinement of the flow.
It imports nothing of the program under test (nor of the JAX package);
the cut, the fold, the flow pyramid, the 8x8 box blur, the mirrors and
the level maps are ``pair.py``'s, shared with hopper's reference.

The semantics, stage by stage:

* the flow: ``pair.flow``'s committed field (the unblurred offset), zero
  under a cut.
* the sub-pel refinement (``subpel_flow``; the interpolator's
  ``subpel_refine``): at each low-res pixel nine SADs of luma, u and v
  between f1 at the pixel's scaled position plus the offset plus a probe
  (dx, dy) in {-1, 0, 1}^2, mirrored into the frame, and f2's probe at the
  pixel; each >> scale_shift, averaged over the blur's 8x8 window (sum >>
  6); then the finite differences gx2 = d(1,0) - d(-1,0), gy2, hxx =
  d(1,0) + d(-1,0) - 2 d0, hyy, hxy4 = d(1,1) + d(-1,-1) - d(-1,1) -
  d(1,-1), det16 = 16 hxx hyy - hxy4^2, numx = 4 hyy gx2 - hxy4 gy2, numy
  = 4 hxx gy2 - hxy4 gx2, frac = -2 trunc(64 num / max(det16, 1)) clipped
  to [-32, 32] where d0 > 0, hxx > 0, hyy > 0 and det16 > 0, else 0: the
  1/64-pel fraction.  The field blurred is (offset << 6) + frac (the box
  blur, truncating division), zero under a cut; its floor b >> 6 is the
  integer flow and b - (floor << 6) in [0, 63] the remainder.  Without
  ``subpel_flow`` the blurred offset is the integer flow and the
  remainder is zero.
* the positions, in 1/64 pel (luma): p << 6 plus iround(float32((flow12
  << 6) + frac12) * t) toward f1, minus iround(float32((flow21 << 6) +
  frac21) * (1 - t)) toward f2, flow12 and frac12 at p's low-res cell
  and flow21 and frac21 at the cell back-projected by flow12 >> rs, as
  hopper's warp reads them; iround rounds a float32 half away from zero
  (each product, sum and floor rounded once in float32).  Without
  ``subpel_flow``, iround(float32(flow) * (t * 64)).  Chroma: the planar
  half-width domain, column (cx >> 1) << 6 and row cy << 6, the flow at
  the interleaved column's cell, the scale halved (t * 0.5; t * 32
  without the sub-pel flow), u from the even and v from the odd columns.
* the sample: taps at p >> 6 and (p >> 6) + 1 (flooring), each mirrored
  with hopper's mirror_edge2 over the plane, weighted in integers by p &
  63: q = (s00 (64 - fx) + s01 fx) (64 - fy) + (s10 (64 - fx) + s11 fx)
  fy, in 1/4096 units.
* the blend, float32: b = floor((float(q12) * (1 - t) + float(q21) * t) *
  (1 / 4096) + 0.5), each conversion, product and sum rounded once (no
  fused multiply-add).
* hopperxq: s12 = floor(float(q12) * (1 / 4096) + 0.5), s21 likewise;
  near = s12 where t < 0.5, else s21; d = |s12 - s21| >> scale_shift; a =
  clip((d - 32) * 4, 0, 256); b = (b (256 - a) + near a) >> 8.
* the level maps of hopper's reference.

Departures from the order the interpolator's JAX package writes: none in
the arithmetic.  The JAX package upsamples each low-res field to the
output grid first and reads it there; this module reads each output
sample's low-res cell directly (the same values).  It forms the 1/64-pel
field of the sub-pel flow as (floor << 6) + remainder after the floor
split, as the JAX package does; that is the blurred field itself.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import pair as ref

I64 = torch.int64
F32 = torch.float32
# (dx, dy) of the nine probes, in the interpolator's order
PROBES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
          (-1, -1), (1, 1), (-1, 1), (1, -1))
INV4096 = np.float32(1.0 / 4096.0)

# what this reference judges: mode 2 of both bilinear families, with and
# without the sub-pel flow (the same code, a zero remainder without it);
# any sampler, which these families do not read
COVERS = {"model": ("hopperq", "hopperxq"), "frame_output_mode": (2,),
          "subpel_flow": (True, False)}


# -- the sub-pel refinement ---------------------------------------------------

def _box(p: torch.Tensor) -> torch.Tensor:
    """The 8x8 box sum of one (lh, lw) plane: taps [-4, 3], edges mirrored
    symmetrically."""
    lh, lw = p.shape
    r, dev = ref.BLUR_RADIUS, p.device

    def taps(n):
        i = torch.arange(-r, n + r, device=dev)
        i = torch.where(i < 0, -i - 1, i)
        return torch.where(i >= n, 2 * n - i - 1, i)

    padded = p[taps(lh)][:, taps(lw)]
    acc = torch.zeros_like(p)
    for ky in range(2 * r):
        for kx in range(2 * r):
            acc += padded[ky:ky + lh, kx:kx + lw]
    return acc


def subpel_frac(offset: torch.Tensor, f1, f2, geom: ref.Geometry,
                scale_shift: int) -> torch.Tensor:
    """The (2, lh, lw) int64 fraction in 1/64 pel of the committed field
    `offset` (unblurred), from the nine windowed SAD probes and the
    integer quadratic fit."""
    dev = offset.device
    H, W = f1[0].shape
    rs, lh, lw = geom.rs, geom.lh, geom.lw
    y1, uv1 = f1[0].to(I64), f1[1].to(I64)
    cy = (torch.arange(lh, device=dev, dtype=I64) << rs)[:, None]
    cx = (torch.arange(lw, device=dev, dtype=I64) << rs)[None, :]
    y2 = f2[0].to(I64)[cy, cx]
    u2 = f2[1].to(I64)[cy >> 1, cx & ~1]
    v2 = f2[1].to(I64)[cy >> 1, (cx & ~1) + 1]
    ox, oy = offset[0], offset[1]
    costs = []
    for dx, dy in PROBES:
        nx = ref._mirror_inside(cx + ox + dx, W)
        ny = ref._mirror_inside(cy + oy + dy, H)
        nc = nx & ~1
        sad = ((y1[ny, nx] - y2).abs() + (uv1[ny >> 1, nc] - u2).abs()
               + (uv1[ny >> 1, nc + 1] - v2).abs())
        costs.append(_box(sad >> scale_shift) >> 6)
    d0, dxm, dxp, dym, dyp, dmm, dpp, dmp, dpm = costs
    gx2, gy2 = dxp - dxm, dyp - dym
    hxx, hyy = dxp + dxm - 2 * d0, dyp + dym - 2 * d0
    hxy4 = dpp + dmm - dmp - dpm
    det16 = 16 * hxx * hyy - hxy4 * hxy4
    numx = hyy * gx2 * 4 - hxy4 * gy2
    numy = hxx * gy2 * 4 - hxy4 * gx2
    den = det16.clamp(min=1)
    fx = -2 * torch.div(numx * 64, den, rounding_mode="trunc")
    fy = -2 * torch.div(numy * 64, den, rounding_mode="trunc")
    valid = (d0 > 0) & (hxx > 0) & (hyy > 0) & (det16 > 0)
    zero = torch.zeros_like(fx)
    return torch.stack([torch.where(valid, fx.clamp(-32, 32), zero),
                        torch.where(valid, fy.clamp(-32, 32), zero)])


def fields(f1, f2, folded: ref.Folded, geom: ref.Geometry, cfg: dict,
           scale_shift: int):
    """(flow, remainder): the pair's integer flow and its 1/64-pel
    remainder, (2, lh, lw) int64 each; zero under a cut."""
    dev = f1[0].device
    zero = torch.zeros((2, geom.lh, geom.lw), dtype=I64, device=dev)
    if folded.cut:
        return zero, zero
    offset = ref.flow(f1[0], f1[1], f2[0], f2[1], geom,
                      int(cfg["initial_search_radius"]),
                      int(cfg["delta_scalar"]),
                      int(cfg["neighbor_bias_scalar"]), scale_shift)
    if not cfg["subpel_flow"]:
        return ref.blur(offset), zero
    b64 = ref.blur((offset << 6) + subpel_frac(offset, f1, f2, geom,
                                               scale_shift))
    flow = b64 >> 6
    return flow, b64 - (flow << 6)


# -- the warp -----------------------------------------------------------------

def _sample(plane: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
            rows: int, cols: int) -> torch.Tensor:
    """The bilinear sample at (py, px) in 1/64 pel, 1/4096 units."""
    y0, x0 = py >> 6, px >> 6
    fy, fx = py & 63, px & 63
    y0m, y1m = ref._mirror_edge2(y0, rows), ref._mirror_edge2(y0 + 1, rows)
    x0m, x1m = ref._mirror_edge2(x0, cols), ref._mirror_edge2(x0 + 1, cols)
    top = plane[y0m, x0m] * (64 - fx) + plane[y0m, x1m] * fx
    bot = plane[y1m, x0m] * (64 - fx) + plane[y1m, x1m] * fx
    return top * (64 - fy) + bot * fy


def _blend(q12, q21, t12, t21, scale_shift: int, occlusion: bool,
           precision: str) -> torch.Tensor:
    """The blend of the two directions' samples (1/4096 units) and, for
    hopperxq, the occlusion correction: int64."""
    k = torch.tensor(INV4096, device=q12.device)
    if precision == "float32":
        a, b = q12.to(F32), q21.to(F32)
        val = (a * t21 + b * t12) * k
    elif precision == "bfloat16":
        bf = torch.bfloat16
        a, b = q12.to(bf), q21.to(bf)
        val = (a * t21.to(bf) + b * t12.to(bf)) * k.to(bf)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    blended = torch.floor(val + 0.5).to(I64)
    if not occlusion:
        return blended
    s12 = torch.floor(a * k.to(a.dtype) + 0.5).to(I64)
    s21 = torch.floor(b * k.to(b.dtype) + 0.5).to(I64)
    near = s12 if bool(t12 < 0.5) else s21
    d = (s12 - s21).abs() >> scale_shift
    w = ((d - 32) * 4).clamp(0, 256)
    return (blended * (256 - w) + near * w) >> 8


def warp_plane(src1, src2, flow, frac, t: np.float32, geom: ref.Geometry,
               chroma: bool, scale_shift: int, levels, occlusion: bool,
               subpel: bool, precision: str = "float32") -> torch.Tensor:
    """One blended output plane (rows, width) int64 at position t."""
    dev = src1.device
    rs, lh, lw, wa = geom.rs, geom.lh, geom.lw, geom.width
    rows = src1.shape[0]
    cy = torch.arange(rows, device=dev, dtype=I64)[:, None]
    cx = torch.arange(wa, device=dev, dtype=I64)[None, :]
    if chroma:
        scx = ((cx >> rs) & ~1).clamp(0, lw - 1)
        scy = ((cy >> rs) << 1).clamp(0, lh - 1)
    else:
        scx = (cx >> rs).clamp(max=lw - 1)
        scy = (cy >> rs).clamp(max=lh - 1)
    ox, oy = flow[0], flow[1]
    ox12, oy12 = ox[scy, scx], oy[scy, scx]
    bscy = (scy - (oy12 >> rs)).clamp(0, lh - 1)
    bscx = (scx - (ox12 >> rs)).clamp(0, lw - 1)
    ox21, oy21 = ox[bscy, bscx], oy[bscy, bscx]
    t12 = torch.tensor(np.float32(t), device=dev)
    t21 = torch.tensor(np.float32(1.0) - np.float32(t), device=dev)
    if subpel:
        fx, fy = frac[0], frac[1]
        d = ((ox12 << 6) + fx[scy, scx], (oy12 << 6) + fy[scy, scx],
             (ox21 << 6) + fx[bscy, bscx], (oy21 << 6) + fy[bscy, bscx])
        s12 = t12 * 0.5 if chroma else t12
        s21 = t21 * 0.5 if chroma else t21
    else:
        d = (ox12, oy12, ox21, oy21)
        unit = 32.0 if chroma else 64.0
        s12, s21 = t12 * unit, t21 * unit
    # each product rounded half away from zero, in float32
    dx12, dy12, dx21, dy21 = (ref._round_away(v.to(F32) * s)
                              for v, s in zip(d, (s12, s12, s21, s21)))
    if chroma:
        base_x = (cx >> 1) << 6
        cols = wa >> 1
    else:
        base_x = cx << 6
        cols = wa
    base_y = cy << 6
    p12 = (base_y + dy12, base_x + dx12)
    p21 = (base_y - dy21, base_x - dx21)
    if chroma:
        out = torch.empty((rows, wa), dtype=I64, device=dev)
        for par in (0, 1):          # u on the even columns, v on the odd
            def at(p):
                return p[0][:, par::2], p[1][:, par::2]
            a1 = src1[:, par:wa:2].to(I64)
            a2 = src2[:, par:wa:2].to(I64)
            out[:, par::2] = _blend(_sample(a1, *at(p12), rows, cols),
                                    _sample(a2, *at(p21), rows, cols),
                                    t12, t21, scale_shift, occlusion,
                                    precision)
        b = out
    else:
        b = _blend(_sample(src1[:, :wa].to(I64), *p12, rows, cols),
                   _sample(src2[:, :wa].to(I64), *p21, rows, cols),
                   t12, t21, scale_shift, occlusion, precision)
    return ref._levels(b, chroma, levels, scale_shift)


# -- the pair (``models.for_config``) -----------------------------------------

def outputs(f1, f2, geom: ref.Geometry, folded: ref.Folded, cfg: dict,
            scale_shift: int, levels, precision: str = "float32"):
    """The bilinear family's blended outputs of the pair in mode 2: (y, uv)
    int64 planes, one for each folded position, in order, each made as it
    is taken."""
    flow, frac = fields(f1, f2, folded, geom, cfg, scale_shift)
    occlusion = cfg["model"] == "hopperxq"
    subpel = bool(cfg["subpel_flow"])
    for t in folded.ts:
        yield tuple(warp_plane(f1[c], f2[c], flow, frac, t, geom, bool(c),
                               scale_shift, levels, occlusion, subpel,
                               precision) for c in (0, 1))


def outputs_lower(f1, f2, geom: ref.Geometry, folded: ref.Folded, cfg: dict,
                  scale_shift: int, levels):
    """The control's: ``outputs`` with the blend in bfloat16, the nearest
    lower precision than the float32 blend the family states."""
    return outputs(f1, f2, geom, folded, cfg, scale_shift, levels,
                   precision="bfloat16")
