"""One source pair, in plain PyTorch on the device of the planes.

Planes are as a decoder hands them over: luma (H, stride) and the
interleaved chroma (H/2, stride), uint8 for NV12, or uint16 for P010 with
the 10-bit value in the top bits (``scale_shift`` 8).  Every integer is
computed in int64; unsigned 32-bit sums are int64 masked to 32 bits.

The semantics, stage by stage:

* cut score: mean |y1 - y2| >> scale_shift over the luma samples on the
  stride-2^rs grid; the int64 sum rounded to float32 times the float32
  reciprocal of the count; a cut where the score exceeds the float32
  threshold.  Under a cut "nearest" snaps each position to 0 or 1 (t >=
  0.5) and the flow is zero.
* flow (opticalFlowCalc.c:126-203): a pyramid of window sizes from half
  the next power of two of the low-res size down to 1, an x step then a
  y step at each; a step tries `radius` offsets (z - radius/2) *
  |z - radius/2| on its axis around the committed field, each pixel's
  partial the SAD of luma, u and v between f1 at the mirrored offset
  position and f2 at the pixel (>> scale_shift, then << delta_scalar),
  plus |offset|, plus from iteration 4 the neighbour bias (<<
  neighbor_bias_scalar) against the field 2 * window away on four sides;
  the partials summed mod 2^32 over each window, the first unsigned
  minimum committed.  Then the 8x8 box blur, taps [-4, 3], symmetric
  edges, truncating division by 64.
* warp (warpFrameKernel.cl:114-182): each output sample reads the flow
  at its low-res cell (chroma: the even column and doubled row), the
  reverse flow at that cell minus the flow >> rs, and samples f1 at p +
  round(flow * t) and f2 at p - round(flow21 * (1 - t)), float32 products
  rounded half away from zero (chroma halves the vertical product and
  keeps its u/v column parity), mirrored into [1, dim - 2]; blended in
  fixed point with 24 fraction bits (16 for P010), T = round_half_even(t
  * 2^frac); then the exact-integer level maps, capped at 255 <<
  scale_shift.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

FIRST_NEIGHBOR_ITERATION = 4
BLUR_RADIUS = 4
MASK = 0xFFFFFFFF
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class Geometry:
    height: int
    stride: int
    width: int
    rs: int
    lh: int
    lw: int
    windows: Tuple[int, ...]


def geometry(height: int, stride: int, width: int, max_calc_res: int,
             num_iterations: int = 0) -> Geometry:
    """opticalFlowCalc.c:132-149, 331-336."""
    rs = 0
    while (height >> rs) > max_calc_res:
        rs += 1
    lh, lw = math.ceil(height / 2 ** rs), math.ceil(stride / 2 ** rs)
    top = max(lh, lw)
    # the next power of two of the larger low-res size, halved
    window = (top if top & (top - 1) == 0 else 1 << top.bit_length()) // 2
    iters = int(math.log2(window)) if window > 1 else 0
    if num_iterations and num_iterations < iters:
        iters = num_iterations
    windows = tuple(max(window >> i, 1) for i in range(iters))
    return Geometry(height, stride, width, rs, lh, lw, windows)


# -- the cut ----------------------------------------------------------------

def cut_score(y1: torch.Tensor, y2: torch.Tensor, rs: int,
              scale_shift: int) -> np.float32:
    s = 1 << rs
    a, b = y1[::s, ::s].to(I64), y2[::s, ::s].to(I64)
    total = int(((a - b).abs() >> scale_shift).sum())
    return np.float32(total) * (np.float32(1.0) / np.float32(a.numel()))


def is_cut(score: np.float32, threshold: float) -> bool:
    return bool(score > np.float32(threshold))


def fold(ts: List[float], cut: bool) -> np.ndarray:
    """The float32 positions a pair blends at: under a cut ("nearest")
    each snaps to the nearer source."""
    t = np.asarray(ts, dtype=np.float32)
    return (t >= np.float32(0.5)).astype(np.float32) if cut else t


# -- the flow ---------------------------------------------------------------

def _mirror_inside(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """calcDeltaSumsKernel.cl:84-93, clipped."""
    pos = torch.where(pos >= dim, dim - (pos - dim + 1), pos)
    pos = torch.where(pos < 0, -pos - 1, pos)
    return pos.clamp(0, dim - 1)


def _signed_square(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, v * v, -(v * v))


def _window_sums(partial: torch.Tensor, window: int) -> torch.Tensor:
    n, lh, lw = partial.shape
    nwy, nwx = -(-lh // window), -(-lw // window)
    padded = partial.new_zeros((n, nwy * window, nwx * window))
    padded[:, :lh, :lw] = partial
    return padded.reshape(n, nwy, window, nwx, window).sum(dim=(2, 4)) & MASK


def flow(f1y, f1uv, f2y, f2uv, geom: Geometry, radius: int,
         delta_scalar: int, neighbor_bias_scalar: int,
         scale_shift: int) -> torch.Tensor:
    """The committed field (2, lh, lw) int64, plane 0 the x offsets; f1 is
    the older frame."""
    dev = f1y.device
    H, W = f1y.shape
    rs, lh, lw = geom.rs, geom.lh, geom.lw
    y1, uv1 = f1y.to(I64), f1uv.to(I64)
    cy = (torch.arange(lh, device=dev, dtype=I64) << rs)[:, None]
    cx = (torch.arange(lw, device=dev, dtype=I64) << rs)[None, :]
    c2 = cx & ~1
    y2 = f2y.to(I64)[cy, cx]
    u2 = f2uv.to(I64)[cy >> 1, c2]
    v2 = f2uv.to(I64)[cy >> 1, c2 + 1]
    adj = _signed_square(torch.arange(radius, device=dev, dtype=I64)
                         - radius // 2)[:, None, None]
    off = torch.zeros((2, lh, lw), dtype=I64, device=dev)
    xs, ys = torch.arange(lw, device=dev), torch.arange(lh, device=dev)
    for iteration, window in enumerate(geom.windows):
        for axis in (0, 1):
            cand = off[axis][None] + adj
            other = off[1 - axis][None]
            ox, oy = (cand, other) if axis == 0 else (other, cand)
            nx = _mirror_inside(cx + ox, W)
            ny = _mirror_inside(cy + oy, H)
            nc = nx & ~1
            sad = ((y1[ny, nx] - y2).abs() + (uv1[ny >> 1, nc] - u2).abs()
                   + (uv1[ny >> 1, nc + 1] - v2).abs())
            partial = (((sad >> scale_shift) << delta_scalar) & MASK) \
                + cand.abs()
            if iteration >= FIRST_NEIGHBOR_ITERATION:
                plane, w2 = off[axis], 2 * window
                nb = torch.zeros_like(partial)
                for n in (plane[:, (xs + w2).clamp(max=lw - 1)],
                          plane[:, (xs - w2).clamp(min=0)],
                          plane[(ys + w2).clamp(max=lh - 1)],
                          plane[(ys - w2).clamp(min=0)]):
                    nb = nb + (n[None] - cand).abs()
                partial = partial + ((nb << neighbor_bias_scalar) & MASK)
            sums = _window_sums(partial & MASK, window)
            best = adj[:, 0, 0][torch.argmin(sums, dim=0)]   # first minimum
            nwy, nwx = best.shape
            off[axis] += best[:, None, :, None].expand(
                nwy, window, nwx, window).reshape(
                nwy * window, nwx * window)[:lh, :lw]
    return off


def blur(field: torch.Tensor) -> torch.Tensor:
    """blurFlowKernel.cl: the 8x8 box, taps [-4, 3], edges mirrored
    symmetrically (-1 -> 0, dim -> dim - 1), truncated division by 64."""
    _, lh, lw = field.shape
    r, dev = BLUR_RADIUS, field.device

    def taps(n):
        i = torch.arange(-r, n + r, device=dev)
        i = torch.where(i < 0, -i - 1, i)
        return torch.where(i >= n, 2 * n - i - 1, i)

    padded = field[:, taps(lh)][:, :, taps(lw)]
    acc = torch.zeros_like(field)
    for ky in range(2 * r):
        for kx in range(2 * r):
            acc += padded[:, ky:ky + lh, kx:kx + lw]
    return torch.div(acc, (2 * r) ** 2, rounding_mode="trunc")


# -- the warp ---------------------------------------------------------------

def _mirror_edge2(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """warpFrameKernel.cl:10-18: reflect, then clamp into [1, dim - 2]."""
    res = torch.where(pos >= dim - 1, pos - (pos - (dim - 2)) * 2, pos)
    res = torch.where(pos < 1, -pos + 1, res)
    return res.clamp(1, dim - 2)


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """OpenCL round() of a float32, in float32."""
    return (torch.sign(x) * torch.floor(x.abs() + 0.5)).to(I64)


def _levels(b: torch.Tensor, chroma: bool, levels, scale_shift: int):
    """warpFrameKernel.cl:1-7 as exact rational truncation, on the 8-bit
    scale shifted by scale_shift, capped at 255 << scale_shift."""
    black, white = levels
    cap = 255 << scale_shift
    if chroma:
        w = max(white, 1)
        mid = 128 << scale_shift
        n = ((b - mid) * 255 + mid * w).clamp(min=0)
        return torch.div(n, w, rounding_mode="floor").clamp(max=cap)
    n = ((b - (black << scale_shift)) * 255).clamp(min=0)
    return torch.div(n, max(white - black, 1),
                     rounding_mode="floor").clamp(max=cap)


def blend_weights(t: np.float32, scale_shift: int) -> Tuple[int, int]:
    """(w1, T): T = round_half_even(t * 2^frac) in float32, clipped."""
    one = 1 << (24 - (8 if scale_shift else 0))
    T = int(np.clip(np.rint(np.float32(t) * np.float32(one)), 0, one))
    return one - T, T


def warp_plane(src1, src2, blurred, t: np.float32, geom: Geometry,
               chroma: bool, scale_shift: int, levels,
               blend: str = "fixed") -> torch.Tensor:
    """One blended output plane (rows, width) int64 at position t.
    `blend` "fixed" is the stated blend; "bfloat16" computes it in
    bfloat16 (the benchmark's lower-precision control)."""
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
    ox, oy = blurred[0], blurred[1]
    ox12, oy12 = ox[scy, scx], oy[scy, scx]
    bscy = (scy - (oy12 >> rs)).clamp(0, lh - 1)
    bscx = (scx - (ox12 >> rs)).clamp(0, lw - 1)
    ox21, oy21 = ox[bscy, bscx], oy[bscy, bscx]
    t12 = torch.tensor(np.float32(t), device=dev)
    t21 = torch.tensor(np.float32(1.0) - np.float32(t), device=dev)

    def moved(f, s, vertical):
        d = f.to(torch.float32) * s
        if vertical and chroma:
            d = d * 0.5
        return _round_away(d)

    x12 = _mirror_edge2(cx + moved(ox12, t12, False), wa)
    y12 = _mirror_edge2(cy + moved(oy12, t12, True), rows)
    x21 = _mirror_edge2(cx - moved(ox21, t21, False), wa)
    y21 = _mirror_edge2(cy - moved(oy21, t21, True), rows)
    if chroma:
        x12 = (x12 & ~1) + (cx & 1)
        x21 = (x21 & ~1) + (cx & 1)
    s12 = src1.to(I64)[y12, x12]
    s21 = src2.to(I64)[y21, x21]
    if blend == "fixed":
        w1, T = blend_weights(t, scale_shift)
        frac = 24 - (8 if scale_shift else 0)
        b = (s12 * w1 + s21 * T) >> frac
    elif blend == "bfloat16":
        bf = torch.bfloat16
        b = torch.floor(s12.to(bf) * t21.to(bf) + s21.to(bf) * t12.to(bf)
                        ).to(I64)
    else:
        raise ValueError(f"unknown blend {blend!r}")
    return _levels(b, chroma, levels, scale_shift)


# -- a pair -----------------------------------------------------------------

@dataclasses.dataclass
class Folded:
    """The pair's prologue, shared by every flow model (C1 serves them
    all): the cut score, the cut decision and the folded positions."""
    score: np.float32
    cut: bool
    ts: np.ndarray                  # (N,) float32 folded positions


@dataclasses.dataclass
class PairResult:
    score: np.float32
    cut: bool
    ts: np.ndarray                  # (N,) float32 folded positions
    blurred: torch.Tensor           # (2, lh, lw) int64


def prologue(f1, f2, geom: Geometry, ts: List[float], scale_shift: int,
             scene_detection: bool, threshold: float) -> Folded:
    """The cut and the folded positions of the pair f1 -> f2, each a (y,
    uv) pair of planes."""
    score = cut_score(f1[0], f2[0], geom.rs, scale_shift)
    cut = scene_detection and is_cut(score, threshold)
    return Folded(score, cut, fold(ts, cut))


def _blurred(f1, f2, folded: Folded, geom: Geometry, radius: int,
             delta_scalar: int, neighbor_bias_scalar: int,
             scale_shift: int) -> torch.Tensor:
    """The blurred flow; zero under a cut."""
    if folded.cut:
        return torch.zeros((2, geom.lh, geom.lw), dtype=I64,
                           device=f1[0].device)
    return blur(flow(f1[0], f1[1], f2[0], f2[1], geom, radius, delta_scalar,
                     neighbor_bias_scalar, scale_shift))


def pair(f1, f2, geom: Geometry, ts: List[float], radius: int,
         delta_scalar: int, neighbor_bias_scalar: int, scale_shift: int,
         scene_detection: bool, threshold: float) -> PairResult:
    """The cut, the folded positions and the blurred flow of the pair f1
    -> f2, each a (y, uv) pair of planes."""
    p = prologue(f1, f2, geom, ts, scale_shift, scene_detection, threshold)
    return PairResult(p.score, p.cut, p.ts, _blurred(
        f1, f2, p, geom, radius, delta_scalar, neighbor_bias_scalar,
        scale_shift))


def output(f1, f2, result: PairResult, k: int, geom: Geometry,
           scale_shift: int, levels, blend: str = "fixed"):
    """The k-th blended output (y, uv) of the pair, int64 planes."""
    t = result.ts[k]
    return tuple(warp_plane(f1[c], f2[c], result.blurred, t, geom, bool(c),
                            scale_shift, levels, blend) for c in (0, 1))


# -- hopper's pair reference (``models.for_config``) -------------------------

# what this reference judges; any sampler, since every sampler's outputs
# are the same samples
COVERS = {"model": ("hopper",), "frame_output_mode": (2,),
          "subpel_flow": (False,)}


def outputs(f1, f2, geom: Geometry, folded: Folded, cfg: dict,
            scale_shift: int, levels, blend: str = "fixed"):
    """hopper's blended outputs of the pair in mode 2: (y, uv) int64
    planes, one for each folded position, in order, each made as it is
    taken."""
    result = PairResult(folded.score, folded.cut, folded.ts, _blurred(
        f1, f2, folded, geom, int(cfg["initial_search_radius"]),
        int(cfg["delta_scalar"]), int(cfg["neighbor_bias_scalar"]),
        scale_shift))
    for k in range(len(folded.ts)):
        yield output(f1, f2, result, k, geom, scale_shift, levels, blend)


def outputs_lower(f1, f2, geom: Geometry, folded: Folded, cfg: dict,
                  scale_shift: int, levels):
    """The control's: ``outputs`` with the blend in bfloat16, the nearest
    lower precision than the exact fixed-point blend of float32
    positions."""
    return outputs(f1, f2, geom, folded, cfg, scale_shift, levels,
                   blend="bfloat16")


def level_ints(black: float, white: float) -> Tuple[int, int]:
    """The levels rounded half to even in float32."""
    return (int(np.rint(np.float32(black))), int(np.rint(np.float32(white))))
