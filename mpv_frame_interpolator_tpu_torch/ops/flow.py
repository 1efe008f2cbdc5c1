"""Hierarchical block-matching optical flow (counterpart of the JAX
package's ``ops/flow.py``).

The pyramid is a Python loop over (iteration, axis): each of the
2 x iterations steps is one call of the flow-step kernel
(ops/cuda/flow_step.py), which searches `radius` candidate offsets on one
axis, sums the biased SAD over window x window blocks and commits the
winner.  The final field is blurred by the blur kernel (ops/cuda/blur.py).

The search radius is a runtime integer <= MAX_SEARCH_RADIUS that bounds
the kernel's layer loop.  The JAX package's layer buckets (one compiled
program per layer count) have no counterpart here: nothing is compiled per
radius.

Frames are planar on the device: y (H, stride) and u, v (H//2, stride//2),
uint8 for NV12 or uint16 for P010.  H is the frame height and the flow
mirrors against the stride (`FlowGeometry.stride`), as the reference does.
Under P010 each candidate's SAD is shifted right by `luma_shift` (8)
before the delta scalar, so 8-bit content << 8 gives the 8-bit flow.

The geometry helpers and constants below are the reference's
(opticalFlowCalc.c, config.h), as the JAX package's ``ops/oracle.py``
states them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

FIRST_NEIGHBOR_ITERATION = 4    # config.h:1 (calcDeltaSumsKernel.cl:1)
MAX_CALC_RES = 270              # config.h:2
MAX_SEARCH_RADIUS = 16          # config.h:7
BLUR_KERNEL_RADIUS = 4          # blurFlowKernel.cl:2


def res_scalar_for(height: int, max_calc_res: int = MAX_CALC_RES) -> int:
    """opticalFlowCalc.c:331-334."""
    rs = 0
    while (height >> rs) > max_calc_res:
        rs += 1
    return rs


def low_dims_for(height: int, stride: int, rs: int):
    """opticalFlowCalc.c:335-336 (frameWidth is the stride)."""
    return math.ceil(height / (2 ** rs)), math.ceil(stride / (2 ** rs))


def start_window_size(lh: int, lw: int) -> int:
    """opticalFlowCalc.c:132-143: next power of two of max(lowdim), halved."""
    max_dim = max(lw, lh)
    if max_dim and (max_dim & (max_dim - 1)) == 0:
        window = max_dim
    else:
        while max_dim & (max_dim - 1):
            max_dim &= max_dim - 1
        window = max_dim << 1
    return window // 2


def num_iterations(window_size: int, num_iter_cfg: int = 0) -> int:
    """opticalFlowCalc.c:146-149."""
    it = int(math.log2(window_size)) if window_size > 1 else 0
    if num_iter_cfg == 0 or num_iter_cfg > it:
        return it
    return num_iter_cfg


@dataclasses.dataclass(frozen=True)
class FlowGeometry:
    """Static geometry of one flow problem: res scalar chosen so that
    height >> rs <= max_calc_res, low dims ceil(stride / 2**rs) x
    ceil(height / 2**rs), and the window schedule of the pyramid."""

    height: int
    stride: int
    actual_width: int
    res_scalar: int
    low_h: int
    low_w: int
    start_window: int
    iterations: int

    @classmethod
    def create(cls, height: int, stride: int, actual_width: int,
               max_calc_res: int = MAX_CALC_RES,
               num_iter_cfg: int = 0) -> "FlowGeometry":
        rs = res_scalar_for(height, max_calc_res)
        lh, lw = low_dims_for(height, stride, rs)
        window = start_window_size(lh, lw)
        iters = num_iterations(window, num_iter_cfg)
        return cls(height, stride, actual_width, rs, lh, lw, window, iters)

    def window_schedule(self) -> Tuple[int, ...]:
        """The window size of each iteration, halving down to 1."""
        out, w = [], self.start_window
        for _ in range(self.iterations):
            out.append(w)
            w = max(w >> 1, 1)
        return tuple(out)


def mirror_inside(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Reflect an index into [0, dim) once, then clip (the flow's
    mirror; the warp has its own, ops/warp.mirror_edge2)."""
    pos = torch.where(pos >= dim, dim - (pos - dim + 1), pos)
    pos = torch.where(pos < 0, -pos - 1, pos)
    return pos.clamp(0, dim - 1)


def signed_square(v: torch.Tensor) -> torch.Tensor:
    """v * v * sign(v): the quadratic spacing of the candidate offsets."""
    return torch.where(v > 0, v * v, -(v * v))


def subsampled_f2(geom: FlowGeometry, f2y: torch.Tensor, f2u: torch.Tensor,
                  f2v: torch.Tensor):
    """Frame-2 probe samples at the low-res grid, as contiguous planes
    (lh, lw) of the frame's dtype: y2[cy, cx] = f2y[cy << rs, cx << rs]
    and u2/v2[cy, cx] = f2u/v[(cy << rs) >> 1, (cx << rs) >> 1].  Only
    slices and copies, which every dtype supports (uint16 has little
    else)."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    s = 1 << rs
    y2 = f2y[::s, ::s][:lh, :lw]
    if rs == 0:
        def up2(p):
            h, w = p.shape
            return p[:, None, :, None].expand(h, 2, w, 2).reshape(
                2 * h, 2 * w)
        u2 = up2(f2u)[:lh, :lw]
        v2 = up2(f2v)[:lh, :lw]
    else:
        t = 1 << (rs - 1)
        u2 = f2u[::t, ::t][:lh, :lw]
        v2 = f2v[::t, ::t][:lh, :lw]
    return y2.contiguous(), u2.contiguous(), v2.contiguous()


def flow(geom: FlowGeometry, f1y, f1u, f1v, f2y, f2u, f2v, radius: int,
         delta_scalar: int = 8, neighbor_bias_scalar: int = 6,
         luma_shift: int = 0):
    """The whole pyramid plus the blur.  f1 is the OLDER frame, f2 the
    newer; `luma_shift` is 8 for P010 and 0 for NV12.  Returns (offset
    (2, lh, lw) int32, blurred (2, lh, lw) int32), plane 0 the x offsets
    and plane 1 the y offsets."""
    from mpv_frame_interpolator_tpu_torch.ops.cuda.flow_step import (
        flow_step)
    if not 1 <= radius <= MAX_SEARCH_RADIUS:
        raise NotImplementedError(
            f"search radius {radius} is outside [1, {MAX_SEARCH_RADIUS}]")
    lh, lw = geom.low_h, geom.low_w
    y2, u2, v2 = subsampled_f2(geom, f2y, f2u, f2v)
    off_x = torch.zeros((lh, lw), dtype=torch.int32, device=f1y.device)
    off_y = torch.zeros((lh, lw), dtype=torch.int32, device=f1y.device)
    for iteration, window in enumerate(geom.window_schedule()):
        for is_y in (0, 1):
            off_x, off_y = flow_step(
                f1y, f1u, f1v, y2, u2, v2, off_x, off_y, is_y, radius,
                delta_scalar, neighbor_bias_scalar, window,
                iteration >= FIRST_NEIGHBOR_ITERATION, geom.res_scalar,
                geom.height, geom.stride, luma_shift)
    offset = torch.stack([off_x, off_y])
    return offset, blur_flow(offset)


def blur_flow(offset: torch.Tensor) -> torch.Tensor:
    """8x8 box blur of a (2, lh, lw) int32 flow (taps [-4, 3], symmetric
    edges, division by 64 truncated toward zero), on the blur kernel."""
    from mpv_frame_interpolator_tpu_torch.ops.cuda.blur import (
        blur_flow as _blur)
    return _blur(offset)
