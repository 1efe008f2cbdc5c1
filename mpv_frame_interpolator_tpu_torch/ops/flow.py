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
all uint8.  H is the frame height and the flow mirrors against the stride
(`FlowGeometry.stride`), as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mpv_frame_interpolator_tpu.ops import oracle

FIRST_NEIGHBOR_ITERATION = oracle.FIRST_NEIGHBOR_ITERATION
BLUR_RADIUS = oracle.BLUR_KERNEL_RADIUS
MAX_SEARCH_RADIUS = oracle.MAX_SEARCH_RADIUS


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
               max_calc_res: int = oracle.MAX_CALC_RES,
               num_iter_cfg: int = 0) -> "FlowGeometry":
        rs = oracle.res_scalar_for(height, max_calc_res)
        lh, lw = oracle.low_dims_for(height, stride, rs)
        window = oracle.start_window_size(lh, lw)
        iters = oracle.num_iterations(window, num_iter_cfg)
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
    """Frame-2 probe samples at the low-res grid, as contiguous uint8
    planes (lh, lw): y2[cy, cx] = f2y[cy << rs, cx << rs] and
    u2/v2[cy, cx] = f2u/v[(cy << rs) >> 1, (cx << rs) >> 1]."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    s = 1 << rs
    y2 = f2y[::s, ::s][:lh, :lw]
    if rs == 0:
        u2 = f2u.repeat_interleave(2, 0).repeat_interleave(2, 1)[:lh, :lw]
        v2 = f2v.repeat_interleave(2, 0).repeat_interleave(2, 1)[:lh, :lw]
    else:
        t = 1 << (rs - 1)
        u2 = f2u[::t, ::t][:lh, :lw]
        v2 = f2v[::t, ::t][:lh, :lw]
    return y2.contiguous(), u2.contiguous(), v2.contiguous()


def flow(geom: FlowGeometry, f1y, f1u, f1v, f2y, f2u, f2v, radius: int,
         delta_scalar: int = 8, neighbor_bias_scalar: int = 6):
    """The whole pyramid plus the blur.  f1 is the OLDER frame, f2 the
    newer.  Returns (offset (2, lh, lw) int32, blurred (2, lh, lw) int32),
    plane 0 the x offsets and plane 1 the y offsets."""
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
                geom.height, geom.stride)
    offset = torch.stack([off_x, off_y])
    return offset, blur_flow(offset)


def blur_flow(offset: torch.Tensor) -> torch.Tensor:
    """8x8 box blur of a (2, lh, lw) int32 flow (taps [-4, 3], symmetric
    edges, division by 64 truncated toward zero), on the blur kernel."""
    from mpv_frame_interpolator_tpu_torch.ops.cuda.blur import (
        blur_flow as _blur)
    return _blur(offset)
