"""S1: the measured sub-pel refinement of the flow (csrc/subpel_tile.cuh,
two phases of K1's launch in csrc/flow_step.cu).

Not a TPU kernel: the JAX package computes it with XLA,
``mpv_frame_interpolator_tpu/ops/flow.py:833 subpel_refine``, the
``subpel_flow`` option of its engine (pipeline/engine.py:486-515).  Around
each low-res pixel's UNBLURRED committed offset the SAD (y + u + v, no
bias terms) is probed on the 3 x 3 integer neighbourhood, each probe's
cost is averaged over the flow blur's 8 x 8 window, and a 2-D quadratic
through the nine costs gives the Newton step in 1/64 pel, clipped to
+-32 and zeroed where the fit has no interior minimum.

``subpel_frac_plain`` is that function in plain PyTorch (the
specification, held bit-exact against the JAX function by the CPU tests);
S1 writes ``(offset << 6) + frac``, the field the sub-pel path blurs next,
and ``subpel_refine_plain`` is its plain version.  Bound on the card:
bytes, and few of them (~2 us at 4K; see the header of
csrc/subpel_tile.cuh).

On the engine's path S1 is no launch of its own: under ``subpel_flow``
K1's cooperative launch runs S1's two phases after its last step (the
nine probe SADs of every pixel, then per tile their windows and the fit)
and blurs their field (``flow_step.flow_pyramid(..., subpel=True)``,
which adds one to ``counts.fused``).  ``subpel_refine``, the entry for
other callers, is the same launch with an empty schedule: the offset as
the starting field, the two phases and no blur (``counts.kernel``).  It
dispatches on the device: CPU tensors take ``subpel_refine_plain``, CUDA
tensors launch the kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda.blur import blur_flow_plain
from mpv_frame_interpolator_tpu_torch.ops.flow import mirror_inside

class SubpelCounts(_build.LaunchCounts):
    """S1's counts: `kernel` launches of the standalone entry, `plain`
    calls of the plain version, `fused` runs of S1's phases inside a
    flow-pyramid launch."""

    __slots__ = ("fused",)

    def reset(self):
        super().reset()
        self.fused = 0


counts = SubpelCounts()

# probe p's (dx, dy), in the JAX function's order
PROBES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
          (-1, -1), (1, 1), (-1, 1), (1, -1))


def probe_sads(offset, f1y, f1u, f1v, y2, u2, v2, rs: int, H: int, W: int,
               luma_shift: int = 0) -> torch.Tensor:
    """(9, lh, lw) int32: each probe's y + u + v SAD at every low-res
    pixel, f1 at mirror_inside((c << rs) + offset + PROBES[p]), shifted
    right by `luma_shift`.  The planes are widened before they are
    indexed (CUDA does not index uint16)."""
    i32 = torch.int32
    f1y, f1u, f1v, y2, u2, v2 = (p.to(i32) for p in (f1y, f1u, f1v, y2, u2,
                                                    v2))
    _, lh, lw = offset.shape
    dev = offset.device
    cy = (torch.arange(lh, dtype=i32, device=dev) << rs)[:, None]
    cx = (torch.arange(lw, dtype=i32, device=dev) << rs)[None, :]
    sads = []
    for dx, dy in PROBES:
        ncx = mirror_inside(cx + offset[0] + dx, W).long()
        ncy = mirror_inside(cy + offset[1] + dy, H).long()
        sads.append((f1y[ncy, ncx] - y2).abs()
                    + (f1u[ncy >> 1, ncx >> 1] - u2).abs()
                    + (f1v[ncy >> 1, ncx >> 1] - v2).abs())
    return torch.stack(sads) >> luma_shift


def subpel_frac_plain(offset, f1y, f1u, f1v, y2, u2, v2, rs: int, H: int,
                      W: int, luma_shift: int = 0) -> torch.Tensor:
    """The (2, lh, lw) int32 sub-pel correction in 1/64 pel (the JAX
    package's ``subpel_refine``): the probes' windowed costs (the flow
    blur's taps and edges; the sums are positive, so its truncating
    division is >> 6), the integer gradient and Hessian, and the Newton
    step, all in int32 as the JAX function has them.  ``jax.lax.div``
    truncates toward zero, hence rounding_mode="trunc"."""
    costs = blur_flow_plain(probe_sads(offset, f1y, f1u, f1v, y2, u2, v2,
                                       rs, H, W, luma_shift))
    d0, dxm, dxp, dym, dyp, dmm, dpp, dmp, dpm = costs
    gx2 = dxp - dxm
    gy2 = dyp - dym
    hxx = dxp + dxm - 2 * d0
    hyy = dyp + dym - 2 * d0
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


def subpel_refine_plain(offset, f1y, f1u, f1v, y2, u2, v2, rs: int, H: int,
                        W: int, luma_shift: int = 0) -> torch.Tensor:
    """S1's function in plain PyTorch: (offset << 6) + frac."""
    return (offset << 6) + subpel_frac_plain(offset, f1y, f1u, f1v, y2, u2,
                                             v2, rs, H, W, luma_shift)


def subpel_refine(offset, f1y, f1u, f1v, y2, u2, v2, rs: int, H: int,
                  W: int, luma_shift: int = 0) -> torch.Tensor:
    """The 1/64-pel field (offset << 6) + frac, (2, lh, lw) int32.

    offset (2, lh, lw) int32 is the unblurred committed flow; f1y
    (H', W') and f1u/f1v (H'/2, W'/2) the older frame's planes (H' >= H,
    W' >= W); y2/u2/v2 (lh, lw) the newer frame's probe
    (ops/flow.subsampled_f2), all uint8 or all uint16.  H and W are the
    frame height and stride, against which the probes mirror; each SAD is
    shifted right by `luma_shift` (8 for P010)."""
    if offset.dim() != 3 or offset.shape[0] != 2:
        raise ValueError(f"offset must be (2, lh, lw), got "
                         f"{tuple(offset.shape)}")
    _, lh, lw = offset.shape
    if not 0 <= luma_shift <= 31:
        raise ValueError(f"luma_shift {luma_shift} outside [0, 31]")
    if f1y.shape[0] < H or f1y.shape[1] < W or \
            f1u.shape[0] < H // 2 or f1u.shape[1] < W // 2:
        raise ValueError(f"f1 planes {tuple(f1y.shape)}/"
                         f"{tuple(f1u.shape)} smaller than {H}x{W}")
    if (lh - 1) << rs >= H or (lw - 1) << rs >= W:
        raise ValueError("low-res field does not fit the frame")
    if offset.device.type == "cpu":
        counts.plain += 1
        return subpel_refine_plain(offset, f1y, f1u, f1v, y2, u2, v2, rs, H,
                                   W, luma_shift)
    dev = offset.device
    sample = f1y.dtype
    if sample not in (torch.uint8, torch.uint16):
        raise ValueError(f"planes must be uint8 or uint16, got {sample}")
    _build.require(offset, "offset", torch.int32, (2, lh, lw), dev)
    _build.require(f1y, "f1y", sample, None, dev)
    _build.require(f1u, "f1u", sample, None, dev)
    _build.require(f1v, "f1v", sample, f1u.shape, dev)
    for name, t in (("y2", y2), ("u2", u2), ("v2", v2)):
        _build.require(t, name, sample, (lh, lw), dev)
    out = torch.empty_like(offset)
    field = torch.empty_like(offset)        # the launch's starting field
    sums = torch.empty(9 * lh * lw, dtype=torch.int32, device=dev)
    rc = _build.load().mfi_subpel_refine(
        offset.data_ptr(), f1y.data_ptr(), f1u.data_ptr(), f1v.data_ptr(),
        y2.data_ptr(), u2.data_ptr(), v2.data_ptr(), out.data_ptr(),
        field.data_ptr(), sums.data_ptr(), lh, lw, rs, H, W, f1y.shape[1],
        f1u.shape[1], f1y.element_size(), luma_shift,
        _build.stream_of(offset))
    _build.check("subpel_refine", rc)
    counts.kernel += 1
    return out
