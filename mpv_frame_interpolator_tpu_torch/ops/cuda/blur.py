"""K3: the 8x8 box blur of the flow field (csrc/blur.cu).

Replaces the TPU kernel ``mpv_frame_interpolator_tpu/ops/pallas/blur.py:
blur_flow_pallas``, whose XLA twin ``ops/flow.blur_flow`` runs on every
pair of the JAX main path: taps [-4, 3] per axis, symmetric edges (as
``jnp.pad(mode="symmetric")``, reflecting again when a dimension is
smaller than 4), an int32 sum, division by 64 truncated toward zero.

Bound on the card: bytes -- the 4K field is 1 MB in and 1 MB out,
~0.6 us at 3.35 TB/s, less than a launch of its own costs.  So the
engine's path blurs inside the flow pyramid's launch, as its last phase
(``flow_step.flow_pyramid(..., blur=True)``, which adds one to
``counts.fused``), and this standalone kernel serves the public
``ops/flow.blur_flow``.  Both run the tile body of csrc/blur_tile.cuh: a
32 x 8 tile's input window loaded into shared memory once, reflected only
at the field's edges, summed along the rows and then down the columns.

``blur_flow`` dispatches on the device: CPU tensors take
``blur_flow_plain``, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.flow import BLUR_KERNEL_RADIUS


class BlurCounts(_build.LaunchCounts):
    """K3's counts: `kernel` launches of the standalone kernel, `plain`
    calls of the plain version, `fused` blurs run as the last phase of a
    flow-pyramid launch."""

    __slots__ = ("fused",)

    def reset(self):
        super().reset()
        self.fused = 0


counts = BlurCounts()


def symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of each position -r .. n-1+r under numpy's
    "symmetric" padding: the periodic reflection with period 2n."""
    j = torch.remainder(torch.arange(-r, n + r, device=device), 2 * n)
    return torch.where(j >= n, 2 * n - 1 - j, j)


def blur_flow_plain(offset: torch.Tensor) -> torch.Tensor:
    r = BLUR_KERNEL_RADIUS
    _, lh, lw = offset.shape
    iy = symmetric_index(lh, r, offset.device)
    ix = symmetric_index(lw, r, offset.device)
    padded = offset.to(torch.int32)[:, iy][:, :, ix]
    rows = sum(padded[:, r + ky:r + ky + lh, :] for ky in range(-r, r))
    acc = sum(rows[:, :, r + kx:r + kx + lw] for kx in range(-r, r))
    return torch.div(acc, (2 * r) ** 2, rounding_mode="trunc")


def blur_flow(offset: torch.Tensor) -> torch.Tensor:
    """(2, lh, lw) int32 -> (2, lh, lw) int32 blurred."""
    if offset.dim() != 3 or offset.shape[0] != 2:
        raise ValueError(f"offset must be (2, lh, lw), got "
                         f"{tuple(offset.shape)}")
    if offset.device.type == "cpu":
        counts.plain += 1
        return blur_flow_plain(offset)
    _build.require(offset, "offset", torch.int32)
    _, lh, lw = offset.shape
    out = torch.empty_like(offset)
    rc = _build.load().mfi_blur_flow(offset.data_ptr(), out.data_ptr(), lh,
                                     lw, _build.stream_of(offset))
    _build.check("blur_flow", rc)
    counts.kernel += 1
    return out
