"""The flagship model family as a standalone object: hierarchical
block-matching flow + warp (the port's counterpart of the JAX package's
``models/hopper.py``).

A thin facade over ``ops/flow.py`` and the engine's warp dispatch:
analyze a source pair into a flow field, synthesize any number of
in-between frames from it.  The engine inlines the same composition
(``pipeline/engine.py``).  Planes come in as the JAX facade takes them --
luma and planar u / v, uint8 (NV12) or uint16 (P010, ``scale_shift`` 8)
-- as tensors on ``device``, and the outputs are (y, u, v) there.  There
are no parameters, so it is a frozen dataclass, not an ``nn.Module``.
"""

from __future__ import annotations

import dataclasses

import torch

from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
from mpv_frame_interpolator_tpu_torch.ops import warp as warp_ops


@dataclasses.dataclass(frozen=True)
class HopperModel:
    """One geometry-bound instance of the block-matching interpolator."""

    geom: flow_ops.FlowGeometry
    search_radius: int = 16
    mode: int = warp_ops.BLENDED_FRAME
    scale_shift: int = 0            # 0 = 8-bit NV12, 8 = P010
    delta_scalar: int = 8
    neighbor_bias_scalar: int = 6
    device: str = "cuda"

    @classmethod
    def for_frame(cls, height: int, width: int, stride: int = None,
                  **kw) -> "HopperModel":
        geom = flow_ops.FlowGeometry.create(height, stride or width, width)
        return cls(geom=geom, **kw)

    def _planes(self, *planes):
        return [torch.as_tensor(p).to(self.device) for p in planes]

    def analyze(self, f1y, f1u, f1v, f2y, f2u, f2v):
        """Source pair -> (raw offset field, blurred field), (2, lh, lw)
        int32."""
        return flow_ops.flow(self.geom, *self._planes(
            f1y, f1u, f1v, f2y, f2u, f2v), self.search_radius,
            self.delta_scalar, self.neighbor_bias_scalar, self.scale_shift)

    def synthesize(self, f1y, f1u, f1v, f2y, f2u, f2v, blurred, t,
                   black=0.0, white=255.0):
        """One in-between frame at blend position t -> (y, u, v).

        t must be <= 1.0 (the reference rejects larger scalars,
        opticalFlowCalc.c:209-211)."""
        if float(t) > 1.0:
            raise ValueError("blending scalar must be <= 1.0")
        y, u, v = self.synthesize_batch(f1y, f1u, f1v, f2y, f2u, f2v,
                                        blurred, [float(t)], black, white)
        return y[0], u[0], v[0]

    def synthesize_batch(self, f1y, f1u, f1v, f2y, f2u, f2v, blurred, ts,
                         black=0.0, white=255.0):
        """All in-between frames of a pair -> (y (N, H, Wa), u, v (N, H/2,
        Wa/2))."""
        from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
            _warp_stage)
        f1y, f1u, f1v, f2y, f2u, f2v, blurred = self._planes(
            f1y, f1u, f1v, f2y, f2u, f2v, blurred)
        ts = torch.as_tensor(ts, dtype=torch.float32).to(self.device)
        planes = (f1y, _interleave(f1u, f1v), f2y, _interleave(f2u, f2v))
        y, uv = _warp_stage(self.geom, self.scale_shift,
                            warp_ops.level_ints(black, white), self.mode,
                            "pair", "hopper", planes,
                            blurred.to(torch.int32), ts)
        y = torch.stack([y[i] for i in range(len(ts))])
        uv = torch.stack([uv[i] for i in range(len(ts))])
        return y, uv[..., 0::2], uv[..., 1::2]

    def interpolate(self, f1y, f1u, f1v, f2y, f2u, f2v, ts, **kw):
        """analyze + synthesize_batch in one call."""
        _, blurred = self.analyze(f1y, f1u, f1v, f2y, f2u, f2v)
        return self.synthesize_batch(f1y, f1u, f1v, f2y, f2u, f2v,
                                     blurred, ts, **kw)


def _interleave(u, v):
    """Planar (rows, cols) u and v -> the interleaved (rows, 2 * cols)
    NV12/P010 chroma plane the warp kernels read."""
    return torch.stack((u, v), dim=-1).reshape(u.shape[0], -1)
