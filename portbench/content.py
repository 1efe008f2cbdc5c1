"""The source frames a cell plays: a ring of shots made on the device from
the seed.

Each shot is a band-limited texture (bicubic-upsampled noise for the
large shapes plus bilinear-upsampled noise for detail), panned by a
global motion of its own (even pixels a frame, at most `max_pan_px`),
with a few textured boxes moving over it at velocities of their own.
Shots alternate brighter and darker by `shot_offset`, so the change of
shot is a scene cut at any seed, while within a shot the mean luma step
stays well under the interpolator's cut threshold.  The ring holds
`shots` x `frames_per_shot` frames; the traffic plays it in order and
wraps, so the last frame of the ring is followed by a cut as well.

Every random number comes from one ``torch.Generator`` on the device and
one NumPy generator for the few host draws (motions, box sizes), both
seeded by the seed: the same seed gives the same planes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# standard deviation of unit noise after each upsampling (measured once;
# it sets the gains, so the statistics do not depend on the data)
BICUBIC_STD = 0.89
BILINEAR_STD = 0.67


@dataclasses.dataclass(frozen=True)
class RingParams:
    shots: int = 2
    frames_per_shot: int = 60
    max_pan_px: int = 32
    boxes: int = 4
    box_min_px: int = 96
    box_max_px: int = 384
    box_max_speed_px: int = 24
    base_cell_px: int = 128
    detail_cell_px: int = 8
    luma_mean: float = 128.0
    luma_base_std: float = 30.0
    luma_detail_std: float = 10.0
    shot_offset: float = 32.0
    chroma_base_std: float = 18.0
    chroma_detail_std: float = 4.0


def _texture(g, h: int, w: int, cell: int, detail: int, base_std: float,
             detail_std: float, mean: float, device) -> torch.Tensor:
    """(h, w) float32: mean + large shapes + detail."""
    def layer(step, mode, std, gain):
        n = torch.randn((1, 1, h // step + 3, w // step + 3), generator=g,
                        device=device)
        up = F.interpolate(n, scale_factor=step, mode=mode,
                           align_corners=False)[0, 0, :h, :w]
        return up * (std / gain)
    return (mean + layer(cell, "bicubic", base_std, BICUBIC_STD)
            + layer(detail, "bilinear", detail_std, BILINEAR_STD))


def _quantize(x: torch.Tensor, pixfmt: str) -> torch.Tensor:
    """8-bit-scale float samples as NV12 uint8 or P010 uint16 (10 bits in
    the top of the word)."""
    if pixfmt == "nv12":
        return x.round().clamp(0, 255).to(torch.uint8)
    v = (x * 4).round().clamp(0, 1023).to(torch.int32) << 6
    return v.to(torch.uint16)


def _paste(dst: torch.Tensor, patch: torch.Tensor, y: int, x: int):
    """Write `patch` at (y, x), clipped to `dst`."""
    h, w = dst.shape
    ph, pw = patch.shape
    y0, x0, y1, x1 = max(y, 0), max(x, 0), min(y + ph, h), min(x + pw, w)
    if y0 < y1 and x0 < x1:
        dst[y0:y1, x0:x1] = patch[y0 - y:y1 - y, x0 - x:x1 - x]


def make_ring(width: int, height: int, pixfmt: str, params: RingParams,
              seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """shots x frames_per_shot frames, each (y (H, W), uv (H/2, W)
    interleaved), uint8 for "nv12" or uint16 for "p010", on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    rng = np.random.default_rng([int(seed), 0x72696E67])
    H, W, n = height, width, params.frames_per_shot
    p = params
    ring = []
    for shot in range(p.shots):
        speed = rng.uniform(0.0, p.max_pan_px)
        angle = rng.uniform(0.0, 2 * math.pi)
        mx = 2 * int(round(speed * math.cos(angle) / 2))
        my = 2 * int(round(speed * math.sin(angle) / 2))
        span_x, span_y = abs(mx) * (n - 1), abs(my) * (n - 1)
        x0, y0 = (span_x if mx < 0 else 0), (span_y if my < 0 else 0)
        mean = p.luma_mean + (p.shot_offset if shot % 2 else -p.shot_offset)
        ch, cw = H + span_y, W + span_x
        luma = _texture(g, ch, cw, p.base_cell_px, p.detail_cell_px,
                        p.luma_base_std, p.luma_detail_std, mean, device)
        chroma = [_texture(g, ch // 2 + 1, cw // 2 + 1, p.base_cell_px // 2,
                           max(p.detail_cell_px // 2, 1), p.chroma_base_std,
                           p.chroma_detail_std, 128.0, device)
                  for _ in range(2)]
        boxes = []
        for _ in range(p.boxes):
            bh = int(rng.integers(p.box_min_px, p.box_max_px + 1)) & ~1
            bw = int(rng.integers(p.box_min_px, p.box_max_px + 1)) & ~1
            pos = (int(rng.integers(0, H)) & ~1, int(rng.integers(0, W)) & ~1)
            vel = tuple(2 * int(rng.integers(-p.box_max_speed_px // 2,
                                             p.box_max_speed_px // 2 + 1))
                        for _ in range(2))
            tone = float(rng.uniform(40.0, 216.0))
            cells = (max(p.detail_cell_px * 4, 2), max(p.detail_cell_px, 1))
            y_patch = _texture(g, bh, bw, *cells, 24.0, 12.0, tone, device)
            uv_patch = [_texture(g, bh // 2, bw // 2, max(cells[0] // 2, 1),
                                 max(cells[1] // 2, 1), 12.0, 4.0,
                                 float(rng.uniform(80.0, 176.0)), device)
                        for _ in range(2)]
            boxes.append((pos, vel, y_patch, uv_patch))
        for f in range(n):
            oy, ox = y0 + my * f, x0 + mx * f
            y = luma[oy:oy + H, ox:ox + W].clone()
            u, v = (c[oy // 2:oy // 2 + H // 2, ox // 2:ox // 2 + W // 2]
                    .clone() for c in chroma)
            for (py, px), (vy, vx), y_patch, (u_patch, v_patch) in boxes:
                by, bx = py + vy * f, px + vx * f
                _paste(y, y_patch, by, bx)
                _paste(u, u_patch, by // 2, bx // 2)
                _paste(v, v_patch, by // 2, bx // 2)
            uv = torch.stack((u, v), dim=-1).reshape(H // 2, W)
            ring.append((_quantize(y, pixfmt), _quantize(uv, pixfmt)))
    return ring
