"""Deterministic synthetic video sources (the port's copy of the JAX
package's ``io/synthetic.py``): moving patterns made at run time from a
seed, as 8-bit NV12 or 10-bit P010 (the 8-bit pattern << 8).  All
sources yield VideoFrame with monotonically increasing pts and a
nominal_fps, so they slot straight into the pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from mpv_frame_interpolator_tpu_torch.frame import (
    NV12, FrameFormat, VideoFrame)


@dataclasses.dataclass
class SyntheticConfig:
    width: int = 192
    height: int = 108
    fps: float = 24.0
    pixfmt: str = NV12
    stride: Optional[int] = None
    seed: int = 1234
    start_pts: float = 0.0


def _fmt(cfg: SyntheticConfig) -> FrameFormat:
    return FrameFormat(cfg.width, cfg.height, cfg.pixfmt, cfg.stride)


def _pack(cfg: SyntheticConfig, y8, u8, v8, idx: int) -> VideoFrame:
    """Pack 8-bit planar Y/U/V (U,V at half res) into an NV12/P010 frame."""
    fmt = _fmt(cfg)
    shift = 0 if fmt.bit_depth == 8 else 8
    y = np.zeros(fmt.luma_shape(), fmt.dtype)
    uv = np.zeros(fmt.chroma_shape(), fmt.dtype)
    y[:, :cfg.width] = (y8.astype(fmt.dtype) << shift) if shift else y8
    uv[:, 0:cfg.width:2] = (u8.astype(fmt.dtype) << shift) if shift else u8
    uv[:, 1:cfg.width:2] = (v8.astype(fmt.dtype) << shift) if shift else v8
    return VideoFrame(y, uv, fmt, pts=cfg.start_pts + idx / cfg.fps,
                      nominal_fps=cfg.fps)


def moving_box(cfg: SyntheticConfig, n_frames: int,
               vx: float = 3.0, vy: float = 1.0,
               box: int = 24) -> Iterator[VideoFrame]:
    """A bright box translating over a dark gradient background."""
    h, w = cfg.height, cfg.width
    yy, xx = np.mgrid[0:h, 0:w]
    bg = (16 + (xx * 64) // max(w, 1) + (yy * 32) // max(h, 1)).astype(np.uint8)
    for i in range(n_frames):
        x0 = int(w * 0.2 + vx * i) % max(w - box, 1)
        y0 = int(h * 0.3 + vy * i) % max(h - box, 1)
        y8 = bg.copy()
        y8[y0:y0 + box, x0:x0 + box] = 235
        u8 = np.full((h // 2, w // 2), 110, np.uint8)
        v8 = np.full((h // 2, w // 2), 150, np.uint8)
        u8[y0 // 2:(y0 + box) // 2, x0 // 2:(x0 + box) // 2] = 90
        v8[y0 // 2:(y0 + box) // 2, x0 // 2:(x0 + box) // 2] = 170
        yield _pack(cfg, y8, u8, v8, i)


def gradient_pan(cfg: SyntheticConfig, n_frames: int,
                 vx: int = 2, vy: int = 0) -> Iterator[VideoFrame]:
    """A textured plane translating uniformly (pure global motion)."""
    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(cfg.seed)
    big = rng.integers(16, 236, size=(h * 2, w * 2), dtype=np.int32)
    # low-pass so block matching has structure to lock onto
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) // 4
    big = big.astype(np.uint8)
    ub = rng.integers(64, 192, size=(h, w), dtype=np.int32).astype(np.uint8)
    vb = rng.integers(64, 192, size=(h, w), dtype=np.int32).astype(np.uint8)
    for i in range(n_frames):
        ox, oy = (vx * i) % w, (vy * i) % h
        y8 = big[oy:oy + h, ox:ox + w]
        u8 = ub[oy // 2:(oy // 2 + h // 2), ox // 2:(ox // 2 + w // 2)]
        v8 = vb[oy // 2:(oy // 2 + h // 2), ox // 2:(ox // 2 + w // 2)]
        yield _pack(cfg, y8, u8, v8, i)


def noise(cfg: SyntheticConfig, n_frames: int) -> Iterator[VideoFrame]:
    """Per-frame independent noise (scene-change torture source)."""
    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(cfg.seed)
    for i in range(n_frames):
        y8 = rng.integers(0, 256, size=(h, w), dtype=np.int32).astype(np.uint8)
        u8 = rng.integers(0, 256, size=(h // 2, w // 2), dtype=np.int32).astype(np.uint8)
        v8 = rng.integers(0, 256, size=(h // 2, w // 2), dtype=np.int32).astype(np.uint8)
        yield _pack(cfg, y8, u8, v8, i)


def scene_cut(cfg: SyntheticConfig, n_frames: int, cut_at: int = 5,
              **kw) -> Iterator[VideoFrame]:
    """Two different moving-box scenes with a hard cut at frame cut_at."""
    a = moving_box(cfg, n_frames, **kw)
    cfg2 = dataclasses.replace(cfg, seed=cfg.seed + 1)
    b = gradient_pan(cfg2, n_frames)
    for i, (fa, fb) in enumerate(zip(a, b)):
        yield fa if i < cut_at else fb.with_pts(fa.pts)


def random_frames(cfg: SyntheticConfig, n_frames: int) -> Iterator[VideoFrame]:
    """Alias of noise() used by kernel golden tests."""
    return noise(cfg, n_frames)
