"""Frame format conversion (autoconvert analog).

The reference inserts an autoconvert filter that transparently converts any
decoded format into the one the filter demands -- HopperRender requires
NV12 (filters/f_autoconvert.c; vf_HopperRender.c:663-668).  The rebuild's
engine consumes NV12 or P010; this module converts everything the IO layer
can produce into those, so sources never need to care.

Conversions are vectorized numpy; the colorspace transform for RGB
sources uses BT.709 limited range.
"""

from __future__ import annotations

import numpy as np

from mpv_frame_interpolator_tpu_torch.frame import (
    FrameFormat, VideoFrame, NV12, P010, interleave_chroma)


def i420_to_frame(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  pixfmt: str = NV12, pts: float = 0.0,
                  nominal_fps: float = 0.0) -> VideoFrame:
    """Planar I420 (or I420-16) planes -> NV12/P010 VideoFrame."""
    h, w = y.shape
    fmt = FrameFormat(w, h, pixfmt)
    if pixfmt == P010 and y.dtype == np.uint8:
        y = (y.astype(np.uint16) << 8)
        u = (u.astype(np.uint16) << 8)
        v = (v.astype(np.uint16) << 8)
    elif pixfmt == NV12 and y.dtype == np.uint16:
        y, u, v = (y >> 8).astype(np.uint8), (u >> 8).astype(np.uint8), \
            (v >> 8).astype(np.uint8)
    return VideoFrame(np.ascontiguousarray(y), interleave_chroma(u, v), fmt,
                      pts=pts, nominal_fps=nominal_fps)


def convert_frame(frame: VideoFrame, pixfmt: str) -> VideoFrame:
    """NV12 <-> P010 bit-depth conversion (8-bit payload <<8 / >>8)."""
    if frame.fmt.pixfmt == pixfmt:
        return frame
    if pixfmt == P010:
        y = (frame.y.astype(np.uint16) << 8)
        uv = (frame.uv.astype(np.uint16) << 8)
    else:
        y = (frame.y >> 8).astype(np.uint8)
        uv = (frame.uv >> 8).astype(np.uint8)
    fmt = FrameFormat(frame.fmt.width, frame.fmt.height, pixfmt,
                      frame.fmt.stride)
    return VideoFrame(y, uv, fmt, frame.pts, frame.nominal_fps)


# BT.709 limited-range RGB -> YUV (video/csputils.c territory in the
# reference; only the one matrix the synthetic/test path needs)
_KR, _KB = 0.2126, 0.0722
_KG = 1.0 - _KR - _KB


def rgb_to_frame(rgb: np.ndarray, pixfmt: str = NV12, pts: float = 0.0,
                 nominal_fps: float = 0.0) -> VideoFrame:
    """(H, W, 3) uint8 RGB -> 4:2:0 NV12/P010 frame (BT.709 limited)."""
    h, w, _ = rgb.shape
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = _KR * r + _KG * g + _KB * b
    cb = (b - y) / (2.0 * (1.0 - _KB))
    cr = (r - y) / (2.0 * (1.0 - _KR))
    y8 = np.clip(16.0 + y * (219.0 / 255.0), 0, 255).astype(np.uint8)
    cb8 = np.clip(128.0 + cb * (224.0 / 255.0), 0, 255)
    cr8 = np.clip(128.0 + cr * (224.0 / 255.0), 0, 255)
    # 2x2 box subsample chroma
    u = ((cb8[0::2, 0::2] + cb8[0::2, 1::2] + cb8[1::2, 0::2]
          + cb8[1::2, 1::2]) / 4.0).astype(np.uint8)
    v = ((cr8[0::2, 0::2] + cr8[0::2, 1::2] + cr8[1::2, 0::2]
          + cr8[1::2, 1::2]) / 4.0).astype(np.uint8)
    return i420_to_frame(y8, u, v, pixfmt, pts, nominal_fps)


def frame_to_rgb(frame: VideoFrame) -> np.ndarray:
    """4:2:0 NV12/P010 frame -> (H, W, 3) uint8 RGB (BT.709 limited) --
    the screenshot conversion (player/screenshot.c uses swscale for
    this).  Chroma is nearest-doubled (the inverse of rgb_to_frame's box
    subsample is unrecoverable; nearest matches what the engine's own
    warp addressing assumes for 4:2:0)."""
    w = frame.fmt.width
    if frame.fmt.pixfmt == P010:
        y = (frame.y[:, :w] >> 8).astype(np.float32)
        uv = (frame.uv[:, :w] >> 8).astype(np.float32)
    else:
        y = frame.y[:, :w].astype(np.float32)
        uv = frame.uv[:, :w].astype(np.float32)
    cb = np.repeat(np.repeat(uv[:, 0::2], 2, axis=0), 2, axis=1)
    cr = np.repeat(np.repeat(uv[:, 1::2], 2, axis=0), 2, axis=1)
    h = frame.fmt.height
    cb, cr = cb[:h, :w], cr[:h, :w]
    yl = (y - 16.0) * (255.0 / 219.0)
    pb = (cb - 128.0) * (255.0 / 224.0)
    pr = (cr - 128.0) * (255.0 / 224.0)
    r = yl + 2.0 * (1.0 - _KR) * pr
    b = yl + 2.0 * (1.0 - _KB) * pb
    g = (yl - _KR * r - _KB * b) / _KG
    return np.clip(np.stack([r, g, b], axis=-1) + 0.5,
                   0, 255).astype(np.uint8)


def autoconvert(frame: VideoFrame, want_pixfmt: str,
                want_width: int = 0, want_height: int = 0) -> VideoFrame:
    """Entry point matching mp_autoconvert semantics: return the frame
    unchanged if already acceptable, else convert -- bit depth
    (NV12<->P010) and, when a target geometry is given, a bilinear
    rescale (the swscale scaling leg of f_autoconvert)."""
    if want_width or want_height:
        w = want_width or frame.fmt.width
        h = want_height or frame.fmt.height
        if (w, h) != (frame.fmt.width, frame.fmt.height):
            from mpv_frame_interpolator_tpu_torch.io.filters import scale
            frame = scale(w, h)(frame)
    return convert_frame(frame, want_pixfmt)
