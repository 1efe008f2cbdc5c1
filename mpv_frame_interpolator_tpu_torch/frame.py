"""Frame containers: NV12 (8-bit) and P010 (10-bit) biplanar YUV 4:2:0.

The port's own copy of the JAX package's ``frame.py``: the same names and
semantics, numpy only.  Host frames are numpy arrays; the engine copies
them to the card (``convert.frame_to_device``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

# Pixel formats (reference: video/img_format.h:235 IMGFMT_NV12, :237
# IMGFMT_P010)
NV12 = "nv12"
P010 = "p010"

_DTYPES = {NV12: np.uint8, P010: np.uint16}


@dataclasses.dataclass(frozen=True)
class FrameFormat:
    """Geometry + sample format of a biplanar 4:2:0 frame.

    ``stride`` is the luma row length in samples (not bytes); the chroma plane
    shares it (interleaved U,V pairs at half vertical resolution).  The
    encoded width may be narrower than the stride (the reference's
    frameWidth/actualWidth distinction).
    """

    width: int                 # encoded ("actual") width in pixels
    height: int                # frame height in pixels (must be even)
    pixfmt: str = NV12         # NV12 | P010
    stride: Optional[int] = None  # luma samples per row; None -> width
    # colorimetry tags, passed through untouched (the interpolator itself
    # is colorspace-agnostic).  HDR10 content is typically
    # primaries=bt.2020 transfer=pq.
    primaries: str = "bt.709"
    transfer: str = "bt.1886"
    matrix: str = "bt.709"

    def __post_init__(self):
        if self.pixfmt not in _DTYPES:
            raise ValueError(f"unsupported pixfmt {self.pixfmt!r}")
        if self.height % 2 or self.width % 2:
            raise ValueError("4:2:0 requires even dimensions")
        if self.stride is None:
            object.__setattr__(self, "stride", self.width)
        if self.stride < self.width:
            raise ValueError("stride must be >= width")

    @property
    def dtype(self):
        return _DTYPES[self.pixfmt]

    @property
    def bit_depth(self) -> int:
        return 8 if self.pixfmt == NV12 else 10

    @property
    def max_value(self) -> int:
        # P010 carries its 10-bit payload in the top bits of 16-bit words
        return 255 if self.pixfmt == NV12 else 65535

    def luma_shape(self):
        return (self.height, self.stride)

    def chroma_shape(self):
        return (self.height // 2, self.stride)


@dataclasses.dataclass
class VideoFrame:
    """One decoded frame: luma plane, interleaved-chroma plane, timing."""

    y: np.ndarray              # (H, stride) uint8|uint16
    uv: np.ndarray             # (H//2, stride) interleaved U,V
    fmt: FrameFormat
    pts: float = 0.0           # presentation timestamp, seconds
    nominal_fps: float = 0.0   # container/decoder frame rate (0 = unknown)
    # buffer-recycling hook: when set, the consumer that copies the planes
    # off-host (engine.stage) calls it once the copy is complete so the
    # source can reuse the buffers.  The planes MUST NOT be touched after.
    recycle: Optional[Callable[[], None]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.y.shape != self.fmt.luma_shape() \
                or self.uv.shape != self.fmt.chroma_shape():
            raise ValueError(f"planes {self.y.shape}/{self.uv.shape} do not "
                             f"match {self.fmt}")
        if self.y.dtype != self.fmt.dtype or self.uv.dtype != self.fmt.dtype:
            raise ValueError(f"planes are {self.y.dtype}/{self.uv.dtype}, "
                             f"{self.fmt.pixfmt} needs {self.fmt.dtype}")

    def with_pts(self, pts: float) -> "VideoFrame":
        return VideoFrame(self.y, self.uv, self.fmt, pts, self.nominal_fps)

    def copy(self) -> "VideoFrame":
        """A frame that owns copies of the planes (no recycle hook)."""
        return VideoFrame(self.y.copy(), self.uv.copy(), self.fmt, self.pts,
                          self.nominal_fps)


def split_chroma(uv: np.ndarray):
    """NV12 interleaved UV -> planar (u, v), each (H/2, stride/2)."""
    return uv[:, 0::2], uv[:, 1::2]


def interleave_chroma(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Planar (u, v) -> NV12 interleaved UV plane."""
    uv = np.empty((u.shape[0], u.shape[1] * 2), u.dtype)
    uv[:, 0::2] = u
    uv[:, 1::2] = v
    return uv


def psnr(a: VideoFrame, b: VideoFrame, plane: str = "y") -> float:
    """PSNR between two frames' planes (over the encoded width only)."""
    if a.fmt.pixfmt != b.fmt.pixfmt:
        raise ValueError(f"psnr of a {a.fmt.pixfmt} and a {b.fmt.pixfmt} "
                         "frame")
    w = min(a.fmt.width, b.fmt.width)
    if plane == "y":
        pa, pb = a.y[:, :w], b.y[:, :w]
    else:
        pa, pb = a.uv[:, :w], b.uv[:, :w]
    return psnr_arrays(pa, pb, a.fmt.max_value)


def psnr_arrays(pa: np.ndarray, pb: np.ndarray, peak: float) -> float:
    mse = np.mean((pa.astype(np.float64) - pb.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
