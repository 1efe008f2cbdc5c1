"""YUV4MPEG2 (.y4m) reader and writer (the port's copy of the JAX
package's ``io/y4m.py``: NV12 and 10-bit P010, numpy only).

y4m (ffmpeg's ``-f yuv4mpegpipe``) carries planar 4:2:0; frames become
biplanar NV12/P010 ``VideoFrame``s on the way in and planar again on the
way out.  10-bit streams (``C420p10``) hold the value in the low 10 bits
of each 16-bit word; P010 holds it in the top bits (<< 6).
"""

from __future__ import annotations

from typing import BinaryIO, Iterator

import numpy as np

from mpv_frame_interpolator_tpu_torch.frame import (
    NV12, P010, FrameFormat, VideoFrame, interleave_chroma)


class Y4MError(ValueError):
    pass


_COLORSPACE_8 = {"420", "420jpeg", "420mpeg2", "420paldv"}
_COLORSPACE_10 = {"420p10"}

# sanity caps: a hostile header must not become an allocation bomb or a
# numeric blow-up
MAX_DIMENSION = 16384
MAX_PIXELS = 1 << 27     # ~134 MP, comfortably past 16K video
MAX_FPS = 100000.0


def _parse_ratio(s: str) -> float:
    num, den = s.split(":")
    den = int(den)
    return int(num) / den if den else 0.0


def parse_header(header: str):
    """Parse a YUV4MPEG2 stream header line.

    Returns (width, height, fps, pixfmt).  Raises Y4MError on anything
    malformed, out of range, or outside the supported 4:2:0 colorspaces.
    """
    if not header.startswith("YUV4MPEG2"):
        raise Y4MError("not a YUV4MPEG2 stream")
    width = height = 0
    fps = 0.0
    cs = "420mpeg2"
    for tok in header.split()[1:]:
        key, val = tok[0], tok[1:]
        try:
            if key == "W":
                width = int(val)
            elif key == "H":
                height = int(val)
            elif key == "F":
                fps = _parse_ratio(val)
            elif key == "C":
                cs = val
        except (ValueError, ZeroDivisionError) as e:
            raise Y4MError(f"bad header token {tok!r}: {e}") from None
    if not (0 < width <= MAX_DIMENSION and 0 < height <= MAX_DIMENSION
            and width * height <= MAX_PIXELS):
        raise Y4MError(f"bad dimensions in header: {header!r}")
    if not (0.0 <= fps <= MAX_FPS) or fps != fps:
        raise Y4MError(f"bad frame rate in header: {header!r}")
    if cs in _COLORSPACE_8:
        pixfmt = NV12
    elif cs in _COLORSPACE_10:
        pixfmt = P010
    else:
        raise Y4MError(f"unsupported colorspace C{cs} (need 4:2:0)")
    return width, height, fps, pixfmt


class Y4MReader:
    """Streaming y4m demuxer -> VideoFrame (NV12 or P010 planes), one
    fresh allocation per frame."""

    def __init__(self, fh: BinaryIO, start_pts: float = 0.0):
        self._fh = fh
        header = fh.readline(4096).decode("ascii", "replace").strip()
        self.width, self.height, self.fps, self.pixfmt = parse_header(header)
        # 4:2:0 y4m streams always carry even dimensions, but be defensive:
        # crop odd sizes down (the engine requires even geometry)
        self._crop_w = self.width & ~1
        self._crop_h = self.height & ~1
        self.fmt = FrameFormat(self._crop_w, self._crop_h, self.pixfmt)
        self._pts = start_pts
        self._dt = 1.0 / self.fps if self.fps > 0 else 1.0 / 24.0

    def _read(self, shape, dtype):
        """One plane from the stream, or None on a short read."""
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        data = self._fh.read(n)
        if len(data) < n:
            return None
        return np.frombuffer(data, dtype).reshape(shape)

    def __iter__(self) -> Iterator[VideoFrame]:
        w, h = self.width, self.height
        cw, ch = self._crop_w, self._crop_h
        dtype = self.fmt.dtype
        while True:
            line = self._fh.readline(4096)
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise Y4MError(f"bad frame marker: {line[:20]!r}")
            y = self._read((h, w), dtype)
            u = self._read((h // 2, w // 2), dtype) if y is not None else None
            v = self._read((h // 2, w // 2), dtype) if u is not None else None
            if v is None:
                return
            uv = interleave_chroma(u, v)
            y = y.copy()
            if self.pixfmt == P010:
                # y4m 420p10 carries 10-bit values; P010 uses the top bits
                np.left_shift(y, 6, out=y)
                np.left_shift(uv, 6, out=uv)
            frame = VideoFrame(np.ascontiguousarray(y[:ch, :cw]),
                               np.ascontiguousarray(uv[:ch // 2, :cw]),
                               self.fmt, pts=self._pts, nominal_fps=self.fps)
            self._pts += self._dt
            yield frame


class Y4MWriter:
    """VideoFrame -> y4m stream (planar I420 / I420p10)."""

    def __init__(self, fh: BinaryIO, width: int, height: int, fps: float,
                 pixfmt: str = NV12):
        self._fh = fh
        self.pixfmt = pixfmt
        if abs(fps - round(fps)) < 1e-9:
            ratio = f"{int(round(fps))}:1"
        else:
            num = int(round(fps * 1001))
            if abs(num / 1001 - fps) < 1e-6:
                ratio = f"{num}:1001"      # NTSC rates (23.976, 29.97, ...)
            else:
                ratio = f"{int(round(fps * 1000))}:1000"
        cs = "C420mpeg2" if pixfmt == NV12 else "C420p10"
        fh.write(f"YUV4MPEG2 W{width} H{height} F{ratio} Ip A1:1 {cs}\n"
                 .encode("ascii"))

    def write(self, frame: VideoFrame):
        self._fh.write(b"FRAME\n")
        w = frame.fmt.width
        y = frame.y[:, :w]
        u = frame.uv[:, 0:w:2]
        v = frame.uv[:, 1:w:2]
        if self.pixfmt == P010:
            y, u, v = y >> 6, u >> 6, v >> 6
        for plane in (y, u, v):
            self._fh.write(np.ascontiguousarray(plane))

    def close(self):
        self._fh.flush()
