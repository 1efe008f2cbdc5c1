"""YUV4MPEG2 (.y4m) reader and writer and the raw I420 reader (the port's
copy of the JAX package's ``io/y4m.py``: NV12 and 10-bit P010; the
reader seeks in O(1) and reads into pooled, page-locked buffers).

y4m (ffmpeg's ``-f yuv4mpegpipe``) carries planar 4:2:0; frames become
biplanar NV12/P010 ``VideoFrame``s on the way in and planar again on the
way out.  10-bit streams (``C420p10``) hold the value in the low 10 bits
of each 16-bit word; P010 holds it in the top bits (<< 6).
"""

from __future__ import annotations

from typing import BinaryIO, Iterator, Optional

import numpy as np

from mpv_frame_interpolator_tpu_torch.frame import (
    NV12, P010, FrameFormat, VideoFrame, interleave_chroma)
from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool


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
    """Seekable y4m demuxer -> VideoFrame (NV12 or P010 planes).

    Frames are read into buffers from `pool` (a ``PinnedPool``, page-locked
    where the frames go to a card: `device`, None for "a card if there is
    one"); each frame carries a ``recycle`` hook that hands its buffers
    back, which the engine's upload calls once its copy of them has
    completed.  A frame never recycled costs a fresh allocation, never a
    corrupted frame.  Odd sizes are cropped to even (the cropped planes
    are copies and carry no hook)."""

    def __init__(self, fh: BinaryIO, start_pts: float = 0.0, pool=None,
                 device=None):
        self._fh = fh
        header = fh.readline(4096).decode("ascii", "replace").strip()
        self.width, self.height, self.fps, self.pixfmt = parse_header(header)
        self.pool = pool if pool is not None else PinnedPool(8, device)
        self._scratch = None
        # 4:2:0 y4m streams always carry even dimensions, but be defensive:
        # crop odd sizes down (the engine requires even geometry)
        self._crop_w = self.width & ~1
        self._crop_h = self.height & ~1
        self.fmt = FrameFormat(self._crop_w, self._crop_h, self.pixfmt)
        self._pts = start_pts
        self._start_pts = start_pts
        self._dt = 1.0 / self.fps if self.fps > 0 else 1.0 / 24.0
        # seek support (demux_seek analog): y4m frames are fixed-size
        # records after the stream header, so frame n lives at a computable
        # byte offset
        itemsize = np.dtype(self.fmt.dtype).itemsize
        self._payload = (self.width * self.height + 2 * (self.width // 2)
                         * (self.height // 2)) * itemsize
        self._marker_len: Optional[int] = None
        try:
            self._data_start = fh.tell()
            self._seekable = bool(fh.seekable())
        except (OSError, AttributeError):
            self._data_start = 0
            self._seekable = False

    # -- seeking ----------------------------------------------------------

    def seekable(self) -> bool:
        return self._seekable

    def _ensure_marker_len(self):
        """Learn the FRAME marker line length from the first frame (markers
        may carry parameters; virtually all streams use a constant line)."""
        if self._marker_len is not None:
            return
        pos = self._fh.tell()
        self._fh.seek(self._data_start)
        line = self._fh.readline()
        if not line.startswith(b"FRAME"):
            raise Y4MError(f"bad frame marker at stream start: {line[:20]!r}")
        self._marker_len = len(line)
        self._fh.seek(pos)

    def n_frames(self) -> int:
        """Total frame count (only for seekable streams)."""
        if not self._seekable:
            raise Y4MError("stream is not seekable")
        self._ensure_marker_len()
        pos = self._fh.tell()
        end = self._fh.seek(0, 2)
        self._fh.seek(pos)
        rec = self._marker_len + self._payload
        return max((end - self._data_start) // rec, 0)

    def seek_frame(self, n: int):
        """O(1) byte seek to frame n (falls back to a linear marker scan if
        the stream uses variable-length FRAME lines)."""
        if not self._seekable:
            raise Y4MError("stream is not seekable")
        self._ensure_marker_len()
        n = max(int(n), 0)
        rec = self._marker_len + self._payload
        target = self._data_start + n * rec
        self._fh.seek(target)
        line = self._fh.readline()
        if line and not line.startswith(b"FRAME"):
            # variable-length markers: scan forward from the data start
            self._fh.seek(self._data_start)
            for _ in range(n):
                marker = self._fh.readline()
                if not marker.startswith(b"FRAME"):
                    break          # seeked past EOF; iteration just ends
                self._fh.seek(self._payload, 1)
        else:
            self._fh.seek(target)
        self._pts = self._start_pts + n * self._dt

    def seek_pts(self, pts: float) -> float:
        """Seek to the frame covering `pts`; returns the actual frame pts."""
        n = int(max(pts - self._start_pts, 0.0) / self._dt + 1e-6)
        self.seek_frame(n)
        return self._pts

    def _read_into(self, arr: np.ndarray) -> bool:
        """Fill `arr` (contiguous) from the stream; False on short read."""
        mv = memoryview(arr).cast("B")
        readinto = getattr(self._fh, "readinto", None)
        if readinto is not None:
            filled = 0
            while filled < len(mv):
                got = readinto(mv[filled:])
                if not got:
                    return False
                filled += got
            return True
        data = self._fh.read(len(mv))
        if len(data) < len(mv):
            return False
        mv[:] = data
        return True

    def __iter__(self) -> Iterator[VideoFrame]:
        w, h = self.width, self.height
        cw, ch = self._crop_w, self._crop_h
        dtype = self.fmt.dtype
        cropped = (cw, ch) != (w, h)
        if self._scratch is None:
            # planar U,V staging, reused every frame
            self._scratch = np.empty((2, h // 2, w // 2), dtype)
        u_s, v_s = self._scratch[0], self._scratch[1]
        pool = self.pool
        while True:
            line = self._fh.readline(4096)
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise Y4MError(f"bad frame marker: {line[:20]!r}")
            y = pool.get((h, w), dtype)
            uv = pool.get((h // 2, w), dtype)
            if not (self._read_into(y) and self._read_into(u_s)
                    and self._read_into(v_s)):
                pool.give_back(y)
                pool.give_back(uv)
                return
            # interleave into the buffer's first 2 * (w // 2) columns (all
            # of them at an even width; an odd one is cropped below)
            uv[:, 0:cw:2] = u_s
            uv[:, 1:cw:2] = v_s
            if self.pixfmt == P010:
                # y4m 420p10 carries 10-bit values; P010 uses the top bits
                np.left_shift(y, 6, out=y)
                np.left_shift(uv, 6, out=uv)

            def recycle(y=y, uv=uv):
                pool.give_back(y)
                pool.give_back(uv)

            if cropped:
                frame = VideoFrame(np.ascontiguousarray(y[:ch, :cw]),
                                   np.ascontiguousarray(uv[:ch // 2, :cw]),
                                   self.fmt, pts=self._pts,
                                   nominal_fps=self.fps)
                recycle()      # the cropped copies own their storage
            else:
                frame = VideoFrame(y, uv, self.fmt, pts=self._pts,
                                   nominal_fps=self.fps, recycle=recycle)
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


class RawYUVReader:
    """Raw planar I420 (8-bit) or I420 10LE reader; geometry supplied by the
    caller (like mpv's demux_raw --demuxer-rawvideo-*)."""

    def __init__(self, fh: BinaryIO, width: int, height: int, fps: float,
                 pixfmt: str = NV12, start_pts: float = 0.0):
        self.fmt = FrameFormat(width, height, pixfmt)
        self._fh = fh
        self.fps = fps
        self._pts = start_pts
        self._start_pts = start_pts
        itemsize = np.dtype(self.fmt.dtype).itemsize
        self._payload = (width * height
                         + 2 * (width // 2) * (height // 2)) * itemsize
        try:
            self._data_start = fh.tell()
            self._seekable = bool(fh.seekable())
        except (OSError, AttributeError):
            self._data_start = 0
            self._seekable = False

    def seekable(self) -> bool:
        return self._seekable

    def n_frames(self) -> int:
        if not self._seekable:
            raise ValueError("stream is not seekable")
        pos = self._fh.tell()
        end = self._fh.seek(0, 2)
        self._fh.seek(pos)
        return max((end - self._data_start) // self._payload, 0)

    def seek_frame(self, n: int):
        """O(1) byte seek (raw streams are pure fixed-size records)."""
        if not self._seekable:
            raise ValueError("stream is not seekable")
        n = max(int(n), 0)
        self._fh.seek(self._data_start + n * self._payload)
        self._pts = self._start_pts + n / self.fps

    def seek_pts(self, pts: float) -> float:
        n = int(max(pts - self._start_pts, 0.0) * self.fps + 1e-6)
        self.seek_frame(n)
        return self._pts

    def __iter__(self) -> Iterator[VideoFrame]:
        w, h = self.fmt.width, self.fmt.height
        dtype = self.fmt.dtype
        itemsize = np.dtype(dtype).itemsize
        ysz, csz = w * h * itemsize, (w // 2) * (h // 2) * itemsize
        while True:
            buf = self._fh.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                return
            y = np.frombuffer(buf, dtype, w * h, 0).reshape(h, w)
            u = np.frombuffer(buf, dtype, (w // 2) * (h // 2),
                              ysz).reshape(h // 2, w // 2)
            v = np.frombuffer(buf, dtype, (w // 2) * (h // 2),
                              ysz + csz).reshape(h // 2, w // 2)
            if self.fmt.pixfmt == P010:
                y, u, v = y << 6, u << 6, v << 6
            yield VideoFrame(np.ascontiguousarray(y), interleave_chroma(u, v),
                             self.fmt, pts=self._pts, nominal_fps=self.fps)
            self._pts += 1.0 / self.fps


def open_source(path: str, **kw):
    """Open a .y4m path as a seekable ``Y4MReader`` (keyword arguments go
    to the reader).  The port reads no other container."""
    if not path.endswith(".y4m"):
        raise Y4MError(f"{path!r}: the port reads .y4m files only")
    return Y4MReader(open(path, "rb"), **kw)
