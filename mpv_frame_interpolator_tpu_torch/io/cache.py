"""Seekable frame cache over unseekable sources (demuxer-cache analog).

mpv's demuxer buffers demuxed packets in memory/disk and services seeks
inside the cached range without touching the underlying stream
(demux/demux.c cache + --cache-on-disk).  The rebuild's sources are
frame-granular, so the cache spools decoded frames to a temp file:

* reading from a pipe/stdin tees every frame into the spool;
* backward seeks replay from the spool in O(1) per frame;
* forward seeks consume (and spool) the live stream up to the target;
* an optional frame budget prunes the oldest spooled frames, like the
  demuxer cache's back-buffer limit (--demuxer-max-back-bytes).

The spool stores raw plane bytes at fixed offsets per frame (geometry is
constant per stream), so replay is a pread + frombuffer, no re-decode.
"""

from __future__ import annotations

import tempfile
from typing import Iterator, Optional

import numpy as np

from mpv_frame_interpolator_tpu_torch.frame import VideoFrame
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("cache")


class CachedSource:
    """Wraps any VideoFrame iterable; provides seek_pts/seekable."""

    def __init__(self, source, spool_dir: Optional[str] = None,
                 max_frames: int = 0):
        self._source = iter(source)
        self._spool = tempfile.TemporaryFile(dir=spool_dir)
        self._index = []        # (byte offset, pts, nominal_fps)
        self._first = 0         # oldest replayable index (after pruning)
        self._pos = 0           # next frame to serve
        self._fmt = None
        self._end = 0           # spool write offset
        self.max_frames = max_frames
        self.spool_hits = 0

    # -- spool ------------------------------------------------------------

    def _append(self, frame: VideoFrame):
        if self._fmt is None:
            self._fmt = frame.fmt
        self._spool.seek(self._end)
        y = np.ascontiguousarray(frame.y)
        uv = np.ascontiguousarray(frame.uv)
        self._spool.write(y)
        self._spool.write(uv)
        self._index.append((self._end, frame.pts, frame.nominal_fps))
        self._end += y.nbytes + uv.nbytes
        if (self.max_frames
                and len(self._index) - self._first > self.max_frames):
            self._first += 1    # prune oldest (offsets stay valid)

    def _read(self, i: int) -> VideoFrame:
        off, pts, fps = self._index[i]
        fmt = self._fmt
        ysz = fmt.height * fmt.stride * fmt.dtype().itemsize
        csz = (fmt.height // 2) * fmt.stride * fmt.dtype().itemsize
        self._spool.seek(off)
        data = self._spool.read(ysz + csz)
        y = np.frombuffer(data, fmt.dtype, fmt.height * fmt.stride
                          ).reshape(fmt.height, fmt.stride)
        uv = np.frombuffer(data, fmt.dtype, (fmt.height // 2) * fmt.stride,
                           ysz).reshape(fmt.height // 2, fmt.stride)
        self.spool_hits += 1
        return VideoFrame(y, uv, fmt, pts=pts, nominal_fps=fps)

    def _pull(self) -> Optional[VideoFrame]:
        frame = next(self._source, None)
        if frame is None:
            return None
        self._append(frame)
        # the spool owns a copy; the source may recycle its buffers after
        # the consumer is done with this frame (hook left intact)
        return frame

    # -- iteration / seeking ----------------------------------------------

    def __iter__(self) -> Iterator[VideoFrame]:
        while True:
            if self._pos < len(self._index):
                if self._pos < self._first:
                    self._pos = self._first   # pruned away; resume at edge
                frame = self._read(self._pos)
            else:
                frame = self._pull()
                if frame is None:
                    return
            self._pos += 1
            yield frame

    def seekable(self) -> bool:
        return True

    def n_frames(self) -> int:
        """Total frame count; drains the live stream into the spool first
        (an unseekable stream's length is unknowable without reading it --
        same cost mpv's backward-play cache pays)."""
        while self._pull() is not None:
            pass
        return len(self._index)

    def seek_frame(self, n: int):
        while len(self._index) <= n:
            if self._pull() is None:
                break
        self._pos = min(max(int(n), self._first),
                        max(len(self._index) - 1, 0))

    def seek_pts(self, pts: float) -> float:
        """Seek inside the cached range (replay) or forward (consume)."""
        # forward: consume the live stream until the target is cached
        while not self._index or self._index[-1][1] < pts - 1e-9:
            if self._pull() is None:
                break
        # binary search the last frame with pts <= target
        lo, hi = self._first, len(self._index)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._index[mid][1] <= pts + 1e-9:
                lo = mid + 1
            else:
                hi = mid
        self._pos = max(lo - 1, self._first)
        return self._index[self._pos][1] if self._index else 0.0

    def close(self):
        self._spool.close()
