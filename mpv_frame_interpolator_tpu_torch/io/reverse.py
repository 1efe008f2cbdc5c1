"""Backward playback: chunked reverse reading of a seekable source.

The reference plays backwards by seeking the demuxer back one keyframe
range at a time, decoding FORWARD through each range into a buffer, and
emitting the buffered frames in reverse (demux.c backward-play cache +
`--play-direction=backward`; the decode direction can never be reversed).
This adapter is that exact shape on this framework's sources: seek back
one chunk, read the chunk forward, emit it reversed.

PTS handling: emitted timestamps must be a fresh monotonically INCREASING
timeline (the cadence engine, like mpv's playloop, always sees forward
time -- mpv likewise re-derives backward pts rather than feeding negative
time into the player, player/video.c).  Frame j of the reversed stream
(source frame n-1-j) gets

    pts_out = last_pts - pts_orig

which mirrors the source's own intervals (VFR gaps reverse with the
content, as they should: the gap BEFORE a source frame becomes the gap
AFTER its reversed twin).

Memory: one chunk of decoded frames is held at a time (chunk * frame_size
host bytes; 8 * 4K NV12 ~= 100 MB), the mpv `--video-reversal-buffer`
analog.  Native ring sources grow their buffer pool by up to one chunk
(ingest._grow_if_starved) and recycle as the consumer drains.

Unseekable inputs (pipes/sockets) gain backward play by spooling through
io.cache.CachedSource first, exactly like mpv's cache-backed backward
play -- the CLI wires this automatically for `--play-direction=backward`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from mpv_frame_interpolator_tpu_torch.frame import VideoFrame
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("reverse")


class ReverseError(ValueError):
    pass


class ReversedSource:
    """Iterate a seekable source's frames last-to-first on a fresh
    forward pts timeline.  Requires seekable() + n_frames() +
    seek_frame() (all file sources and CachedSource provide them)."""

    def __init__(self, source, chunk: int = 8):
        need = ("seekable", "n_frames", "seek_frame")
        if not all(hasattr(source, a) for a in need) or not source.seekable():
            raise ReverseError(
                "backward playback needs a seekable, frame-indexable "
                "source; wrap pipes in io.cache.CachedSource first")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self._src = source
        self._chunk = chunk
        # passthrough geometry/format surface (Pipeline reads these)
        for attr in ("width", "height", "fps", "fmt", "pixfmt"):
            if hasattr(source, attr):
                setattr(self, attr, getattr(source, attr))

    def seekable(self) -> bool:
        # seek-on-reversed-timeline is not implemented (mpv also rebuilds
        # its backward state on seek); CLI --start composes by seeking the
        # underlying source before wrapping
        return False

    def _read_chunk(self, begin: int, count: int):
        self._src.seek_frame(begin)
        out = []
        it = iter(self._src)
        for _ in range(count):
            f = next(it, None)
            if f is None:
                break
            out.append(f)
        return out

    def __iter__(self) -> Iterator[VideoFrame]:
        n = self._src.n_frames()
        if n == 0:
            return
        # pts of the LAST frame anchors the reversed timeline; read it
        # once (O(1) -- one seek + one frame)
        tail = self._read_chunk(n - 1, 1)
        if not tail:
            return
        last_pts = tail[0].pts
        if tail[0].recycle:
            tail[0].recycle()
        for end in range(n, 0, -self._chunk):
            begin = max(end - self._chunk, 0)
            buf = self._read_chunk(begin, end - begin)
            for f in reversed(buf):
                yield dataclasses.replace(f, pts=last_pts - f.pts)

    def close(self):
        if hasattr(self._src, "close"):
            self._src.close()
