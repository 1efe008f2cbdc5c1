"""Native streaming ingest: a C++ reader thread filling recycled frame
buffers (the port's copy of the JAX package's ``io/ingest.py``).

* ``_mfi_native.Y4MRing`` runs a C++ reader thread (no GIL) that reads
  each y4m FRAME record straight into a registered luma buffer and
  repacks the planar U,V planes into the interleaved NV12/P010 chroma
  buffer -- read and repack are fused, and the P010 << 6 shift rides the
  same pass.  ``_mfi_native.IndexedRing`` does the same from a
  container's frame-offset index (raw MKV, MP4 and AVI video), one pread
  a frame.
* A set of frame buffers rotates between Python and the ring: the
  iterator yields a filled frame; its ``recycle`` hook re-registers the
  buffers (a frame never recycled frees them).  The buffers come from a ``PinnedPool``: page-locked where the
  frames go to a card, so the engine's uploads from them are DMA copies
  that do not block.  The engine's upload (``convert.frame_to_device``)
  calls the hook only once its copy of the planes has completed: before
  then the ring must not write into them.
* Backpressure is natural: the C++ thread blocks when every buffer is in
  flight; a consumer that holds every buffer gets one more pair instead
  of a deadlock.

The ring is the port's own native library (``native/``, built at first
use); a failed build raises.  The Python readers (``io/y4m.py`` and the
container readers with ``use_native=False``) run where the caller asks
for them (``--ingest python``).
"""

from __future__ import annotations

import bisect
import os
import threading
from typing import Iterator

import numpy as np

from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.frame import (
    P010, FrameFormat, VideoFrame)
from mpv_frame_interpolator_tpu_torch.io import y4m as y4m_mod
from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("ingest")


class _Ring:
    """The buffer bookkeeping both ring sources share.  The ring owns the
    buffer pairs registered with it (free or filled); a popped pair is
    owned by its frame alone, so a frame never recycled frees its
    buffers with it (a page-locked pair goes back to PyTorch's host
    cache, which the next new pair reuses).  The recycle hook may fire
    on another thread than the iterator (the prefetch thread's upload,
    the consumer's drop), hence the lock."""

    def _init_slots(self, ring_depth: int, pool, device):
        self._pool = pool if pool is not None else PinnedPool(
            2 * ring_depth, device)
        self._ring_depth = ring_depth
        self._pairs = {}           # tag -> (y, uv) registered with the ring
        self._outstanding = set()  # tags a consumer holds
        self._tags = 0             # tags handed out so far
        self._recycled = 0
        self._lock = threading.RLock()
        self._ring = None

    def _new_pair(self):
        """A new buffer pair under a new tag, registered with the ring."""
        y = self._pool.get((self.height, self.width), self._dtype)
        uv = self._pool.get((self.height // 2, self.width), self._dtype)
        tag = self._tags
        self._tags += 1
        self._pairs[tag] = (y, uv)
        self._ring.push_free(tag, y, uv)

    def _register_free(self):
        """Hand a (new) ring every pair no consumer holds, topped up to
        the ring depth."""
        with self._lock:
            for tag, (y, uv) in self._pairs.items():
                self._ring.push_free(tag, y, uv)
            while len(self._pairs) < self._ring_depth:
                self._new_pair()

    def _recycle(self, tag: int, y, uv):
        with self._lock:
            if tag not in self._outstanding:
                return
            self._outstanding.discard(tag)
            self._recycled += 1
            try:
                self._ring.push_free(tag, y, uv)
            except RuntimeError:
                return        # ring stopped mid-recycle (teardown)
            self._pairs[tag] = (y, uv)

    def _next_frame(self, pts_of):
        """The next filled pair as a frame (None at the end), with a new
        pair first when consumers hold every one (mp_image_pool
        semantics: never deadlock the reader thread).  `pts_of()` gives
        the frame's pts."""
        with self._lock:
            if not self._pairs:
                self._new_pair()
        tag = self._ring.pop()
        if tag is None:
            return None
        with self._lock:
            y, uv = self._pairs.pop(tag)
            self._outstanding.add(tag)
        return VideoFrame(y, uv, self.fmt, pts=pts_of(),
                          nominal_fps=self.fps,
                          recycle=lambda: self._recycle(tag, y, uv))

    def stats(self) -> dict:
        s = self._ring.stats()
        with self._lock:
            s["recycled"] = self._recycled
            s["outstanding"] = len(self._outstanding)
            s["pairs"] = self._tags
        s["pinned"] = self._pool.pinned
        return s


class NativeY4MSource(_Ring):
    """Seekable y4m source backed by the C++ reader ring.

    Iterates VideoFrames whose buffers are recycled via ``frame.recycle``;
    a frame's planes are valid until that hook is called.  `pool`: where
    the ring's buffers come from (default a ``PinnedPool`` for `device`,
    None for "a card if there is one")."""

    def __init__(self, path, ring_depth: int = 4, start_pts: float = 0.0,
                 pool=None, device=None):
        """`path` is a filesystem path, or an unbuffered binary file
        object / raw fd for pipe ingest (stdin): the C++ ring reads any
        fd; only byte-seeking needs a real file."""
        self._native = native.load()
        if isinstance(path, str):
            self._fh = open(path, "rb", buffering=0)
        elif isinstance(path, int):
            self._fh = os.fdopen(path, "rb", buffering=0, closefd=False)
        else:
            self._fh = path           # unbuffered binary file object
        try:
            header = self._read_line()
            (self.width, self.height, self.fps,
             self.pixfmt) = y4m_mod.parse_header(
                header.decode("ascii", "replace").strip())
            if self.width % 2 or self.height % 2:
                raise y4m_mod.Y4MError(
                    "native ingest requires even dimensions; "
                    "use the Python reader for odd-sized streams")
        except y4m_mod.Y4MError:
            if isinstance(path, str):
                self._fh.close()
            raise
        self.fmt = FrameFormat(self.width, self.height, self.pixfmt)
        self._dtype = self.fmt.dtype
        self._itemsize = np.dtype(self._dtype).itemsize
        self._shift = 6 if self.pixfmt == P010 else 0
        self._dt = 1.0 / self.fps if self.fps > 0 else 1.0 / 24.0
        self._start_pts = start_pts
        self._frame_index = 0
        self._payload = (self.width * self.height
                         + 2 * (self.width // 2) * (self.height // 2)
                         ) * self._itemsize
        # learn the FRAME marker length for O(1) seeks (constant-marker
        # streams; every common producer emits a fixed line).  Pipes
        # cannot rewind: they stream fine but report seekable()=False.
        self._marker_len = 0
        try:
            self._data_start = self._fh.tell()
            if self._fh.seekable():
                marker = self._read_line()
                if marker.startswith(b"FRAME"):
                    self._marker_len = len(marker)
                self._fh.seek(self._data_start)
        except OSError:
            self._data_start = -1
        self._init_slots(ring_depth, pool, device)
        self._open_ring()

    def _read_line(self) -> bytes:
        out = bytearray()
        while True:
            b = self._fh.read(1)
            if not b:
                break
            out += b
            if b == b"\n" or len(out) > 4096:
                break
        return bytes(out)

    def _open_ring(self):
        self._ring = self._native.Y4MRing(self._fh.fileno(), self.width,
                                          self.height, self._itemsize,
                                          self._shift)
        self._register_free()

    def _next_pts(self) -> float:
        pts = self._start_pts + self._frame_index * self._dt
        self._frame_index += 1
        return pts

    def __iter__(self) -> Iterator[VideoFrame]:
        while True:
            frame = self._next_frame(self._next_pts)
            if frame is None:
                return
            yield frame

    # -- seek (O(1) byte repositioning) -----------------------------------

    def seekable(self) -> bool:
        return self._marker_len > 0

    def n_frames(self) -> int:
        end = os.fstat(self._fh.fileno()).st_size
        rec = self._marker_len + self._payload
        return max((end - self._data_start) // rec, 0)

    def seek_frame(self, n: int):
        if not self.seekable():
            raise y4m_mod.Y4MError("stream is not seekable")
        n = max(int(n), 0)
        # under the lock, so that a frame recycled meanwhile goes to the
        # new ring; the frames a consumer holds go there when recycled
        with self._lock:
            self._ring.stop()
            rec = self._marker_len + self._payload
            self._fh.seek(self._data_start + n * rec)
            self._frame_index = n
            self._open_ring()

    def seek_pts(self, pts: float) -> float:
        n = int(max(pts - self._start_pts, 0.0) / self._dt + 1e-6)
        self.seek_frame(n)
        return self._start_pts + n * self._dt

    def close(self):
        if self._ring is not None:
            self._ring.stop()
        self._fh.close()


class NativeIndexedSource(_Ring):
    """Container-indexed native ingest: raw (I420/NV12) MKV, MP4 or AVI
    video streamed by the C++ IndexedRing into recycled buffers.

    Python parses the container ONCE (the reader builds the frame-offset
    index); the C++ thread preads each payload at its indexed offset into
    a registered luma buffer and interleaves I420 chroma into NV12 on the
    same pass.  Same recycling contract as NativeY4MSource; seek is O(1)
    (restart the ring at index n)."""

    def __init__(self, reader, ring_depth: int = 4, pool=None, device=None):
        """`reader` is an already-constructed MKVReader, MP4Reader or
        AVIReader (each exposes _index [(offset, size, pts)], _layout and
        an open file)."""
        self._native = native.load()
        self._reader = reader
        self.width, self.height = reader.width, reader.height
        self.fps = reader.fps
        self.fmt = reader.fmt
        self.pixfmt = reader.fmt.pixfmt
        self._layout = reader._layout
        if self._layout not in ("i420", "nv12"):
            # compressed payloads (FFV1, Ut Video, MJPEG) decode in the
            # reader; the pread ring only repacks raw planes
            raise ValueError(f"indexed ring handles raw layouts only, "
                             f"not {self._layout!r}")
        self._dtype = np.uint8
        self._start_pts = getattr(reader, "_start_pts", 0.0)
        expected = self.width * self.height * 3 // 2
        index = reader._index
        for off, size, _ in index:
            # short payloads, and AVI's empty repeat-previous entries,
            # are the reader's to handle
            if size < expected:
                raise ValueError(
                    f"short frame payload in index ({size} < {expected}); "
                    f"use the Python reader")
        self._offsets = np.ascontiguousarray(
            [off for off, _, _ in index], np.int64)
        self._pts = [pts for _, _, pts in index]
        self._fd = reader._fh.fileno()
        self._frame_index = 0
        self._init_slots(ring_depth, pool, device)
        self._open_ring(0)

    def _open_ring(self, start: int):
        self._ring = self._native.IndexedRing(self._fd, self.width,
                                              self.height, self._layout,
                                              self._offsets[start:])
        self._register_free()

    def _next_pts(self) -> float:
        pts = self._start_pts + self._pts[self._frame_index]
        self._frame_index += 1
        return pts

    def __iter__(self) -> Iterator[VideoFrame]:
        while True:
            frame = self._next_frame(self._next_pts)
            if frame is None:
                return
            yield frame

    # -- seek (index lookup + ring restart; O(1) in stream length) --------

    def seekable(self) -> bool:
        return True

    def n_frames(self) -> int:
        return len(self._pts)

    def seek_frame(self, n: int):
        n = max(min(int(n), len(self._pts)), 0)
        with self._lock:      # as in NativeY4MSource.seek_frame
            self._ring.stop()
            self._frame_index = n
            self._open_ring(n)

    def seek_pts(self, pts: float) -> float:
        if not self._pts:
            return 0.0
        target = pts - self._start_pts
        # _pts is sorted: last frame with pts <= target, O(log n)
        lo = max(bisect.bisect_right(self._pts, target + 1e-9) - 1, 0)
        self.seek_frame(lo)
        return self._start_pts + self._pts[lo]

    def close(self):
        if self._ring is not None:
            self._ring.stop()
        self._reader.close()


def container_reader(path: str):
    """The Python reader class for a container path, with its error
    class and name (MKV/WebM, MP4/MOV or AVI), or None."""
    if path.endswith((".mkv", ".webm")):
        from mpv_frame_interpolator_tpu_torch.io.mkv import MKVError, MKVReader
        return MKVReader, MKVError, "MKV"
    if path.endswith((".mp4", ".mov", ".m4v")):
        from mpv_frame_interpolator_tpu_torch.io.mp4 import MP4Error, MP4Reader
        return MP4Reader, MP4Error, "MP4"
    if path.endswith(".avi"):
        from mpv_frame_interpolator_tpu_torch.io.avi import AVIError, AVIReader
        return AVIReader, AVIError, "AVI"
    return None


def open_container(path: str, ring_depth: int = 4, start_pts: float = 0.0,
                   pool=None, device=None):
    """The native source for a container file: raw video through the
    indexed ring, compressed video (FFV1, Ut Video, MJPEG) through the
    reader with its native decoders.  Raises the reader's error type for
    codecs no native decoder takes."""
    kind = container_reader(path)
    if kind is None:
        raise ValueError(f"{path!r} is not a MKV, MP4 or AVI file")
    reader = kind[0](path, start_pts=start_pts)
    if reader._layout not in ("i420", "nv12"):
        return reader
    try:
        return NativeIndexedSource(reader, ring_depth=ring_depth, pool=pool,
                                   device=device)
    except ValueError as e:
        log.info("the indexed ring does not take %s (%s); reading it "
                 "frame by frame", path, e)
        return reader


def open_y4m(path: str, ring_depth: int = 4, start_pts: float = 0.0,
             pool=None, device=None):
    """The native ring for a y4m file, or the Python reader for an
    odd-sized stream (the ring takes even geometry only; the reader
    crops to even)."""
    try:
        return NativeY4MSource(path, ring_depth=ring_depth,
                               start_pts=start_pts, pool=pool,
                               device=device)
    except y4m_mod.Y4MError as e:
        log.info("the native ring does not take %s (%s); using the Python "
                 "reader", path, e)
    return y4m_mod.Y4MReader(open(path, "rb"), start_pts=start_pts,
                             pool=pool, device=device)
