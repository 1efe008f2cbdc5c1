"""Frame sinks of the port (counterpart of the JAX package's
``io/sinks.py``): a y4m file writer (8-bit or P010) and a null sink."""

from __future__ import annotations

import time

from mpv_frame_interpolator_tpu_torch.frame import NV12
from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MWriter


class NullSink:
    """Swallow frames (vo_null analog), with `block` waiting for each to
    be computed."""

    def __init__(self, block: bool = True):
        self.block = block
        self.count = 0
        self.last_pts = None

    def write(self, frame):
        if self.block:
            frame.block()
        self.count += 1
        self.last_pts = frame.pts

    def close(self):
        pass


class Y4MFileSink:
    """Write every frame to a .y4m file (planes downloaded per frame).
    `download_time` and `write_time`: seconds spent bringing planes to the
    host (the one sync an output) and writing them."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 pixfmt: str = NV12):
        self._fh = open(path, "wb")
        self._writer = Y4MWriter(self._fh, width, height, fps, pixfmt)
        self.count = 0
        self.download_time = 0.0
        self.write_time = 0.0

    def write(self, frame):
        t0 = time.perf_counter()
        host = frame.to_video_frame()
        t1 = time.perf_counter()
        self._writer.write(host)
        self.download_time += t1 - t0
        self.write_time += time.perf_counter() - t1
        self.count += 1

    def close(self):
        self._writer.close()
        self._fh.close()
