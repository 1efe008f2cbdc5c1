"""Frame sinks of the port (counterpart of the JAX package's
``io/sinks.py``): a y4m file writer (8-bit or P010) and a null sink."""

from __future__ import annotations

from mpv_frame_interpolator_tpu_torch.frame import NV12
from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MWriter


class NullSink:
    """Swallow frames, waiting for each to be computed."""

    def write(self, frame):
        frame.block()

    def close(self):
        pass


class Y4MFileSink:
    """Write every frame to a .y4m file (planes downloaded per frame)."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 pixfmt: str = NV12):
        self._fh = open(path, "wb")
        self._writer = Y4MWriter(self._fh, width, height, fps, pixfmt)

    def write(self, frame):
        self._writer.write(frame.to_video_frame())

    def close(self):
        self._writer.close()
        self._fh.close()
