"""Frame sinks of the port (counterpart of the JAX package's
``io/sinks.py``): where output frames go after interpolation.

  NullSink     -- swallow frames, waiting for each to be computed
  Y4MFileSink  -- write a .y4m file (8-bit or P010; ``-o out.y4m``, or a
                  binary stream such as stdout for ``-o -``)
  FFV1MKVSink  -- encode FFV1 into Matroska (``-o out.mkv``) with the
                  port's native encoder
  PgmDumpSink  -- dump luma planes as PGM images (``--dump-pgm``)
  PngDumpSink  -- dump colour PNGs (``--dump-png``)
  OsdSink      -- burn a stats line into the luma, then pass the frame on
                  (``--osd``)
  PsnrSink     -- PSNR of every frame against reference frames

Each sink but PsnrSink brings a frame's planes to the host through the
port's ``OutputFrame.to_video_frame`` (the one sync an output) and keeps
``download_time`` and ``write_time``: the seconds spent downloading and
writing or encoding (the CLI's wall split).
"""

from __future__ import annotations

import os
import time
from typing import Callable, List

import numpy as np

from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.frame import (
    NV12, P010, VideoFrame, psnr_arrays, split_chroma)
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


class _TimedSink:
    """Download a frame, hand its host planes to ``_put`` and time both."""

    def __init__(self):
        self.count = 0
        self.download_time = 0.0
        self.write_time = 0.0

    def write(self, frame):
        t0 = time.perf_counter()
        host = frame.to_video_frame()
        t1 = time.perf_counter()
        self._put(host)
        self.download_time += t1 - t0
        self.write_time += time.perf_counter() - t1
        self.count += 1

    def _put(self, frame: VideoFrame):
        raise NotImplementedError

    def close(self):
        pass


class Y4MFileSink(_TimedSink):
    """Write every frame to a .y4m file, or to an open binary stream
    (left open on close, flushed)."""

    def __init__(self, path, width: int, height: int, fps: float,
                 pixfmt: str = NV12):
        super().__init__()
        self._own = isinstance(path, (str, os.PathLike))
        self._fh = open(path, "wb") if self._own else path
        self._writer = Y4MWriter(self._fh, width, height, fps, pixfmt)

    def _put(self, frame: VideoFrame):
        self._writer.write(frame)

    def close(self):
        self._writer.close()
        if self._own:
            self._fh.close()
        else:
            self._fh.flush()


class FFV1MKVSink(_TimedSink):
    """Encode output frames to FFV1 in Matroska (``-o out.mkv``): the
    lossless archival encode path (vo_lavc/--o with -c:v ffv1 analog).
    NV12 frames encode as 8-bit 4:2:0 FFV1 v1, P010 as 10-bit (payload
    down-aligned from the high bits), through the native encoder
    (native/ffv1.cpp); every frame is a keyframe, so every packet is
    independently seekable (ffmpeg -g 1 style)."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 pixfmt: str = NV12):
        from mpv_frame_interpolator_tpu_torch.io.mkv import MKVWriter
        super().__init__()
        self._deep = pixfmt == P010
        self._bits = 10 if self._deep else 8
        self._lib = native.load()
        self._enc = self._lib.ffv1_enc_create(width, height, self._bits)
        self._fh = open(path, "wb")
        self._writer = MKVWriter(self._fh, width, height, fps,
                                 codec_id="V_FFV1")

    def _put(self, frame: VideoFrame):
        y, (u, v) = frame.y, split_chroma(frame.uv)
        if self._deep:      # P010 payload rides the high bits
            sh = 16 - self._bits
            y, u, v = y >> sh, u >> sh, v >> sh
        pkt = self._lib.ffv1_encode(
            self._enc, np.ascontiguousarray(y).tobytes(),
            np.ascontiguousarray(u).tobytes(),
            np.ascontiguousarray(v).tobytes(), True)
        self._writer.add(pkt, keyframe=True, pts=frame.pts)

    def close(self):
        self._writer.close()
        self._fh.close()


class PgmDumpSink(_TimedSink):
    """Dump each output's luma (8-bit; P010 keeps its top byte) as
    ``<prefix>_NNNNNN.pgm``."""

    def __init__(self, directory: str, prefix: str = "frame"):
        super().__init__()
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.prefix = prefix

    def _put(self, frame: VideoFrame):
        w = frame.fmt.width
        y = frame.y[:, :w]
        if y.dtype == np.uint16:
            y = (y >> 8).astype(np.uint8)
        path = os.path.join(self.directory,
                            f"{self.prefix}_{self.count:06d}.pgm")
        with open(path, "wb") as fh:
            fh.write(f"P5\n{w} {y.shape[0]}\n255\n".encode())
            fh.write(np.ascontiguousarray(y).tobytes())


class PngDumpSink(_TimedSink):
    """Dump every output as a colour PNG (BT.709 YUV->RGB; the
    screenshot subsystem's image writer, encoded by utils/png.py)."""

    def __init__(self, directory: str, prefix: str = "frame"):
        super().__init__()
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.prefix = prefix

    def _put(self, frame: VideoFrame):
        from mpv_frame_interpolator_tpu_torch.io.convert import frame_to_rgb
        from mpv_frame_interpolator_tpu_torch.utils.png import write_png
        path = os.path.join(self.directory,
                            f"{self.prefix}_{self.count:06d}.png")
        write_png(path, frame_to_rgb(frame))


class OsdSink:
    """Burn a stats line into each frame's luma before passing it to an
    inner sink (the player OSD stats overlay's headless analog).  Reads
    live engine telemetry when an engine is attached.  Its
    `download_time` and `write_time` include the inner sink's."""

    def __init__(self, inner, engine=None, scale: int = 2):
        self.inner = inner
        self.engine = engine
        self.scale = scale
        self.count = 0
        self._download = 0.0
        self._draw = 0.0

    @property
    def download_time(self) -> float:
        return self._download + getattr(self.inner, "download_time", 0.0)

    @property
    def write_time(self) -> float:
        return self._draw + getattr(self.inner, "write_time", 0.0)

    def _text(self, frame) -> str:
        if self.engine is None:
            return f"pts {frame.pts:8.3f}"
        e = self.engine
        ms = e.stats.last("source_frame_time") * 1e3
        return (f"{frame.pts:7.2f}s r{e.quality.search_radius} "
                f"{e.cadence.state.name} {ms:5.2f}ms")

    def write(self, frame):
        from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
            OutputFrame)
        from mpv_frame_interpolator_tpu_torch.utils.osd import draw_text
        t0 = time.perf_counter()
        vf = frame.to_video_frame()
        t1 = time.perf_counter()
        y = np.array(vf.y)
        draw_text(y, self._text(frame), scale=self.scale)
        self._download += t1 - t0
        self._draw += time.perf_counter() - t1
        self.count += 1
        self.inner.write(OutputFrame(frame.pts, vf.fmt, y, vf.uv))

    def close(self):
        self.inner.close()


class PsnrSink:
    """Measures PSNR of every written frame against reference frames
    produced by `reference_fn(index, pts)`."""

    def __init__(self, reference_fn: Callable[[int, float], VideoFrame],
                 plane: str = "y"):
        self.reference_fn = reference_fn
        self.plane = plane
        self.values: List[float] = []

    def write(self, frame):
        vf = frame.to_video_frame()
        ref = self.reference_fn(len(self.values), frame.pts)
        w = min(vf.fmt.width, ref.fmt.width)
        if self.plane == "y":
            a, b = vf.y[:, :w], ref.y[:, :w]
        else:
            a, b = vf.uv[:, :w], ref.uv[:, :w]
        self.values.append(psnr_arrays(a, b, vf.fmt.max_value))

    @property
    def min(self) -> float:
        return min(self.values) if self.values else 0.0

    @property
    def mean(self) -> float:
        finite = [v for v in self.values if v != float("inf")]
        return sum(finite) / len(finite) if finite else float("inf")

    def close(self):
        pass
