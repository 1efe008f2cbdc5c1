"""JPEG / Motion-JPEG decode to VideoFrame (NV12).

The reference hands every compressed codec to libavcodec
(video/decode/vd_lavc.c:1157-1388); this rebuild carries its own baseline
JPEG decoder so MJPEG media -- the dominant compressed format in capture
pipelines and the only one tractable without an external codec library --
plays without ffmpeg:

* the native C++ decoder (native/jpeg.cpp, the port's own library,
  built at first use; T.81 baseline, restart intervals,
  4:2:0/4:2:2/4:4:4/gray, Annex K default-table AVI "MJPG" convention),
  releasing the GIL so the ingest reader thread can decode while the
  pipeline runs;
* with use_native=False, Pillow where it is installed (decodes via
  libjpeg, then box-downsamples the fancy-upsampled chroma -- pixel
  values can differ from the native path by a few LSB, same as any two
  independent IDCT implementations).

The port's copy of the JAX package's ``io/jpeg.py``.

Also provides the raw-stream splitter for .mjpeg/.mjpg files
(concatenated JPEGs, what many IP cameras emit).
"""

from __future__ import annotations

import io as _io
from typing import Iterator, Optional

import numpy as np

from mpv_frame_interpolator_tpu_torch.frame import (
    NV12, FrameFormat, VideoFrame, interleave_chroma)
from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("jpeg")


def decode_jpeg_planes(data: bytes, use_native: bool = True):
    """Decode one JPEG to (y, u, v) uint8 planes (I420 chroma grid):
    natively, or with use_native=False through Pillow.

    Raises ValueError on malformed input."""
    if use_native:
        w, h, y, u, v = native.load().decode_jpeg(data)
        cw, ch = (w + 1) // 2, (h + 1) // 2
        return (np.frombuffer(y, np.uint8).reshape(h, w),
                np.frombuffer(u, np.uint8).reshape(ch, cw),
                np.frombuffer(v, np.uint8).reshape(ch, cw))
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        raise RuntimeError(
            "JPEG decode with use_native=False needs Pillow")
    try:
        img = Image.open(_io.BytesIO(data))
        img.load()
    except Exception as e:  # PIL raises various types on bad input
        raise ValueError(f"bad JPEG: {e}") from None
    ycc = np.asarray(img.convert("YCbCr"))
    y = ycc[:, :, 0].copy()
    h, w = y.shape
    # box-downsample full-res chroma to the I420 grid
    cb = np.pad(ycc[:, :, 1], ((0, h % 2), (0, w % 2)), mode="edge")
    cr = np.pad(ycc[:, :, 2], ((0, h % 2), (0, w % 2)), mode="edge")

    def ds(p):
        return ((p[0::2, 0::2].astype(np.uint16) + p[0::2, 1::2]
                 + p[1::2, 0::2] + p[1::2, 1::2] + 2) >> 2).astype(np.uint8)

    return y, ds(cb), ds(cr)


def decode_jpeg_frame(data: bytes, pts: float = 0.0,
                      nominal_fps: float = 0.0,
                      use_native: bool = True) -> VideoFrame:
    """Decode one JPEG to an NV12 VideoFrame.

    Odd dimensions are padded to even (NV12 requires even geometry;
    the pipeline's autoconvert would otherwise do the same edge-pad)."""
    y, u, v = decode_jpeg_planes(data, use_native)
    h, w = y.shape
    if (h % 2) or (w % 2):
        y = np.pad(y, ((0, h % 2), (0, w % 2)), mode="edge")
        h, w = y.shape
    ch, cw = h // 2, w // 2
    if u.shape != (ch, cw):
        u = u[:ch, :cw]
        v = v[:ch, :cw]
        if u.shape != (ch, cw):  # padded-up geometry
            u = np.pad(u, ((0, ch - u.shape[0]), (0, cw - u.shape[1])),
                       mode="edge")
            v = np.pad(v, ((0, ch - v.shape[0]), (0, cw - v.shape[1])),
                       mode="edge")
    fmt = FrameFormat(width=w, height=h, pixfmt=NV12)
    return VideoFrame(fmt=fmt, y=y, uv=interleave_chroma(u, v), pts=pts,
                      nominal_fps=nominal_fps)


def split_jpeg_stream(read, chunk: int = 1 << 16) -> Iterator[bytes]:
    """Split a raw concatenated-JPEG byte stream (IP-camera .mjpeg) into
    individual SOI..EOI frames.  ``read`` is a file-like .read."""
    buf = bytearray()
    while True:
        # find SOI
        while True:
            i = buf.find(b"\xff\xd8")
            if i >= 0:
                del buf[:i]
                break
            if len(buf) > 2:
                del buf[:-1]
            b = read(chunk)
            if not b:
                return
            buf += b
        # find EOI after SOI (skip entropy-stuffed FFs naturally: 0xFFD9
        # cannot appear inside a valid entropy segment unstuffed)
        start = 2
        while True:
            j = buf.find(b"\xff\xd9", start)
            if j >= 0:
                yield bytes(buf[:j + 2])
                del buf[:j + 2]
                break
            start = max(2, len(buf) - 1)
            b = read(chunk)
            if not b:
                if len(buf) > 4:
                    yield bytes(buf)  # truncated final frame: decoder pads
                return
            buf += b


def mjpeg_source(path_or_file, fps: float = 25.0, start_pts: float = 0.0,
                 use_native: bool = True) -> Iterator[VideoFrame]:
    """Frames from a raw .mjpeg/.mjpg file (concatenated JPEGs).

    The stream carries no timestamps; ``fps`` supplies the nominal rate
    (the reference's lavf demuxer does the same for rawvideo-ish inputs)."""
    close = None
    if isinstance(path_or_file, str):
        f = open(path_or_file, "rb")
        close = f
    else:
        f = path_or_file
    try:
        n = 0
        for data in split_jpeg_stream(f.read):
            try:
                frame = decode_jpeg_frame(data, pts=start_pts + n / fps,
                                          nominal_fps=fps,
                                          use_native=use_native)
            except ValueError as e:
                log.warning("skipping undecodable MJPEG frame %d: %s", n, e)
                continue
            yield frame
            n += 1
    finally:
        if close is not None:
            close.close()
