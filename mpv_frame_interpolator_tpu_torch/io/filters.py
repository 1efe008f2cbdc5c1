"""Host-side user frame filters (the --vf chain analog).

The reference routes decoded frames through a user-configurable filter list
before HopperRender (filters/user_filters.c --vf parsing; auto rotate/vflip
filters in filters/f_auto_filters.c).  The rebuild's equivalents operate on
host VideoFrames ahead of the engine; they compose as a simple chain:

    chain = parse_chain("crop=640:360:10:10,vflip")
    frames = apply_chain(chain, source)

Available: crop=w:h[:x:y], vflip, hflip, rotate=90|180|270, fps=N
(drop/duplicate to a fixed rate -- the f_utils fixed-fps analog),
setpts=offset (pts shift), scale=w:h (bilinear resize, the swscale-subset
analog; h=-2 keeps aspect rounded to even), deinterlace[=bob|weave]
(f_auto_filters deinterlacing analog: bob doubles the frame rate from
fields).
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List

import numpy as np

from mpv_frame_interpolator_tpu_torch.frame import (
    FrameFormat, VideoFrame, split_chroma, interleave_chroma)


def _remake(frame: VideoFrame, y, u, v, pts=None) -> VideoFrame:
    h, w = y.shape
    fmt = FrameFormat(w, h, frame.fmt.pixfmt,
                      primaries=frame.fmt.primaries,
                      transfer=frame.fmt.transfer, matrix=frame.fmt.matrix)
    return VideoFrame(np.ascontiguousarray(y), interleave_chroma(
        np.ascontiguousarray(u), np.ascontiguousarray(v)), fmt,
        pts=frame.pts if pts is None else pts,
        nominal_fps=frame.nominal_fps)


def crop(w: int, h: int, x: int = 0, y: int = 0):
    if w % 2 or h % 2 or x % 2 or y % 2:
        raise ValueError("crop geometry must be even (4:2:0)")

    def f(frame: VideoFrame) -> VideoFrame:
        u, v = split_chroma(frame.uv)
        return _remake(frame, frame.y[y:y + h, x:x + w],
                       u[y // 2:(y + h) // 2, x // 2:(x + w) // 2],
                       v[y // 2:(y + h) // 2, x // 2:(x + w) // 2])
    return f


def vflip():
    def f(frame: VideoFrame) -> VideoFrame:
        u, v = split_chroma(frame.uv)
        return _remake(frame, frame.y[::-1], u[::-1], v[::-1])
    return f


def hflip():
    def f(frame: VideoFrame) -> VideoFrame:
        u, v = split_chroma(frame.uv)
        return _remake(frame, frame.y[:, ::-1], u[:, ::-1], v[:, ::-1])
    return f


def rotate(degrees: int):
    if degrees not in (90, 180, 270):
        raise ValueError("rotate supports 90/180/270")
    k = degrees // 90

    def f(frame: VideoFrame) -> VideoFrame:
        u, v = split_chroma(frame.uv)
        return _remake(frame, np.rot90(frame.y[:, :frame.fmt.width], k),
                       np.rot90(u[:, :frame.fmt.width // 2], k),
                       np.rot90(v[:, :frame.fmt.width // 2], k))
    return f


def _resize_plane(p: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Separable bilinear resize with pixel-center mapping (the swscale
    default geometry), rounded back to the integer sample type."""
    ih, iw = p.shape
    if (ih, iw) == (oh, ow):
        return p
    xs = (np.arange(ow) + 0.5) * iw / ow - 0.5
    ys = (np.arange(oh) + 0.5) * ih / oh - 0.5
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, iw - 1)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    fx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    fy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None]
    pf = p.astype(np.float32)
    rows0 = pf[y0]
    rows1 = pf[y1]
    r = rows0 * (1.0 - fy) + rows1 * fy
    out = r[:, x0] * (1.0 - fx) + r[:, x1] * fx
    info = np.iinfo(p.dtype)
    return np.clip(np.rint(out), info.min, info.max).astype(p.dtype)


def scale(w: int, h: int):
    """Bilinear rescale (the autoconvert/swscale scaling gap).  h == -2
    keeps the aspect ratio, rounded to the nearest even row count."""
    if w % 2 or (h != -2 and h % 2):
        raise ValueError("scale geometry must be even (4:2:0)")

    def f(frame: VideoFrame) -> VideoFrame:
        th = h
        if th == -2:
            th = int(round(frame.fmt.height * w / frame.fmt.width / 2)) * 2
        u, v = split_chroma(frame.uv)
        cw = frame.fmt.width // 2
        return _remake(frame,
                       _resize_plane(frame.y[:, :frame.fmt.width], th, w),
                       _resize_plane(np.ascontiguousarray(u[:, :cw]),
                                     th // 2, w // 2),
                       _resize_plane(np.ascontiguousarray(v[:, :cw]),
                                     th // 2, w // 2))
    return f


def _field_to_frame(field: np.ndarray, h: int, top: bool) -> np.ndarray:
    """Line-double one field to full height: kept lines verbatim, missing
    lines linearly interpolated from the field neighbors (bob)."""
    out = np.empty((h, field.shape[1]), field.dtype)
    wide = field.astype(np.uint32)
    interp = ((wide[:-1] + wide[1:] + 1) >> 1).astype(field.dtype)
    if top:
        out[0::2] = field
        out[1:h - 1:2] = interp       # rows 1,3,...,h-3
        out[h - 1] = field[-1]        # no field line below: repeat
    else:
        out[1::2] = field
        out[2::2] = interp            # rows 2,4,...,h-2
        out[0] = field[0]             # no field line above: repeat
    return out


def deinterlace(mode: str = "bob"):
    """f_auto_filters deinterlace analog.  bob: each frame becomes two
    progressive frames (top field first), doubling the rate; weave: pass
    through unchanged (fields already woven)."""
    if mode not in ("bob", "weave"):
        raise ValueError("deinterlace supports bob|weave")
    if mode == "weave":
        return lambda frame: frame

    def f(frame: VideoFrame):
        h = frame.fmt.height
        u, v = split_chroma(frame.uv)
        u = np.ascontiguousarray(u[:, :frame.fmt.width // 2])
        v = np.ascontiguousarray(v[:, :frame.fmt.width // 2])
        y = frame.y[:, :frame.fmt.width]
        dt = 1.0 / frame.nominal_fps if frame.nominal_fps > 0 else 1 / 48.0
        out = []
        for top, shift in ((True, 0.0), (False, 0.5)):
            sl = slice(0, None, 2) if top else slice(1, None, 2)
            fy = _field_to_frame(np.ascontiguousarray(y[sl]), h, top)
            fu = _field_to_frame(np.ascontiguousarray(u[sl]), h // 2, top)
            fv = _field_to_frame(np.ascontiguousarray(v[sl]), h // 2, top)
            fr = _remake(frame, fy, fu, fv, pts=frame.pts + shift * dt)
            out.append(VideoFrame(fr.y, fr.uv, fr.fmt, fr.pts,
                                  frame.nominal_fps * 2))
        return out
    return f


def setpts(offset: float):
    def f(frame: VideoFrame) -> VideoFrame:
        return frame.with_pts(frame.pts + offset)
    return f


class fps:
    """Fixed-fps converter: drop/duplicate to a target rate
    (filters/f_utils.c mp_fixed_fps_create analog)."""

    def __init__(self, target: float):
        self.target = target
        self._next_pts = None

    def __call__(self, frame: VideoFrame):
        # generator-style filter: may emit 0..N frames
        out = []
        dt = 1.0 / self.target
        if self._next_pts is None:
            self._next_pts = frame.pts
        while frame.pts > self._next_pts - dt / 2:
            f2 = frame.with_pts(self._next_pts)
            f2 = VideoFrame(f2.y, f2.uv, f2.fmt, f2.pts, self.target)
            out.append(f2)
            self._next_pts += dt
        return out


def parse_chain(spec: str) -> List[Callable]:
    """'crop=640:360,vflip,fps=30' -> list of filter callables."""
    chain: List[Callable] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, argstr = part.partition("=")
        args = [a for a in argstr.split(":") if a] if argstr else []
        if name == "crop":
            chain.append(crop(*[int(a) for a in args]))
        elif name == "vflip":
            chain.append(vflip())
        elif name == "hflip":
            chain.append(hflip())
        elif name == "rotate":
            chain.append(rotate(int(args[0])))
        elif name == "fps":
            chain.append(fps(float(args[0])))
        elif name == "scale":
            chain.append(scale(int(args[0]),
                               int(args[1]) if len(args) > 1 else -2))
        elif name == "deinterlace":
            chain.append(deinterlace(args[0] if args else "bob"))
        elif name == "setpts":
            chain.append(setpts(float(args[0])))
        else:
            raise ValueError(f"unknown filter {name!r}")
    return chain


def apply_chain(chain: List[Callable],
                source: Iterable[VideoFrame]) -> Iterator[VideoFrame]:
    def run_one(frames, f):
        for fr in frames:
            out = f(fr)
            if out is None:
                continue
            if isinstance(out, VideoFrame):
                yield out
            else:
                yield from out

    frames: Iterable[VideoFrame] = source
    for f in chain:
        frames = run_one(frames, f)
    return iter(frames)
