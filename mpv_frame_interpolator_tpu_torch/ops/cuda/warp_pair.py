"""K2: every blended output of one source pair (csrc/warp_pair.cu).

Replaces the TPU kernel ``mpv_frame_interpolator_tpu/ops/pallas/
warp_pair.py:pair_blend_plane`` (via ``blended_pair_from_prep``): for N
blend positions at once, the blended warp of the luma plane and of the
interleaved chroma plane, with the fixed-point blend and the black/white
level maps, for 8-bit NV12 (scale_shift 0) and 10-bit P010 (uint16
samples, scale_shift 8) alike (ops/warp.py holds the pieces).  The TPU
kernel covers only 8-bit NV12 at the default levels; this one serves
every case.

Bound on the card: ideally memory traffic (at 4K with N = 5 a pair
writes ~62 MB and reads two nearest source samples per output sample
from sources that stay in L2); this first form moves one sample per
access and is bound by the count of those accesses instead.  One thread
per output pixel keeps the loop over N inside, so the flow and
reverse-flow lookups are read once per pixel.

``pair_blend`` dispatches on the device: CPU tensors take
``pair_blend_plain``, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build

counts = _build.LaunchCounts()


def _plane_plain(f1, f2, fields, ts, rs: int, rows: int, wa: int,
                 chroma: bool, scale_shift: int, k: int, w: int):
    up = W.upsample_uv if chroma else W.upsample_y
    ox12, oy12, ox21, oy21 = (up(p, rs, rows, wa).to(torch.float32)[None]
                              for p in fields)
    t12 = ts.to(torch.float32)[:, None, None]
    t21 = 1.0 - t12
    dy12, dy21 = oy12 * t12, oy21 * t21
    if chroma:
        dy12, dy21 = dy12 * 0.5, dy21 * 0.5
    cy = torch.arange(rows, device=f1.device)[:, None]
    cx = torch.arange(wa, device=f1.device)[None, :]
    x12 = W.mirror_edge2(cx + W.iround(ox12 * t12), wa)
    x21 = W.mirror_edge2(cx - W.iround(ox21 * t21), wa)
    y12 = W.mirror_edge2(cy + W.iround(dy12), rows)
    y21 = W.mirror_edge2(cy - W.iround(dy21), rows)
    if chroma:
        x12, x21 = W.nv12_column(x12, cx), W.nv12_column(x21, cx)
    w1, T = W.blend_weights(ts, scale_shift)
    # widened before indexing: CUDA does not index uint16
    s12 = f1.to(torch.int32)[y12, x12]
    s21 = f2.to(torch.int32)[y21, x21]
    b = W.blend_fix(s12, s21, w1[:, None, None], T[:, None, None],
                    scale_shift)
    out = (W.levels_uv(b, w, scale_shift) if chroma
           else W.levels_y(b, k, w, scale_shift))
    return out.to(f1.dtype)


def pair_blend_plain(f1y, f1uv, f2y, f2uv, blurred, ts, rs: int,
                     actual_width: int, scale_shift: int = 0,
                     levels=(0, 255)):
    H, hc = f1y.shape[0], f1uv.shape[0]
    k, w = levels
    fields = W.reverse_fields(blurred, rs)
    y = _plane_plain(f1y, f2y, fields, ts, rs, H, actual_width, False,
                     scale_shift, k, w)
    uv = _plane_plain(f1uv, f2uv, fields, ts, rs, hc, actual_width, True,
                      scale_shift, k, w)
    return y, uv


def check_args(f1y, f1uv, f2y, f2uv, blurred, actual_width: int,
               scale_shift: int):
    """The checks K2 and K4 share, on any device: geometry, the sample
    type scale_shift implies (uint8 for 0, uint16 for 8) and the flow's
    shape.  Returns (H, pitch, sample dtype)."""
    H, pitch = f1y.shape
    if not 3 <= actual_width <= pitch or H < 6:
        raise ValueError(f"actual width {actual_width} must be in "
                         f"[3, {pitch}] and the height >= 6")
    if scale_shift not in (0, 8):
        raise ValueError(f"scale_shift must be 0 (NV12) or 8 (P010), got "
                         f"{scale_shift}")
    sample = torch.uint16 if scale_shift else torch.uint8
    for name, t, shape in (("f1y", f1y, (H, pitch)), ("f2y", f2y, (H, pitch)),
                           ("f1uv", f1uv, (H // 2, pitch)),
                           ("f2uv", f2uv, (H // 2, pitch))):
        if t.dtype != sample or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {sample} {shape} for "
                             f"scale_shift {scale_shift}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if blurred.dim() != 3 or blurred.shape[0] != 2:
        raise ValueError("blurred must be (2, lh, lw)")
    return H, pitch, sample


def pair_blend(f1y, f1uv, f2y, f2uv, blurred, ts, rs: int,
               actual_width: int, scale_shift: int = 0, levels=(0, 255)):
    """All blend positions `ts` of one pair.

    f1y/f2y (H, stride) and f1uv/f2uv (H/2, stride) planes of the older
    and newer frame, uint8 for NV12 (scale_shift 0) or uint16 for P010
    (scale_shift 8); blurred (2, lh, lw) int32 flow; ts (N,) float32 on
    the same device; levels (k, w) the black and white levels as ints on
    the 8-bit scale (ops/warp.level_ints).  Returns (y (N, H, Wa), uv
    (N, H/2, Wa)) of the planes' dtype, with Wa = actual_width and uv
    interleaved."""
    H, pitch, sample = check_args(f1y, f1uv, f2y, f2uv, blurred,
                                  actual_width, scale_shift)
    if ts.dim() != 1:
        raise ValueError("ts must be (N,)")
    k, w = levels
    if f1y.device.type == "cpu":
        counts.plain += 1
        return pair_blend_plain(f1y, f1uv, f2y, f2uv, blurred, ts, rs,
                                actual_width, scale_shift, levels)
    dev = f1y.device
    hc = H // 2
    _build.require(f1y, "f1y", sample, (H, pitch), dev)
    _build.require(f2y, "f2y", sample, (H, pitch), dev)
    _build.require(f1uv, "f1uv", sample, (hc, pitch), dev)
    _build.require(f2uv, "f2uv", sample, (hc, pitch), dev)
    _build.require(blurred, "blurred", torch.int32, None, dev)
    _build.require(ts, "ts", torch.float32, None, dev)
    n = ts.shape[0]
    _, lh, lw = blurred.shape
    y = torch.empty((n, H, actual_width), dtype=sample, device=dev)
    uv = torch.empty((n, hc, actual_width), dtype=sample, device=dev)
    rc = _build.load().mfi_pair_blend(
        f1y.data_ptr(), f1uv.data_ptr(), f2y.data_ptr(), f2uv.data_ptr(),
        blurred.data_ptr(), ts.data_ptr(), y.data_ptr(), uv.data_ptr(),
        n, H, actual_width, pitch, lh, lw, rs, scale_shift, k, w,
        _build.stream_of(f1y))
    _build.check("pair_blend", rc)
    counts.kernel += 1
    return y, uv
