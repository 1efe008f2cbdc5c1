"""K2: every blended output of one source pair (csrc/warp_pair.cu).

Replaces the TPU kernel ``mpv_frame_interpolator_tpu/ops/pallas/
warp_pair.py:pair_blend_plane`` (via ``blended_pair_from_prep``): for N
blend positions at once, the blended 8-bit warp of the luma plane and of
the interleaved NV12 chroma plane, with the fixed-point blend and the
default-levels clip (ops/warp.py holds the pieces).

Bound on the card: ideally memory traffic (at 4K with N = 5 a pair
writes ~62 MB and reads two nearest source bytes per output byte from
sources that stay in L2); this first form moves one byte per access and
is bound by the count of those accesses instead.  One thread per output
pixel keeps the loop over N inside, so the flow and reverse-flow lookups
are read once per pixel.

``pair_blend`` dispatches on the device: CPU tensors take
``pair_blend_plain``, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build

counts = _build.LaunchCounts()


def _plane_plain(f1, f2, fields, ts, rs: int, rows: int, wa: int,
                 chroma: bool):
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
    w1, T = W.blend_weights(ts)
    b = W.blend_fix(f1[y12, x12], f2[y21, x21], w1[:, None, None],
                    T[:, None, None])
    return W.levels_clip(b).to(torch.uint8)


def pair_blend_plain(f1y, f1uv, f2y, f2uv, blurred, ts, rs: int,
                     actual_width: int):
    H, hc = f1y.shape[0], f1uv.shape[0]
    fields = W.reverse_fields(blurred, rs)
    y = _plane_plain(f1y, f2y, fields, ts, rs, H, actual_width, False)
    uv = _plane_plain(f1uv, f2uv, fields, ts, rs, hc, actual_width, True)
    return y, uv


def pair_blend(f1y, f1uv, f2y, f2uv, blurred, ts, rs: int,
               actual_width: int):
    """All blend positions `ts` of one pair.

    f1y/f2y (H, stride) and f1uv/f2uv (H/2, stride) uint8 NV12 planes of
    the older and newer frame; blurred (2, lh, lw) int32 flow; ts (N,)
    float32 on the same device.  Returns (y (N, H, Wa), uv (N, H/2, Wa))
    uint8 with Wa = actual_width and uv interleaved."""
    H, pitch = f1y.shape
    hc = H // 2
    if not 3 <= actual_width <= pitch or H < 6:
        raise ValueError(f"actual width {actual_width} must be in "
                         f"[3, {pitch}] and the height >= 6")
    if f1y.device.type == "cpu":
        counts.plain += 1
        return pair_blend_plain(f1y, f1uv, f2y, f2uv, blurred, ts, rs,
                                actual_width)
    dev = f1y.device
    u8 = torch.uint8
    _build.require(f1y, "f1y", u8, (H, pitch), dev)
    _build.require(f2y, "f2y", u8, (H, pitch), dev)
    _build.require(f1uv, "f1uv", u8, (hc, pitch), dev)
    _build.require(f2uv, "f2uv", u8, (hc, pitch), dev)
    _build.require(blurred, "blurred", torch.int32, None, dev)
    _build.require(ts, "ts", torch.float32, None, dev)
    if blurred.dim() != 3 or blurred.shape[0] != 2 or ts.dim() != 1:
        raise ValueError("blurred must be (2, lh, lw) and ts (N,)")
    n = ts.shape[0]
    _, lh, lw = blurred.shape
    y = torch.empty((n, H, actual_width), dtype=u8, device=dev)
    uv = torch.empty((n, hc, actual_width), dtype=u8, device=dev)
    rc = _build.load().mfi_pair_blend(
        f1y.data_ptr(), f1uv.data_ptr(), f2y.data_ptr(), f2uv.data_ptr(),
        blurred.data_ptr(), ts.data_ptr(), y.data_ptr(), uv.data_ptr(),
        n, H, actual_width, pitch, lh, lw, rs, _build.stream_of(f1y))
    _build.check("pair_blend", rc)
    counts.kernel += 1
    return y, uv
