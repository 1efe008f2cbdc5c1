"""K2: every blended output of one source pair (csrc/warp_pair.cu).

Replaces the TPU kernel ``mpv_frame_interpolator_tpu/ops/pallas/
warp_pair.py:pair_blend_plane`` (via ``blended_pair_from_prep``): for N
blend positions at once, the blended warp of the luma plane and of the
interleaved chroma plane, with the fixed-point blend and the black/white
level maps, for 8-bit NV12 (scale_shift 0) and 10-bit P010 (uint16
samples, scale_shift 8) alike (ops/warp.py holds the pieces).  The TPU
kernel covers only 8-bit NV12 at the default levels; this one serves
every case.

Bound on the card, ideally: memory traffic (at 4K with N = 5 a pair
writes ~62 MB and reads two nearest source samples per output sample
from sources that stay in L2).  One thread per 16-byte output run of a
row (and, at 8 bits, per position) computes each flow cell's
displacements once a position and, where no sample of the run is
mirrored, reads its sources with aligned 16-byte loads and writes one
16-byte store a position; edge runs take the per-sample step (see the
header of csrc/warp_pair.cu).
``vector_path`` says whether a launch may take the 16-byte path at all
(tests/test_torch_warp_runs.py models the run decomposition on the CPU).

``pair_blend`` dispatches on the device: CPU tensors take
``pair_blend_plain``, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build

counts = _build.LaunchCounts()
rows_counts = _build.LaunchCounts()      # the row band's


def _plane_plain(f1, f2, fields, ts, rs: int, rows: int, wa: int,
                 chroma: bool, scale_shift: int, k: int, w: int):
    up = W.upsample_uv if chroma else W.upsample_y
    ox12, oy12, ox21, oy21 = (up(p, rs, rows, wa).to(torch.float32)[None]
                              for p in fields)
    t12 = ts.to(torch.float32)[:, None, None]
    y12, x12 = W.sample_coords(ox12, oy12, t12, False, rows, wa, chroma)
    y21, x21 = W.sample_coords(ox21, oy21, 1.0 - t12, True, rows, wa, chroma)
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


RUN_BYTES = 16


def vector_path(planes, actual_width: int) -> bool:
    """Whether K2, K4 or K5 may read and write 16-byte runs: every plane
    (sources and outputs) starts 16-byte aligned and both the source rows
    (pitch) and the output rows (actual_width) are a multiple of 16 bytes.
    Otherwise the whole launch takes the per-sample path."""
    item = planes[0].element_size()
    return (planes[0].shape[-1] * item % RUN_BYTES == 0
            and actual_width * item % RUN_BYTES == 0
            and all(p.data_ptr() % RUN_BYTES == 0 for p in planes))


def _require_planes(f1y, f1uv, f2y, f2uv, blurred, ts, sample, H: int,
                    pitch: int):
    """The checks of a launch on the card: contiguous CUDA planes on one
    device, the sources of the sample type and shape, the flow int32, the
    positions float32."""
    dev = f1y.device
    _build.require(f1y, "f1y", sample, (H, pitch), dev)
    _build.require(f2y, "f2y", sample, (H, pitch), dev)
    _build.require(f1uv, "f1uv", sample, (H // 2, pitch), dev)
    _build.require(f2uv, "f2uv", sample, (H // 2, pitch), dev)
    _build.require(blurred, "blurred", torch.int32, None, dev)
    _build.require(ts, "ts", torch.float32, None, dev)


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
    _require_planes(f1y, f1uv, f2y, f2uv, blurred, ts, sample, H, pitch)
    n = ts.shape[0]
    _, lh, lw = blurred.shape
    y = torch.empty((n, H, actual_width), dtype=sample, device=dev)
    uv = torch.empty((n, hc, actual_width), dtype=sample, device=dev)
    vec = vector_path((f1y, f1uv, f2y, f2uv, y, uv), actual_width)
    rc = _build.load().mfi_pair_blend(
        f1y.data_ptr(), f1uv.data_ptr(), f2y.data_ptr(), f2uv.data_ptr(),
        blurred.data_ptr(), ts.data_ptr(), y.data_ptr(), uv.data_ptr(),
        n, H, actual_width, pitch, lh, lw, rs, scale_shift, k, w, int(vec),
        _build.stream_of(f1y))
    _build.check("pair_blend", rc)
    counts.kernel += 1
    return y, uv


def band_rows(H: int, parts: int):
    """[(r0, r1), ...]: `parts` row bands of a plane of H rows (H even),
    each edge even so that chroma's half rows split with luma's; the last
    band takes the remainder."""
    if parts < 1 or H < 2 * parts:
        raise ValueError(f"{H} rows do not split into {parts} bands")
    base = (H // parts) & ~1
    edges = [i * base for i in range(parts)] + [H]
    return list(zip(edges[:-1], edges[1:]))


def pair_blend_rows_plain(f1y, f1uv, f2y, f2uv, blurred, ts, rs: int,
                          actual_width: int, r0: int, r1: int,
                          scale_shift: int = 0, levels=(0, 255)):
    """The row band in plain PyTorch: ``pair_blend_plain``'s outputs, luma
    rows [r0, r1) and chroma rows [r0/2, r1/2)."""
    y, uv = pair_blend_plain(f1y, f1uv, f2y, f2uv, blurred, ts, rs,
                             actual_width, scale_shift, levels)
    return y[:, r0:r1].contiguous(), uv[:, r0 // 2:r1 // 2].contiguous()


def pair_blend_rows(f1y, f1uv, f2y, f2uv, blurred, ts, rs: int,
                    actual_width: int, r0: int, r1: int,
                    scale_shift: int = 0, levels=(0, 255)):
    """K2's row band: ``pair_blend``'s outputs for luma rows [r0, r1) and
    chroma rows [r0/2, r1/2) of every position, as (y (N, r1 - r0, Wa),
    uv (N, (r1 - r0)/2, Wa)); r0 and r1 even.  The sources are read whole,
    at mirrored coordinates, so the bands of a split stacked give
    ``pair_blend``'s planes.  The row-sharded warp (parallel/sharding.py)
    runs one band a rank.

    CPU tensors take ``pair_blend_rows_plain``; CUDA tensors launch the
    row-band kernel (csrc/warp_pair.cu ``mfi_pair_blend_rows``, its own
    entry: the pair-blend kernel is untouched) or raise.
    ``rows_counts`` counts its launches."""
    H, pitch, sample = check_args(f1y, f1uv, f2y, f2uv, blurred,
                                  actual_width, scale_shift)
    if ts.dim() != 1:
        raise ValueError("ts must be (N,)")
    if not (0 <= r0 < r1 <= H and r0 % 2 == 0 and r1 % 2 == 0):
        raise ValueError(f"rows [{r0}, {r1}) are not an even band of "
                         f"{H} rows")
    k, w = levels
    if f1y.device.type == "cpu":
        rows_counts.plain += 1
        return pair_blend_rows_plain(f1y, f1uv, f2y, f2uv, blurred, ts, rs,
                                     actual_width, r0, r1, scale_shift,
                                     levels)
    dev = f1y.device
    _require_planes(f1y, f1uv, f2y, f2uv, blurred, ts, sample, H, pitch)
    n = ts.shape[0]
    _, lh, lw = blurred.shape
    y = torch.empty((n, r1 - r0, actual_width), dtype=sample, device=dev)
    uv = torch.empty((n, (r1 - r0) // 2, actual_width), dtype=sample,
                     device=dev)
    vec = vector_path((f1y, f1uv, f2y, f2uv, y, uv), actual_width)
    rc = _build.load().mfi_pair_blend_rows(
        f1y.data_ptr(), f1uv.data_ptr(), f2y.data_ptr(), f2uv.data_ptr(),
        blurred.data_ptr(), ts.data_ptr(), y.data_ptr(), uv.data_ptr(),
        n, H, actual_width, pitch, lh, lw, rs, scale_shift, k, w, int(vec),
        r0, r1, _build.stream_of(f1y))
    _build.check("pair_blend_rows", rc)
    rows_counts.kernel += 1
    return y, uv
