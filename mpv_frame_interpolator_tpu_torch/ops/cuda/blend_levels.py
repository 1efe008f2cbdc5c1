"""G1: the blend and level maps of one blend position (csrc/blend_levels.cu).

Not a TPU kernel: it replaces the XLA fusion that the JAX package runs
around its one-direction sampler, ``ops/warp._blend_fix`` followed by
``_levels_y_rt`` / ``_levels_uv_rt`` (``mpv_frame_interpolator_tpu/ops/
warp.py:700``, ``:737-:774``).  The engine calls it once a position in
mode 2 under the "pallas" sampler, on K5's two directions, and in mode 2
of model ``hopperx`` with the occlusion correction (mode 3 blends inside
its own kernel, ``warp_views.warp_hsv``, whose plain version composes
this one's).  Per sample of the luma plane and the interleaved chroma
plane: the fixed-point blend with 24 - (8 if scale_shift) fraction
bits in uint32 (the JAX arithmetic: it never wraps), for hopperx the
occlusion correction on the two raw samples (``ops/warp.occlusion_adjust``,
the XLA ops ``_occlusion_adjust`` at ``ops/warp.py:103``), then the
exact-integer black/white level maps in int32, capped at 255 <<
scale_shift.

Bound on the card: bytes -- one 4K position reads two raw sample planes
and writes one, 3 x 12.4 MB at 8 bits, twice that under P010.  One launch
covers both planes; a thread blends a 16-byte run of a row with two
aligned 16-byte loads and one store where ``warp_pair.vector_path`` says
the planes qualify, else sample by sample.

The plain version is the composition of ``ops/warp.blend_weights``,
``blend_fix``, ``occlusion_adjust``, ``levels_y`` and ``levels_uv``.
``blend_levels`` dispatches on the device: CPU tensors take
``blend_levels_plain``, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair

counts = _build.LaunchCounts()


def blend_levels_plain(s12y, s12uv, s21y, s21uv, t, scale_shift: int = 0,
                       levels=(0, 255), occlusion: bool = False):
    k, w = levels
    w1, T = W.blend_weights(t.reshape(()), scale_shift)
    b_y = W.blend_fix(s12y, s21y, w1, T, scale_shift)
    b_uv = W.blend_fix(s12uv, s21uv, w1, T, scale_shift)
    if occlusion:
        b_y = W.occlusion_adjust(b_y, s12y, s21y, t, scale_shift)
        b_uv = W.occlusion_adjust(b_uv, s12uv, s21uv, t, scale_shift)
    dtype = s12y.dtype
    return (W.levels_y(b_y, k, w, scale_shift).to(dtype),
            W.levels_uv(b_uv, w, scale_shift).to(dtype))


def blend_levels(s12y, s12uv, s21y, s21uv, t, scale_shift: int = 0,
                 levels=(0, 255), occlusion: bool = False):
    """One blend position from the raw samples of its two directions.

    s12y/s21y (H, Wa) and s12uv/s21uv (H/2, Wa) interleaved, uint8 for
    scale_shift 0 and uint16 for 8 (``warp_sample.sample_dir``'s
    outputs); t a one-element float32 tensor on their device, read there;
    levels (k, w) as ints on the 8-bit scale (``ops/warp.level_ints``);
    occlusion: the hopperx correction between the blend and the levels.
    Returns (y, uv) of the samples' dtype."""
    if scale_shift not in (0, 8):
        raise ValueError(f"scale_shift must be 0 (NV12) or 8 (P010), got "
                         f"{scale_shift}")
    if t.numel() != 1:
        raise ValueError(f"t must hold one blend position, got "
                         f"{tuple(t.shape)}")
    sample = torch.uint16 if scale_shift else torch.uint8
    H, wa = s12y.shape
    for name, p, shape in (("s12y", s12y, (H, wa)), ("s21y", s21y, (H, wa)),
                           ("s12uv", s12uv, (H // 2, wa)),
                           ("s21uv", s21uv, (H // 2, wa))):
        if p.dtype != sample or tuple(p.shape) != shape:
            raise ValueError(f"{name} must be {sample} {shape} for "
                             f"scale_shift {scale_shift}, got {p.dtype} "
                             f"{tuple(p.shape)}")
    if s12y.device.type == "cpu":
        counts.plain += 1
        return blend_levels_plain(s12y, s12uv, s21y, s21uv, t, scale_shift,
                                  levels, occlusion)
    dev = s12y.device
    for name, p in (("s12y", s12y), ("s21y", s21y), ("s12uv", s12uv),
                    ("s21uv", s21uv)):
        _build.require(p, name, sample, None, dev)
    _build.require(t, "t", torch.float32, None, dev)
    k, w = levels
    y = torch.empty_like(s12y)
    uv = torch.empty_like(s12uv)
    vec = warp_pair.vector_path((s12y, s12uv, s21y, s21uv, y, uv), wa)
    rc = _build.load().mfi_blend_levels(
        s12y.data_ptr(), s12uv.data_ptr(), s21y.data_ptr(), s21uv.data_ptr(),
        t.data_ptr(), y.data_ptr(), uv.data_ptr(), H, wa, scale_shift, k, w,
        int(vec), int(occlusion), _build.stream_of(s12y))
    _build.check("blend_levels", rc)
    counts.kernel += 1
    return y, uv
