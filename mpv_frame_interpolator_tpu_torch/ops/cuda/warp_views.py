"""V1, V2 and V3: the side-by-side views (modes 5/6) and the HSV flow view
(mode 3) at one blend position, and the grey flow view (mode 4) of a pair
(csrc/warp_views.cu).

Not TPU kernels: they replace XLA code of the JAX package that the port
ran as tensor ops.  V1 (``warp_sbs``) is ``ops/warp.warp_sbs``, the
counterpart of JAX ``ops/warp.py:1178 _warp_sbs``: f1 copied into the left
half (mode 5) or at half size into a band of rows on the left (mode 6),
the rest the nearest blend of mode 2 at each sample's adjusted coordinate,
then the level maps.  V2 (``warp_hsv``) is all of mode 3, the counterpart
of JAX ``ops/warp.py:785 _visualize_flow`` in the HSV branches of
``_warp_sample``: the two directions' raw samples, their fixed-point blend,
the colours of the flow at each sample's cell on the blend's 8-bit value
(float32, the JAX op order), then the level maps.  V3 (``warp_grey``) is
``ops/warp.grey_planes``, JAX ``ops/warp.py:945-951``: the flow's magnitude
on the luma grid and a mid-grey chroma plane; it reads no blend position,
so one launch serves every output of a pair.

Bound on the card: bytes -- one 4K position writes a plane pair (12.4 MB
at 8 bits, twice that under P010) and reads up to two source samples a
sample and the ~1 MB flow.  One launch covers luma and interleaved
chroma, one thread an output sample; t is read on the device, so the
launches can be captured in the grouped path's CUDA graphs.  V3 is bound
by its writes alone (12.4 MB at 4K, 8 bits), one thread a 16-byte run.

The plain versions: ``ops/warp.warp_sbs`` for V1, and for V2
``warp_hsv_plain``, the composition the engine ran before V2 (K5's plain
version for both directions, G1's at the default levels, ``ops/warp.
hsv_planes``, then ``levels_y`` / ``levels_uv``).  V1 is bit-exact with its
plain version; V2 is within DEVIATIONS #11's HSV tolerance of it (its
colours call atan2, whose last bit differs between libraries), and its
integer parts are exact.  V3's plain version is ``ops/warp.grey_planes``,
and V3 is bit-exact with it.  ``warp_sbs``, ``warp_hsv`` and
``warp_grey`` dispatch on the device: CPU tensors take the plain
versions, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import blend_levels
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample

sbs_counts = _build.LaunchCounts()
hsv_counts = _build.LaunchCounts()
grey_counts = _build.LaunchCounts()

warp_sbs_plain = W.warp_sbs
warp_grey_plain = W.grey_planes


def warp_hsv_plain(f1y, f1uv, f2y, f2uv, blurred, t, rs: int,
                   actual_width: int, scale_shift: int = 0,
                   levels=(0, 255)):
    """Mode 3 at one position as tensor ops: the raw samples of both
    directions, their blend at the default levels, recoloured by the flow
    and level-mapped."""
    args = (f1y, f1uv, f2y, f2uv, blurred, t)
    y12, uv12 = warp_sample.sample_dir_plain(*args, 12, rs, actual_width)
    y21, uv21 = warp_sample.sample_dir_plain(*args, 21, rs, actual_width)
    # the default levels clip the blend to 255 << scale_shift, which the
    # colours cannot see: they read the blend >> scale_shift
    b_y, b_uv = blend_levels.blend_levels_plain(y12, uv12, y21, uv21, t,
                                                scale_shift)
    b_y, b_uv = W.hsv_planes(b_y.to(torch.int32), b_uv.to(torch.int32),
                             blurred, rs, actual_width, scale_shift)
    k, w = levels
    return (W.levels_y(b_y, k, w, scale_shift).to(y12.dtype),
            W.levels_uv(b_uv, w, scale_shift).to(y12.dtype))


def _check(f1y, f1uv, f2y, f2uv, blurred, t, actual_width, scale_shift):
    H, pitch, sample = warp_pair.check_args(f1y, f1uv, f2y, f2uv, blurred,
                                            actual_width, scale_shift)
    if t.numel() != 1:
        raise ValueError(f"t must hold one blend position, got "
                         f"{tuple(t.shape)}")
    return H, pitch, sample


def _launch(entry: str, f1y, f1uv, f2y, f2uv, blurred, t, H: int,
            pitch: int, sample, rs: int, actual_width: int,
            scale_shift: int, levels, *mode):
    dev = f1y.device
    hc = H // 2
    _build.require(f1y, "f1y", sample, (H, pitch), dev)
    _build.require(f2y, "f2y", sample, (H, pitch), dev)
    _build.require(f1uv, "f1uv", sample, (hc, pitch), dev)
    _build.require(f2uv, "f2uv", sample, (hc, pitch), dev)
    _build.require(blurred, "blurred", torch.int32, None, dev)
    _build.require(t, "t", torch.float32, None, dev)
    _, lh, lw = blurred.shape
    k, w = levels
    y = torch.empty((H, actual_width), dtype=sample, device=dev)
    uv = torch.empty((hc, actual_width), dtype=sample, device=dev)
    rc = getattr(_build.load(), entry)(
        f1y.data_ptr(), f1uv.data_ptr(), f2y.data_ptr(), f2uv.data_ptr(),
        blurred.data_ptr(), t.data_ptr(), y.data_ptr(), uv.data_ptr(),
        *mode, H, actual_width, pitch, lh, lw, rs, scale_shift, k, w,
        _build.stream_of(f1y))
    _build.check(entry, rc)
    return y, uv


def warp_sbs(mode: int, f1y, f1uv, f2y, f2uv, blurred, t, rs: int,
             actual_width: int, scale_shift: int = 0, levels=(0, 255)):
    """Side-by-side mode 5 or 6 at one blend position (V1).

    f1y/f2y (H, stride) and f1uv/f2uv (H/2, stride) planes, uint8 for
    scale_shift 0 and uint16 for 8; blurred (2, lh, lw) int32; t a
    one-element float32 tensor on the planes' device; levels (k, w) ints
    on the 8-bit scale (``ops/warp.level_ints``).  Returns (y (H, Wa), uv
    (H/2, Wa)) of the planes' dtype, uv interleaved."""
    if mode not in (W.SIDE_BY_SIDE_1, W.SIDE_BY_SIDE_2):
        raise ValueError(f"mode {mode} is not a side-by-side mode")
    H, pitch, sample = _check(f1y, f1uv, f2y, f2uv, blurred, t,
                              actual_width, scale_shift)
    if f1y.device.type == "cpu":
        sbs_counts.plain += 1
        return warp_sbs_plain(mode, f1y, f1uv, f2y, f2uv, blurred, t, rs,
                              actual_width, scale_shift, levels)
    out = _launch("mfi_warp_sbs", f1y, f1uv, f2y, f2uv, blurred, t, H, pitch,
                  sample, rs, actual_width, scale_shift, levels, mode)
    sbs_counts.kernel += 1
    return out


def warp_hsv(f1y, f1uv, f2y, f2uv, blurred, t, rs: int, actual_width: int,
             scale_shift: int = 0, levels=(0, 255)):
    """Mode 3, the HSV flow view, at one blend position (V2); arguments and
    result as for ``warp_sbs``."""
    H, pitch, sample = _check(f1y, f1uv, f2y, f2uv, blurred, t,
                              actual_width, scale_shift)
    if f1y.device.type == "cpu":
        hsv_counts.plain += 1
        return warp_hsv_plain(f1y, f1uv, f2y, f2uv, blurred, t, rs,
                              actual_width, scale_shift, levels)
    out = _launch("mfi_warp_hsv", f1y, f1uv, f2y, f2uv, blurred, t, H, pitch,
                  sample, rs, actual_width, scale_shift, levels)
    hsv_counts.kernel += 1
    return out


def warp_grey(blurred, rs: int, rows: int, actual_width: int,
              scale_shift: int = 0, dtype=torch.uint8):
    """Mode 4, the grey flow view of a pair (V3): blurred (2, lh, lw) int32
    at res scalar `rs`; returns (y (rows, Wa), uv (rows/2, Wa)) of `dtype`
    (uint8 for scale_shift 0, uint16 for 8), as ``ops/warp.grey_planes``."""
    if scale_shift not in (0, 8):
        raise ValueError(f"scale_shift {scale_shift} is not 0 or 8")
    if blurred.dim() != 3 or blurred.shape[0] != 2:
        raise ValueError(f"blurred must be (2, lh, lw), got "
                         f"{tuple(blurred.shape)}")
    if blurred.device.type == "cpu":
        grey_counts.plain += 1
        return warp_grey_plain(blurred, rs, rows, actual_width, scale_shift,
                               dtype)
    if dtype != (torch.uint16 if scale_shift else torch.uint8):
        raise ValueError(f"{dtype} planes do not go with scale_shift "
                         f"{scale_shift}")
    dev = blurred.device
    _build.require(blurred, "blurred", torch.int32, None, dev)
    _, lh, lw = blurred.shape
    y = torch.empty((rows, actual_width), dtype=dtype, device=dev)
    uv = torch.empty((rows // 2, actual_width), dtype=dtype, device=dev)
    rc = _build.load().mfi_warp_grey(
        blurred.data_ptr(), y.data_ptr(), uv.data_ptr(), rows, actual_width,
        lh, lw, rs, scale_shift, _build.stream_of(blurred))
    _build.check("warp_grey", rc)
    grey_counts.kernel += 1
    return y, uv
