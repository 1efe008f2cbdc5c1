"""Q1: one bilinear blended position of the hopperq / hopperxq families
(csrc/warp_bilinear.cu).

Not a TPU kernel: the JAX package samples these families at 1/64 pel with
XLA (``ops/warp._bilinear_all_planes``, ``mpv_frame_interpolator_tpu/ops/
warp.py:521-595``, bit-identical to its gather path ``_bilinear_sample``,
:128-150) and blends, corrects (hopperxq) and level-maps the samples in
``_warp_sample``'s bilinear branch (:1007-1018, :1087-1105).  In plain
PyTorch a position is eight gathers, some thirty integer ops and a float
blend over every luma and chroma sample; Q1 is one launch that covers the
luma plane and the interleaved chroma plane on K5's 16-byte runs: a
thread a 16-byte output run of a row, the flow and both 1/64-pel
displacements once a flow-cell segment, interior segments read as
aligned windows of their two rows in both sources (every tap from
registers) and written with one 16-byte store, edge runs per sample; t
read on the device.  ``tests/test_torch_bilinear_runs.py`` models the
runs on the CPU.

Bound on the card: bytes -- a 4K position reads the two source frames
and the flow once and writes one (3 x 12.4 MB at 8 bits, ~11.5 us at
3.35 TB/s); with the cell's work shared a sample needs ~28 operations
(~49 with the occlusion correction), ~5-9 us at 67 TOP/s.

With the measured sub-pel flow (the ``subpel_flow`` option) the field is
K1's blur of the 1/64-pel field (offset << 6) + frac, handed over whole
(``subpel=True``, the kernel's ``kFrac`` instantiation): the positions
are taken from it directly and the back-projected cell from its floor
>> 6, which is what the JAX engine's split into flow = b >> 6 and frac =
b - (flow << 6), put back together as (flow << 6) + frac, gives.  So no
tensor op splits the field between K1 and Q1.

The card path opens the spans ``mfi.q1`` (its checks, allocations and
launch) and ``mfi.q1.alloc`` (the outputs' allocations) while a profiler
records (``utils/trace``).

``ops/warp.bilinear_blend`` (with ``bilinear_sample``) is the plain
version and the specification.  ``bilinear_blend`` here dispatches on the
device: CPU tensors take the plain version, CUDA tensors launch the
kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair
from mpv_frame_interpolator_tpu_torch.utils.trace import annotate

counts = _build.LaunchCounts()

bilinear_blend_plain = W.bilinear_blend


def bilinear_blend(f1y, f1uv, f2y, f2uv, blurred, t, rs: int,
                   actual_width: int, scale_shift: int = 0, levels=(0, 255),
                   occlusion: bool = False, subpel: bool = False,
                   vector: bool = True):
    """One blended position at 1/64-pel bilinear samples.

    f1y/f2y (H, stride) and f1uv/f2uv (H/2, stride) interleaved planes of
    the older and newer frame, uint8 for scale_shift 0 and uint16 for 8;
    blurred (2, lh, lw) int32 flow in pels, or with subpel True the
    sub-pel flow's 1/64-pel field; t a one-element float32 tensor on the
    planes' device; levels (k, w) as ints on the 8-bit scale
    (``ops/warp.level_ints``); occlusion True for hopperxq; vector False
    sends every run of a launch on the card through the per-sample step
    (otherwise the 16-byte runs where the planes allow them,
    ``warp_pair.vector_path``).  Returns (y (H, Wa), uv (H/2, Wa)
    interleaved) of the planes' dtype."""
    H, pitch, sample = warp_pair.check_args(f1y, f1uv, f2y, f2uv, blurred,
                                            actual_width, scale_shift)
    if actual_width % 2 or actual_width < 6:
        raise ValueError(f"actual width {actual_width} must be even and at "
                         "least 6 (chroma is sampled on half the columns)")
    if t.numel() != 1:
        raise ValueError(f"t must hold one blend position, got "
                         f"{tuple(t.shape)}")
    if f1y.device.type == "cpu":
        counts.plain += 1
        return bilinear_blend_plain(f1y, f1uv, f2y, f2uv, blurred, t, rs,
                                    actual_width, scale_shift, levels,
                                    occlusion, subpel)
    with annotate("mfi.q1"):
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
        with annotate("mfi.q1.alloc"):
            y = torch.empty((H, actual_width), dtype=sample, device=dev)
            uv = torch.empty((hc, actual_width), dtype=sample, device=dev)
        vec = vector and warp_pair.vector_path((f1y, f1uv, f2y, f2uv, y, uv),
                                               actual_width)
        rc = _build.load().mfi_bilinear_blend(
            f1y.data_ptr(), f1uv.data_ptr(), f2y.data_ptr(), f2uv.data_ptr(),
            blurred.data_ptr(), t.data_ptr(), y.data_ptr(), uv.data_ptr(), H,
            actual_width, pitch, lh, lw, rs, scale_shift, k, w,
            int(occlusion), int(subpel), int(vec), _build.stream_of(f1y))
        _build.check("bilinear_blend", rc)
        counts.kernel += 1
    return y, uv
