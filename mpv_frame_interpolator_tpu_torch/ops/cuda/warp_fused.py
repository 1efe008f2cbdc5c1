"""K4: one blended output for one blend position (csrc/warp_fused.cu).

Replaces the TPU kernel ``mpv_frame_interpolator_tpu/ops/pallas/
warp_fused.py:fused_blend_plane`` (via ``blended_from_prep``), which the
JAX engine launches once per blend position under
``warp_sampling="fused"``: the luma plane and the interleaved chroma plane
of one position, with the fixed-point blend (24 - (8 if scale_shift)
fraction bits), the black/white level maps and the cap 255 << scale_shift.
The TPU kernel serves only the default levels (the JAX engine routes other
levels to XLA); this one serves every case, with no gate and no fallback.

Bound on the card: bytes -- per 4K position one output written (12.4 MB
NV12, 24.9 MB P010) and the two sources read (~25 / ~50 MB).  One launch
covers both planes with K2's 16-byte runs at one position: a thread per
16-byte output run of a row, the flow read and the displacements computed
once a flow cell, interior runs read with aligned 16-byte loads and
written with one 16-byte store, edge runs per sample (see the headers of
csrc/warp_fused.cu and csrc/warp_runs.cuh).  ``warp_pair.vector_path``
says whether a launch may take the 16-byte path at all
(tests/test_torch_sample_runs.py models the runs on the CPU).

The plain version is K2's at N = 1.  ``fused_blend`` dispatches on the
device: CPU tensors take ``fused_blend_plain``, CUDA tensors launch the
kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair
from mpv_frame_interpolator_tpu_torch.utils.trace import annotate

counts = _build.LaunchCounts()


def fused_blend_plain(f1y, f1uv, f2y, f2uv, blurred, t, rs: int,
                      actual_width: int, scale_shift: int = 0,
                      levels=(0, 255)):
    y, uv = warp_pair.pair_blend_plain(f1y, f1uv, f2y, f2uv, blurred,
                                       t.reshape(1), rs, actual_width,
                                       scale_shift, levels)
    return y[0], uv[0]


def fused_blend(f1y, f1uv, f2y, f2uv, blurred, t, rs: int,
                actual_width: int, scale_shift: int = 0, levels=(0, 255)):
    """One blend position of one pair.

    The planes, flow, scale_shift and levels are as for
    ``warp_pair.pair_blend``; t is a one-element float32 tensor on the
    planes' device (the kernel reads it there, so a blend position that
    the card decided needs no host sync).  Returns (y (H, Wa), uv (H/2,
    Wa)) of the planes' dtype, uv interleaved."""
    H, pitch, sample = warp_pair.check_args(f1y, f1uv, f2y, f2uv, blurred,
                                            actual_width, scale_shift)
    if t.numel() != 1:
        raise ValueError(f"t must hold one blend position, got "
                         f"{tuple(t.shape)}")
    k, w = levels
    if f1y.device.type == "cpu":
        counts.plain += 1
        return fused_blend_plain(f1y, f1uv, f2y, f2uv, blurred, t, rs,
                                 actual_width, scale_shift, levels)
    with annotate("mfi.k4"):
        dev = f1y.device
        hc = H // 2
        _build.require(f1y, "f1y", sample, (H, pitch), dev)
        _build.require(f2y, "f2y", sample, (H, pitch), dev)
        _build.require(f1uv, "f1uv", sample, (hc, pitch), dev)
        _build.require(f2uv, "f2uv", sample, (hc, pitch), dev)
        _build.require(blurred, "blurred", torch.int32, None, dev)
        _build.require(t, "t", torch.float32, None, dev)
        _, lh, lw = blurred.shape
        with annotate("mfi.k4.alloc"):
            y = torch.empty((H, actual_width), dtype=sample, device=dev)
            uv = torch.empty((hc, actual_width), dtype=sample, device=dev)
        vec = warp_pair.vector_path((f1y, f1uv, f2y, f2uv, y, uv),
                                    actual_width)
        rc = _build.load().mfi_fused_blend(
            f1y.data_ptr(), f1uv.data_ptr(), f2y.data_ptr(), f2uv.data_ptr(),
            blurred.data_ptr(), t.data_ptr(), y.data_ptr(), uv.data_ptr(),
            H, actual_width, pitch, lh, lw, rs, scale_shift, k, w, int(vec),
            _build.stream_of(f1y))
        _build.check("fused_blend", rc)
        counts.kernel += 1
    return y, uv
