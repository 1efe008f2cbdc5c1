"""K5: the raw nearest samples of one direction (csrc/warp_sample.cu).

Replaces the TPU kernel ``mpv_frame_interpolator_tpu/ops/pallas/
warp_sample.py:shift_sample_pallas``, the luma sampler of the JAX
package's shift decomposition under ``warp_sampling="pallas"``: for one
blend position and one direction, the luma plane and the interleaved
chroma plane sampled at each output pixel's mirrored, flow-displaced
coordinate, with no blend, no levels and no cap.  Output modes 0 and 1
are one call; the "pallas" sampler of mode 2 and model hopperx are two,
blended by the caller (ops/warp.py holds the pieces).

Bound on the card: bytes -- per 4K launch one plane pair written (12.4 MB
NV12, 24.9 MB P010), as many source samples read and the ~1 MB flow:
~7.7 us at 8 bits, ~15 us at P010.  One launch covers both planes with
K2's 16-byte runs: a thread per 16-byte output run of a row, one flow
lookup and one displacement a flow cell, interior runs read with aligned
16-byte loads and written with one 16-byte store, edge runs per sample;
none of the TPU kernel's tables, tiles, bitmasks or budget is carried
over (see csrc/warp_sample.cu and csrc/warp_runs.cuh).
``warp_pair.vector_path`` says whether a launch may take the 16-byte path
at all (tests/test_torch_sample_runs.py models the runs on the CPU).

``sample_dir`` dispatches on the device: CPU tensors take
``ops/warp.sample_dir`` (the plain version), CUDA tensors launch the
kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair

counts = _build.LaunchCounts()

sample_dir_plain = W.sample_dir


def sample_dir(f1y, f1uv, f2y, f2uv, blurred, t, direction: int, rs: int,
               actual_width: int):
    """The raw samples of one direction at one blend position.

    f1y/f2y (H, stride) and f1uv/f2uv (H/2, stride) planes of the older
    and newer frame, uint8 (NV12) or uint16 (P010); blurred (2, lh, lw)
    int32 flow; t a one-element float32 tensor on the planes' device;
    direction 12 (f1 along the flow) or 21 (f2 against the reverse
    flow).  Returns (y (H, Wa), uv (H/2, Wa)) of the planes' dtype, uv
    interleaved."""
    scale_shift = 8 if f1y.dtype == torch.uint16 else 0
    H, pitch, sample = warp_pair.check_args(f1y, f1uv, f2y, f2uv, blurred,
                                            actual_width, scale_shift)
    if t.numel() != 1:
        raise ValueError(f"t must hold one blend position, got "
                         f"{tuple(t.shape)}")
    if direction not in (12, 21):
        raise ValueError(f"direction must be 12 or 21, got {direction}")
    if f1y.device.type == "cpu":
        counts.plain += 1
        return sample_dir_plain(f1y, f1uv, f2y, f2uv, blurred, t, direction,
                                rs, actual_width)
    dev = f1y.device
    hc = H // 2
    _build.require(f1y, "f1y", sample, (H, pitch), dev)
    _build.require(f2y, "f2y", sample, (H, pitch), dev)
    _build.require(f1uv, "f1uv", sample, (hc, pitch), dev)
    _build.require(f2uv, "f2uv", sample, (hc, pitch), dev)
    _build.require(blurred, "blurred", torch.int32, None, dev)
    _build.require(t, "t", torch.float32, None, dev)
    src_y, src_uv = (f1y, f1uv) if direction == 12 else (f2y, f2uv)
    _, lh, lw = blurred.shape
    y = torch.empty((H, actual_width), dtype=sample, device=dev)
    uv = torch.empty((hc, actual_width), dtype=sample, device=dev)
    vec = warp_pair.vector_path((src_y, src_uv, y, uv), actual_width)
    rc = _build.load().mfi_sample_dir(
        src_y.data_ptr(), src_uv.data_ptr(), blurred.data_ptr(),
        t.data_ptr(), y.data_ptr(), uv.data_ptr(), H, actual_width, pitch,
        lh, lw, rs, direction, sample.itemsize, int(vec),
        _build.stream_of(f1y))
    _build.check("sample_dir", rc)
    counts.kernel += 1
    return y, uv
