"""K1: one pyramid step of the flow search (csrc/flow_step.cu).

Replaces the TPU kernel ``mpv_frame_interpolator_tpu/ops/pallas/
flow_step.py:flow_step_pallas`` plus its XLA tail ``flow_step_commit``;
the output equals the JAX step branch ``ops/flow._make_step_branch``
whichever branch JAX takes (Pallas, shift or gather fallback).

Bound on the card: launch latency and the window-sum atomics, not bytes
(a 4K step touches a few MB); the kernel pre-reduces each warp's partials
per window with shuffles so one atomic per window and warp reaches memory,
and a second launch takes the per-window argmin and commits.  See the
header of csrc/flow_step.cu.  The kernel is templated on the sample type:
uint8 planes for NV12, uint16 for P010, whose SAD is shifted right by
`luma_shift` before the delta scalar.

``flow_step`` dispatches on the device of its tensors: CPU tensors take
``flow_step_plain``, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.flow import (
    mirror_inside, signed_square)

counts = _build.LaunchCounts()

_MASK = 0xFFFFFFFF


def flow_step_plain(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, is_y: int,
                    radius: int, ds: int, nbs: int, window: int,
                    nb_enabled: bool, rs: int, H: int, W: int,
                    luma_shift: int = 0):
    """The step in plain PyTorch; uint32 arithmetic is int64 masked to
    32 bits, which gives exact mod-2^32 sums and unsigned order.  The
    planes are widened before they are indexed (CUDA does not index
    uint16)."""
    dev = off_x.device
    i64 = torch.int64
    f1y, f1u, f1v = (p.to(i64) for p in (f1y, f1u, f1v))
    lh, lw = off_x.shape
    adj = signed_square(torch.arange(radius, dtype=i64, device=dev)
                        - radius // 2)[:, None, None]
    cand_x = off_x.to(i64)[None] + adj * (1 - is_y)
    cand_y = off_y.to(i64)[None] + adj * is_y
    probe = cand_y if is_y else cand_x
    cy = (torch.arange(lh, dtype=i64, device=dev) << rs)[None, :, None]
    cx = (torch.arange(lw, dtype=i64, device=dev) << rs)[None, None, :]
    ncx = mirror_inside(cx + cand_x, W)
    ncy = mirror_inside(cy + cand_y, H)
    sad = ((f1y[ncy, ncx] - y2.to(i64)).abs()
           + (f1u[ncy >> 1, ncx >> 1] - u2.to(i64)).abs()
           + (f1v[ncy >> 1, ncx >> 1] - v2.to(i64)).abs())
    partial = ((sad >> luma_shift) << ds) + probe.abs()
    if nb_enabled:
        prev = (off_y if is_y else off_x).to(i64)
        w2 = 2 * window
        xs = torch.arange(lw, device=dev)
        ys = torch.arange(lh, device=dev)
        nb = torch.zeros_like(partial)
        for n_off in (prev[:, (xs + w2).clamp(max=lw - 1)],
                      prev[:, (xs - w2).clamp(min=0)],
                      prev[(ys + w2).clamp(max=lh - 1)],
                      prev[(ys - w2).clamp(min=0)]):
            nb = nb + (n_off[None] - probe).abs()
        partial = partial + ((nb << nbs) & _MASK)
    partial = partial & _MASK
    nwy, nwx = -(-lh // window), -(-lw // window)
    padded = torch.zeros((radius, nwy * window, nwx * window), dtype=i64,
                         device=dev)
    padded[:, :lh, :lw] = partial
    sums = padded.reshape(radius, nwy, window, nwx, window).sum(dim=(2, 4))
    lowest = torch.argmin(sums & _MASK, dim=0)     # first minimum
    adj2 = signed_square(lowest - radius // 2).to(torch.int32)
    adj2 = adj2.repeat_interleave(window, 0).repeat_interleave(window, 1)
    adj2 = adj2[:lh, :lw]
    if is_y:
        return off_x, off_y + adj2
    return off_x + adj2, off_y


def flow_step(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, is_y: int,
              radius: int, ds: int, nbs: int, window: int, nb_enabled: bool,
              rs: int, H: int, W: int, luma_shift: int = 0):
    """One pyramid step on axis `is_y` (0: x, 1: y).

    f1y (H', W') and f1u/f1v (H'/2, W'/2) are the older frame's planes
    (H' >= H rows, W' >= W columns); y2/u2/v2 (lh, lw) the newer frame's
    probe samples (ops/flow.subsampled_f2), all uint8 or all uint16;
    off_x/off_y (lh, lw) int32 the committed field.  H and W are the
    frame height and stride, against which the candidates mirror; each
    candidate's SAD is shifted right by `luma_shift` (8 for P010).
    Returns the new (off_x, off_y); the axis not stepped is returned as
    it was given."""
    if not 1 <= radius <= 16:
        raise ValueError(f"radius {radius} outside [1, 16]")
    if not (0 <= ds <= 31 and 0 <= nbs <= 31):
        raise ValueError("delta and neighbour-bias scalars must be in "
                         "[0, 31]")
    if is_y not in (0, 1):
        raise ValueError("is_y must be 0 or 1")
    if not 0 <= luma_shift <= 31:
        raise ValueError(f"luma_shift {luma_shift} outside [0, 31]")
    if window < 1 or window & (window - 1):
        # the kernel's per-warp window segments need a power of two; the
        # pyramid's windows always are (halvings of a power of two)
        raise ValueError(f"window {window} is not a power of two")
    if off_x.device.type == "cpu":
        counts.plain += 1
        return flow_step_plain(f1y, f1u, f1v, y2, u2, v2, off_x, off_y,
                               is_y, radius, ds, nbs, window, nb_enabled,
                               rs, H, W, luma_shift)
    lh, lw = off_x.shape
    dev = off_x.device
    i32 = torch.int32
    sample = f1y.dtype
    if sample not in (torch.uint8, torch.uint16):
        raise ValueError(f"planes must be uint8 or uint16, got {sample}")
    _build.require(off_x, "off_x", i32, (lh, lw), dev)
    _build.require(off_y, "off_y", i32, (lh, lw), dev)
    for name, t in (("y2", y2), ("u2", u2), ("v2", v2)):
        _build.require(t, name, sample, (lh, lw), dev)
    _build.require(f1y, "f1y", sample, None, dev)
    _build.require(f1u, "f1u", sample, None, dev)
    _build.require(f1v, "f1v", sample, f1u.shape, dev)
    if f1y.shape[0] < H or f1y.shape[1] < W or \
            f1u.shape[0] < H // 2 or f1u.shape[1] < W // 2:
        raise ValueError(f"f1 planes {tuple(f1y.shape)}/"
                         f"{tuple(f1u.shape)} smaller than {H}x{W}")
    if (lh - 1) << rs >= H or (lw - 1) << rs >= W:
        raise ValueError("low-res field does not fit the frame")
    nwy, nwx = -(-lh // window), -(-lw // window)
    out = torch.empty_like(off_x)
    sums = torch.empty((radius, nwy, nwx), dtype=i32, device=dev)
    lib = _build.load()
    rc = lib.mfi_flow_step(
        f1y.data_ptr(), f1u.data_ptr(), f1v.data_ptr(), y2.data_ptr(),
        u2.data_ptr(), v2.data_ptr(), off_x.data_ptr(), off_y.data_ptr(),
        out.data_ptr(), sums.data_ptr(), is_y, radius, ds, nbs, window,
        int(bool(nb_enabled)), rs, H, W, lh, lw, f1y.shape[1],
        f1u.shape[1], f1y.element_size(), luma_shift,
        _build.stream_of(off_x))
    _build.check("flow_step", rc)
    counts.kernel += 1
    return (off_x, out) if is_y else (out, off_y)
