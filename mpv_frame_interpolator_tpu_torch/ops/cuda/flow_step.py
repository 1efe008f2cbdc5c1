"""K1: the flow pyramid and its single step (csrc/flow_step.cu).

Replaces the TPU kernel ``mpv_frame_interpolator_tpu/ops/pallas/
flow_step.py:flow_step_pallas`` plus its XLA tail ``flow_step_commit``,
and the ``lax.scan`` that runs them over the pyramid; the output equals
the JAX step branch ``ops/flow._make_step_branch`` whichever branch JAX
takes (Pallas, shift or gather fallback).

One kernel serves both entry points: ``flow_pyramid`` runs every step of
a pair (x then y at each window of the schedule) in one host call and one
cooperative launch, and ``flow_step`` is that launch with a schedule of
one step.  ``flow_pyramid(..., blur=True)`` also blurs the final field
(K3, the TPU kernel ``ops/pallas/blur.py:blur_flow_pallas``) as the
launch's last phase, after one more grid barrier, on K3's tile body
(csrc/blur_tile.cuh): the engine's flow and its blur are one launch.  A
4K step touches a few MB, so bytes do not bound it; the kernel keeps one
thread per low-res pixel with the layer partials in registers, reduces
them per window in the block and commits in place between grid-wide
barriers (PERF.md times each phase; what bounds the window sums is still
open).  See the header of csrc/flow_step.cu.  The kernel is templated on
the sample type: uint8 planes for NV12, uint16 for P010, whose SAD is
shifted right by `luma_shift` before the delta scalar.

Its work follows the search radius (1..256): it is instantiated on a
chunk of 5, 8 or 16 layers (``KERNEL_LAYERS``, the engine's default layer
buckets), and a launch runs the instantiation that serves the `layers`
the caller chose (``kernel_layers``); radii above 16 take 16-layer chunks
in a loop inside the launch.  The output depends on the radius alone.

Both entry points dispatch on the device of their tensors: CPU tensors
take ``flow_step_plain`` / ``flow_pyramid_plain``, CUDA tensors launch the
kernel (or raise).
"""

from __future__ import annotations

import ctypes

import torch

from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as _blur
from mpv_frame_interpolator_tpu_torch.ops.flow import (
    MAX_RADIUS, mirror_inside, signed_square)

counts = _build.LaunchCounts()
slice_counts = _build.LaunchCounts()     # the layer slice's

_MASK = 0xFFFFFFFF
MAX_STEPS = 64          # csrc/flow_step.cu kMaxSteps
MAX_WINDOW = 1 << 30
KERNEL_LAYERS = (5, 8, 16)   # the kernel's instantiations (layers a chunk)


def kernel_layers(radius: int, layers=None) -> int:
    """The layers a chunk of the instantiation that runs `radius` for a
    caller that chose `layers` (>= radius; None: the radius itself): the
    smallest of ``KERNEL_LAYERS`` that holds min(layers, 16), and 16 above
    a radius of 16 (16-layer chunks in a loop)."""
    layers = radius if layers is None else layers
    if layers < radius:
        raise ValueError(f"{layers} layers cannot serve radius {radius}")
    if radius > KERNEL_LAYERS[-1]:
        return KERNEL_LAYERS[-1]
    return next(b for b in KERNEL_LAYERS if b >= min(layers,
                                                     KERNEL_LAYERS[-1]))


def _window_sums_plain(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, is_y: int,
                       layers, radius: int, ds: int, nbs: int, window: int,
                       nb_enabled: bool, rs: int, H: int, W: int,
                       luma_shift: int):
    """One step's window sums of the candidate `layers` (a range of layer
    indices of `radius`), (len(layers), nwy, nwx) int64 in [0, 2^32):
    uint32 arithmetic is int64 masked to 32 bits, which gives exact
    mod-2^32 sums and unsigned order.  The planes are widened before they
    are indexed (CUDA does not index uint16)."""
    dev = off_x.device
    i64 = torch.int64
    f1y, f1u, f1v = (p.to(i64) for p in (f1y, f1u, f1v))
    lh, lw = off_x.shape
    n = len(layers)
    adj = signed_square(torch.tensor(list(layers), dtype=i64, device=dev)
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
    padded = torch.zeros((n, nwy * window, nwx * window), dtype=i64,
                         device=dev)
    padded[:, :lh, :lw] = partial
    sums = padded.reshape(n, nwy, window, nwx, window).sum(dim=(2, 4))
    return sums & _MASK


def commit_plain(off_x, off_y, is_y: int, lowest, radius: int, window: int):
    """Commit the winning layer of each window (`lowest`, (nwy, nwx)) to
    the stepped axis of every pixel of the window: its signed square
    added to the field."""
    lh, lw = off_x.shape
    nwy, nwx = lowest.shape
    adj = signed_square(lowest.to(torch.int64) - radius // 2).to(torch.int32)
    # each window's value over its window x window pixels (an expand, not
    # repeat_interleave, which synchronises a card to size its output)
    adj = adj[:, None, :, None].expand(nwy, window, nwx, window).reshape(
        nwy * window, nwx * window)[:lh, :lw]
    if is_y:
        return off_x, off_y + adj
    return off_x + adj, off_y


def flow_step_plain(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, is_y: int,
                    radius: int, ds: int, nbs: int, window: int,
                    nb_enabled: bool, rs: int, H: int, W: int,
                    luma_shift: int = 0):
    """The step in plain PyTorch: every layer's window sums, the first
    unsigned minimum of each window, the commit."""
    sums = _window_sums_plain(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, is_y,
                              range(radius), radius, ds, nbs, window,
                              nb_enabled, rs, H, W, luma_shift)
    lowest = torch.argmin(sums, dim=0)     # first minimum
    return commit_plain(off_x, off_y, is_y, lowest, radius, window)


def _as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def flow_layer_slice_plain(f1y, f1u, f1v, y2, u2, v2, off_x, off_y,
                           is_y: int, z0: int, n: int, radius: int, ds: int,
                           nbs: int, window: int, nb_enabled: bool, rs: int,
                           H: int, W: int, luma_shift: int = 0):
    """The layer slice in plain PyTorch: (min, layer), each (nwy, nwx)
    int32, the first unsigned minimum of the window sums of layers
    [z0, z0 + n) (its 32 bits) and the global layer that reaches it."""
    sums = _window_sums_plain(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, is_y,
                              range(z0, z0 + n), radius, ds, nbs, window,
                              nb_enabled, rs, H, W, luma_shift)
    best, arg = torch.min(sums, dim=0)      # first minimum
    return _as_int32_bits(best), (arg + z0).to(torch.int32)


def pyramid_steps(windows, first_nb_iteration: int):
    """(window, is_y, nb_enabled) of every step: the x axis then the y axis
    at each window, the neighbour bias from iteration `first_nb_iteration`
    on (ops/flow.py's loop, the JAX package's scan)."""
    return tuple((window, is_y, iteration >= first_nb_iteration)
                 for iteration, window in enumerate(windows)
                 for is_y in (0, 1))


def flow_pyramid_plain(f1y, f1u, f1v, y2, u2, v2, radius: int, ds: int,
                       nbs: int, windows, first_nb_iteration: int, rs: int,
                       H: int, W: int, luma_shift: int = 0):
    """The pyramid in plain PyTorch: the loop of ``flow_step_plain`` from
    a zero field.  Returns the (2, lh, lw) int32 field."""
    off_x = torch.zeros(y2.shape, dtype=torch.int32, device=y2.device)
    off_y = torch.zeros_like(off_x)
    for window, is_y, nb in pyramid_steps(windows, first_nb_iteration):
        off_x, off_y = flow_step_plain(f1y, f1u, f1v, y2, u2, v2, off_x,
                                       off_y, is_y, radius, ds, nbs, window,
                                       nb, rs, H, W, luma_shift)
    return torch.stack([off_x, off_y])


def _check_scalars(radius: int, ds: int, nbs: int, luma_shift: int, steps):
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius} outside [1, {MAX_RADIUS}]")
    if not (0 <= ds <= 31 and 0 <= nbs <= 31):
        raise ValueError("delta and neighbour-bias scalars must be in "
                         "[0, 31]")
    if not 0 <= luma_shift <= 31:
        raise ValueError(f"luma_shift {luma_shift} outside [0, 31]")
    if len(steps) > MAX_STEPS:
        raise ValueError(f"{len(steps)} steps, at most {MAX_STEPS}")
    for window, is_y, _ in steps:
        if is_y not in (0, 1):
            raise ValueError("is_y must be 0 or 1")
        if not 1 <= window <= MAX_WINDOW or window & (window - 1):
            # window indices are shifts; the pyramid's windows are
            # halvings of a power of two
            raise ValueError(f"window {window} is not a power of two in "
                             f"[1, 2^30]")


def _require_planes(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, rs: int,
                    H: int, W: int):
    """The checks of a launch on the card: CUDA planes of one sample type
    (uint8 or uint16), the probe and the field (when given) at the low-res
    shape, f1 at least H x W, the field inside the frame."""
    lh, lw = y2.shape
    dev = y2.device
    sample = f1y.dtype
    if sample not in (torch.uint8, torch.uint16):
        raise ValueError(f"planes must be uint8 or uint16, got {sample}")
    for name, t in (("y2", y2), ("u2", u2), ("v2", v2)):
        _build.require(t, name, sample, (lh, lw), dev)
    if off_x is not None:
        _build.require(off_x, "off_x", torch.int32, (lh, lw), dev)
        _build.require(off_y, "off_y", torch.int32, (lh, lw), dev)
    _build.require(f1y, "f1y", sample, None, dev)
    _build.require(f1u, "f1u", sample, None, dev)
    _build.require(f1v, "f1v", sample, f1u.shape, dev)
    if f1y.shape[0] < H or f1y.shape[1] < W or \
            f1u.shape[0] < H // 2 or f1u.shape[1] < W // 2:
        raise ValueError(f"f1 planes {tuple(f1y.shape)}/"
                         f"{tuple(f1u.shape)} smaller than {H}x{W}")
    if (lh - 1) << rs >= H or (lw - 1) << rs >= W:
        raise ValueError("low-res field does not fit the frame")


def _launch(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, steps, radius: int,
            ds: int, nbs: int, rs: int, H: int, W: int, luma_shift: int,
            timeline=None, blur: bool = False, layers=None):
    """One cooperative launch of the pyramid kernel over `steps`, from
    (off_x, off_y), or from zero when both are None, on the instantiation
    ``kernel_layers(radius, layers)``.  Returns the (2, lh, lw) int32
    field it wrote, or (field, its blur) with `blur`."""
    if timeline is not None:
        _build.require(timeline, "timeline", torch.int64,
                       (2 + 2 * len(steps) + int(blur),), y2.device)
    _require_planes(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, rs, H, W)
    lh, lw = y2.shape
    dev = y2.device
    # one sums buffer holds the largest step's window sums, or a window-1
    # step's per-pixel winners; the kernel ping-pongs between two
    words = max([radius * -(-lh // w) * -(-lw // w) for w, _, _ in steps
                 if w > 1] + [lh * lw if any(w == 1 for w, _, _ in steps)
                              else 1])
    if words >= 1 << 31:
        raise ValueError(f"{words} sums words do not fit the kernel's int")
    field = torch.empty((2, lh, lw), dtype=torch.int32, device=dev)
    blurred = torch.empty_like(field) if blur else None
    sums = torch.empty((2, words), dtype=torch.int32, device=dev)
    codes = (ctypes.c_int * max(len(steps), 1))(*(
        (w.bit_length() - 1) | (is_y << 8) | (int(bool(nb)) << 9)
        for w, is_y, nb in steps))
    start = (None, None) if off_x is None else (off_x.data_ptr(),
                                                off_y.data_ptr())
    rc = _build.load().mfi_flow_pyramid(
        f1y.data_ptr(), f1u.data_ptr(), f1v.data_ptr(), y2.data_ptr(),
        u2.data_ptr(), v2.data_ptr(), *start, field.data_ptr(),
        None if blurred is None else blurred.data_ptr(), sums.data_ptr(),
        codes, len(steps), words, kernel_layers(radius, layers), radius,
        ds, nbs, rs, H, W, lh, lw,
        f1y.shape[1], f1u.shape[1], f1y.element_size(), luma_shift,
        None if timeline is None else timeline.data_ptr(),
        _build.stream_of(y2))
    _build.check("flow_pyramid", rc)
    counts.kernel += 1
    if blurred is None:
        return field
    _blur.counts.fused += 1
    return field, blurred


def flow_pyramid(f1y, f1u, f1v, y2, u2, v2, radius: int, ds: int, nbs: int,
                 windows, first_nb_iteration: int, rs: int, H: int, W: int,
                 luma_shift: int = 0, timeline=None, blur: bool = False,
                 layers=None):
    """Every step of one pair's pyramid, from a zero field: the x axis then
    the y axis at each window of `windows`, the neighbour bias from
    iteration `first_nb_iteration` on.  Planes as for ``flow_step``;
    `layers` (>= radius, default the radius) picks the kernel's
    instantiation (``kernel_layers``) and leaves the output as it is.
    Returns the (2, lh, lw) int32 field, plane 0 the x offsets and plane 1
    the y offsets; with `blur`, (field, its 8x8 blur), on the card from
    the same launch (``blur.counts.fused``), on the CPU from
    ``blur.blur_flow``.

    `timeline`, for measurement on the card only: an int64 tensor of 2 + 4
    x len(windows) entries (one more with `blur`) that receives the card's
    clock in ns at the launch's start, after its prologue, after each
    phase (sums, then commit) of each step, with a barrier after the last
    step, and after the blur phase."""
    steps = pyramid_steps(windows, first_nb_iteration)
    _check_scalars(radius, ds, nbs, luma_shift, steps)
    kernel_layers(radius, layers)
    if y2.device.type == "cpu":
        counts.plain += 1
        field = flow_pyramid_plain(f1y, f1u, f1v, y2, u2, v2, radius, ds,
                                   nbs, windows, first_nb_iteration, rs, H,
                                   W, luma_shift)
        return (field, _blur.blur_flow(field)) if blur else field
    return _launch(f1y, f1u, f1v, y2, u2, v2, None, None, steps, radius, ds,
                   nbs, rs, H, W, luma_shift, timeline, blur, layers)


def blocks_per_sm(sample_bytes: int, layers: int = 16,
                  radius: int = 16) -> int:
    """The resident blocks an SM on the current card of the pyramid
    kernel that serves (layers, radius) (its cooperative grid is this
    times the SMs, at most one block a tile)."""
    per_sm = ctypes.c_int()
    _build.check("flow_pyramid_occupancy", _build.load()
                 .mfi_flow_pyramid_occupancy(
                     sample_bytes, kernel_layers(radius, layers), radius,
                     ctypes.byref(per_sm)))
    return per_sm.value


def flow_step(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, is_y: int,
              radius: int, ds: int, nbs: int, window: int, nb_enabled: bool,
              rs: int, H: int, W: int, luma_shift: int = 0, layers=None):
    """One pyramid step on axis `is_y` (0: x, 1: y).

    f1y (H', W') and f1u/f1v (H'/2, W'/2) are the older frame's planes
    (H' >= H rows, W' >= W columns); y2/u2/v2 (lh, lw) the newer frame's
    probe samples (ops/flow.subsampled_f2), all uint8 or all uint16;
    off_x/off_y (lh, lw) int32 the committed field.  H and W are the
    frame height and stride, against which the candidates mirror; each
    candidate's SAD is shifted right by `luma_shift` (8 for P010).
    Returns the new (off_x, off_y); the axis not stepped is returned as
    it was given.  `layers` as for ``flow_pyramid``."""
    _check_scalars(radius, ds, nbs, luma_shift,
                   ((window, is_y, nb_enabled),))
    kernel_layers(radius, layers)
    if off_x.device.type == "cpu":
        counts.plain += 1
        return flow_step_plain(f1y, f1u, f1v, y2, u2, v2, off_x, off_y,
                               is_y, radius, ds, nbs, window, nb_enabled,
                               rs, H, W, luma_shift)
    field = _launch(f1y, f1u, f1v, y2, u2, v2, off_x, off_y,
                    ((window, is_y, nb_enabled),), radius, ds, nbs, rs, H, W,
                    luma_shift, layers=layers)
    return (off_x, field[1]) if is_y else (field[0], off_y)



def flow_layer_slice(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, is_y: int,
                     z0: int, n: int, radius: int, ds: int, nbs: int,
                     window: int, nb_enabled: bool, rs: int, H: int, W: int,
                     luma_shift: int = 0):
    """K1's layer slice: one pyramid step's window sums over the layers
    [z0, z0 + n) of `radius` (candidates at signed_square(z - radius//2),
    phase A's sums mod 2^32 with the probe and neighbour biases) and, per
    window (nwy, nwx), their first minimum in unsigned order and the
    global layer that reaches it; no commit.  Returns (min, layer), each
    (nwy, nwx) int32 (min holds the 32 bits of the unsigned sum).  Planes
    and the field as for ``flow_step``; the field is read, not written.

    The layer-sharded flow (parallel/sharding.py) runs one slice a rank
    and step.  CPU tensors take ``flow_layer_slice_plain``; CUDA tensors
    launch the slice kernel (csrc/flow_step.cu ``mfi_flow_layer_slice``,
    its own entry: the pyramid kernel's instantiations are untouched) or
    raise.  ``slice_counts`` counts its launches."""
    _check_scalars(radius, ds, nbs, luma_shift,
                   ((window, is_y, nb_enabled),))
    if not (n >= 1 and z0 >= 0 and z0 + n <= radius):
        raise ValueError(f"layers [{z0}, {z0 + n}) are not a slice of "
                         f"radius {radius}")
    if off_x.device.type == "cpu":
        slice_counts.plain += 1
        return flow_layer_slice_plain(f1y, f1u, f1v, y2, u2, v2, off_x,
                                      off_y, is_y, z0, n, radius, ds, nbs,
                                      window, nb_enabled, rs, H, W,
                                      luma_shift)
    _require_planes(f1y, f1u, f1v, y2, u2, v2, off_x, off_y, rs, H, W)
    lh, lw = y2.shape
    dev = y2.device
    nwy, nwx = -(-lh // window), -(-lw // window)
    sums = torch.empty((n, nwy, nwx), dtype=torch.int32, device=dev)
    best = torch.empty((nwy, nwx), dtype=torch.int32, device=dev)
    arg = torch.empty_like(best)
    rc = _build.load().mfi_flow_layer_slice(
        f1y.data_ptr(), f1u.data_ptr(), f1v.data_ptr(), y2.data_ptr(),
        u2.data_ptr(), v2.data_ptr(), off_x.data_ptr(), off_y.data_ptr(),
        sums.data_ptr(), best.data_ptr(), arg.data_ptr(), z0, n, radius,
        window.bit_length() - 1, is_y, int(bool(nb_enabled)), ds, nbs, rs,
        H, W, lh, lw, f1y.shape[1], f1u.shape[1], f1y.element_size(),
        luma_shift, _build.stream_of(y2))
    _build.check("flow_layer_slice", rc)
    slice_counts.kernel += 1
    return best, arg
