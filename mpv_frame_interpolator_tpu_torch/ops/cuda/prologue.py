"""C1: the pair's prologue (csrc/pair_prologue.cu).

Not a TPU kernel: it replaces the XLA code of the JAX package's source
step (``pipeline/engine.py:683 _make_source_step``) before and around the
flow, which the port ran as ~18 tensor ops a pair.  One launch a pair
computes

* the scene-cut score of ``pipeline/scene.cut_score`` (JAX
  ``pipeline/scene.py:19``), a 0-dim float32 tensor, with scene detection
  on;
* the cut, ``score > threshold`` in float32, as a 0-dim int32 flag (0
  with scene detection off), added to the engine's device count of cuts;
  K1 reads the flag in its blur phase and zeroes the blurred field there
  (``ops/flow.flow(..., cut=)``);
* the folded blend positions, a new (N,) float32 tensor (JAX
  ``engine.py:538-554``): under a cut "nearest" snaps each to the nearer
  source and "hold" to 0, then model "repeat" snaps every position;
* for the flow families, f2's probe of ``ops/flow.subsampled_f2`` (JAX
  ``ops/flow._subsampled_f2``), which K1 reads.

So the main path's pair is three launches: C1, K1, K2.  Bound on the card:
bytes, ~0.9 MB at 4K (the sampled bytes read once, the probe written), far
below the launch itself; see the header of the source for the design (a cooperative launch whose
blocks write partial sums to scratch and block 0 sums them in a fixed
order: no state survives a launch, so it is safe under graph replay and
on concurrent streams).

``pair_prologue`` dispatches on the device of its tensors: CPU tensors
take ``pair_prologue_plain`` (the composition the engine ran before C1),
CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.flow import (
    FlowGeometry, subsampled_f2)
from mpv_frame_interpolator_tpu_torch.pipeline.scene import cut_score
from mpv_frame_interpolator_tpu_torch.utils.trace import annotate

counts = _build.LaunchCounts()
MAX_BLOCKS = 1024       # csrc/pair_prologue.cu kMaxBlocks: the partials
CUT_POLICIES = ("nearest", "hold")


class Prologue(NamedTuple):
    """What one pair's prologue gives the rest of the pair."""

    score: Optional[torch.Tensor]   # 0-dim float32; None: no detection
    cut: Optional[torch.Tensor]     # 0-dim int32 flag; None: no launch
    ts: torch.Tensor                # (N,) float32 folded positions
    probe: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def pair_prologue_plain(geom: FlowGeometry, y1, y2, f2u, f2v, ts, cuts,
                        bit_shift: int, scene_enabled: bool,
                        threshold: float, cut_policy: str, repeat: bool,
                        probe: bool) -> Prologue:
    """The prologue as tensor ops on the device of its tensors: the
    composition the engine ran before C1 (``scene.cut_score``, the cut,
    the fold of JAX engine.py:538-554 and ``ops/flow.subsampled_f2``).
    Where the cut is set, "nearest" snaps each position to 0 or 1 and
    "hold" to 0; then `repeat` snaps every position.  `ts` is never
    written: the positions are a new tensor, or `ts` where nothing
    folds."""
    score = cut = None
    if scene_enabled:
        score = cut_score(y1, y2, geom.res_scalar, bit_shift)
        cut = score > threshold
        cuts.add_(cut)
        ts_cut = ((ts >= 0.5).to(torch.float32) if cut_policy == "nearest"
                  else torch.zeros_like(ts))
        ts = torch.where(cut, ts_cut, ts)
    if repeat:
        ts = (ts >= 0.5).to(torch.float32)
    flag = (cut.to(torch.int32) if cut is not None
            else torch.zeros((), dtype=torch.int32, device=y1.device))
    planes = subsampled_f2(geom, y2, f2u, f2v) if probe else None
    return Prologue(score, flag, ts, planes)


def _check(geom: FlowGeometry, y1, y2, f2u, f2v, ts, cuts, bit_shift: int,
           cut_policy: str, probe: bool):
    if cut_policy not in CUT_POLICIES:
        raise ValueError(f"cut_policy must be one of {CUT_POLICIES}")
    if not 0 <= bit_shift <= 15:
        raise ValueError(f"bit_shift {bit_shift} outside [0, 15]")
    if y1.dim() != 2 or y1.shape != y2.shape:
        raise ValueError(f"the luma planes {tuple(y1.shape)} and "
                         f"{tuple(y2.shape)} are not one (H, stride) shape")
    if ts.dim() != 1:
        raise ValueError(f"ts must be (N,), got {tuple(ts.shape)}")
    if cuts.dim() != 0:
        raise ValueError("cuts must be a 0-dim count")
    if probe:
        rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
        rows, cols = y2.shape
        if (lh - 1) << rs >= rows or (lw - 1) << rs >= cols or \
                ((lh - 1) << rs) >> 1 >= f2u.shape[0] or \
                ((lw - 1) << rs) >> 1 >= f2u.shape[1]:
            raise ValueError(f"the probe's grid {lh}x{lw} at res scalar "
                             f"{rs} does not fit the planes")


def scratch(device) -> torch.Tensor:
    """A caller's scratch for C1's partial sums (MAX_BLOCKS int64).  Every
    launch writes each entry it reads before its grid barrier, so launches
    in one stream's order may share one (an engine keeps its own and hands
    it to every pair, eager or captured); launches that may overlap, on two
    streams, need two."""
    return torch.empty(MAX_BLOCKS, dtype=torch.int64, device=device)


def _require(geom: FlowGeometry, y1, y2, f2u, f2v, ts, cuts, partials,
             probe: bool):
    """The card's checks of C1's inputs, beyond ``_check``."""
    dev, sample = y1.device, y1.dtype
    if sample not in (torch.uint8, torch.uint16):
        raise ValueError(f"planes must be uint8 or uint16, got {sample}")
    rows, cols = y1.shape
    for name, t in (("y1", y1), ("y2", y2)):
        _build.require(t, name, sample, (rows, cols), dev)
    _build.require(ts, "ts", torch.float32, None, dev)
    _build.require(cuts, "cuts", torch.int32, (), dev)
    if partials is not None:
        _build.require(partials, "partials", torch.int64, (MAX_BLOCKS,), dev)
    s = 1 << geom.res_scalar
    if -(-rows // s) * -(-cols // s) >= 1 << 31:
        raise ValueError("the score's grid does not fit the kernel's int")
    if probe:
        for name, t in (("f2u", f2u), ("f2v", f2v)):
            _build.require(t, name, sample, f2u.shape, dev)


def _outputs(geom: FlowGeometry, y1, ts, scene_enabled: bool,
             probe: bool) -> Prologue:
    """C1's outputs, allocated (nothing written yet); the probe's three
    planes are one allocation, since each allocation costs the host more
    than the kernel takes on the card."""
    dev = y1.device
    planes = (torch.empty((3, geom.low_h, geom.low_w), dtype=y1.dtype,
                          device=dev).unbind(0) if probe else None)
    score = (torch.empty((), dtype=torch.float32, device=dev)
             if scene_enabled else None)
    return Prologue(score, torch.empty((), dtype=torch.int32, device=dev),
                    torch.empty_like(ts), planes)


def _launch(geom: FlowGeometry, y1, y2, f2u, f2v, ts, cuts, partials,
            out: Prologue, bit_shift: int, threshold: float,
            cut_policy: str, repeat: bool):
    """The one launch of C1 into `out`, on y1's current stream."""
    probe = out.probe is not None
    ptr = (lambda t: None if t is None else t.data_ptr())
    planes = out.probe if probe else (None, None, None)
    rows, cols = y1.shape
    rc = _build.load().mfi_pair_prologue(
        y1.data_ptr(), y2.data_ptr(), ptr(f2u if probe else None),
        ptr(f2v if probe else None), ts.data_ptr(), out.ts.data_ptr(),
        *(ptr(p) for p in planes), ptr(out.score), out.cut.data_ptr(),
        cuts.data_ptr(), partials.data_ptr(), ts.numel(), rows, cols,
        y1.stride(0), f2u.stride(0) if probe else 0, geom.res_scalar,
        geom.low_h, geom.low_w, y1.element_size(), bit_shift,
        int(out.score is not None), int(cut_policy == "nearest"),
        int(repeat), float(threshold), _build.stream_of(y1))
    _build.check("pair_prologue", rc)
    counts.kernel += 1


def pair_prologue(geom: FlowGeometry, y1, y2, f2u, f2v, ts, cuts,
                  bit_shift: int = 0, scene_enabled: bool = True,
                  threshold: float = 28.0, cut_policy: str = "nearest",
                  repeat: bool = False, probe: bool = True,
                  partials: Optional[torch.Tensor] = None) -> Prologue:
    """One pair's prologue (C1).

    y1, y2: the pair's (H, stride) luma planes (older, newer), uint8, or
    uint16 with `bit_shift` 8 (P010: the score on the 8-bit scale); f2u,
    f2v: the newer frame's planar chroma (H/2, stride/2); ts: the (N,)
    float32 blend positions, never written; cuts: the engine's 0-dim int32
    count of cuts, added to in place.  `threshold` is compared in float32;
    `cut_policy` "nearest" or "hold"; `repeat` for model "repeat"; `probe`
    for the flow families (the geometry's (lh, lw) probe planes);
    `partials` the caller's ``scratch`` on the card (None: a new one).
    Returns a ``Prologue``: score (None without scene detection), cut flag,
    folded positions (on the card a new tensor) and the probe (or None).
    With no scene detection, no probe and no "repeat" there is nothing to
    compute: no launch, and ``Prologue(None, None, ts, None)``."""
    _check(geom, y1, y2, f2u, f2v, ts, cuts, bit_shift, cut_policy, probe)
    if not (scene_enabled or probe or repeat):
        return Prologue(None, None, ts, None)
    if y1.device.type == "cpu":
        counts.plain += 1
        return pair_prologue_plain(geom, y1, y2, f2u, f2v, ts, cuts,
                                   bit_shift, scene_enabled, threshold,
                                   cut_policy, repeat, probe)
    with annotate("mfi.c1"):
        _require(geom, y1, y2, f2u, f2v, ts, cuts, partials, probe)
        with annotate("mfi.c1.alloc"):
            out = _outputs(geom, y1, ts, scene_enabled, probe)
            if partials is None:
                partials = scratch(y1.device)
        _launch(geom, y1, y2, f2u, f2v, ts, cuts, partials, out, bit_shift,
                threshold, cut_policy, repeat)
    return out
