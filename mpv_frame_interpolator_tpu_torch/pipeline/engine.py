"""InterpolationEngine of the port (counterpart of the JAX package's
``pipeline/engine.py``): every model family (``models.MODELS``), output
modes 0-6, 8-bit NV12 or 10-bit P010, any black/white levels.

Per source pair, on the engine's device and without a host sync:

1. the pair's prologue (``ops/cuda/prologue.pair_prologue``, one launch of
   C1): the scene-cut score (``pipeline/scene.cut_score``), the cut flag
   (added to the device count of cuts), the blend positions with the cut
   folded in (where the score exceeds the threshold they snap to the
   nearer source, or to 0 under ``cut_policy="hold"``; model ``repeat``
   then snaps every position to 0 or 1: a new tensor, the cached
   positions are never written) and f2's probe for the flow;
2. the flow pyramid and its blur (``ops/flow.flow``: one launch of the
   flow-pyramid kernel, whose last phase is the blur, zero under a cut)
   for the flow families (hopper, hopperx, hopperq, hopperxq), on the
   kernel's instantiation for the layer count of the live radius
   (``layer_buckets``); ``blend`` and ``repeat`` search no flow and take
   a zero field.  Under ``subpel_flow`` the same launch turns the
   unblurred offset into the 1/64-pel field (offset << 6) + frac after
   its last step (S1's phases, ``ops/cuda/subpel.py``) and blurs that in
   its blur phase; hopperq and hopperxq take the floor of the blur and
   its 1/64-pel remainder, hopper and hopperx the blur rounded to the
   nearest pel;
3. the outputs, luma and interleaved chroma, by output mode and model:

   * mode 2 (blended), models hopper, blend and repeat, under
     ``warp_sampling`` "pair" (the default), "shift" or "gather": every
     blend position of the pair in one call of the pair-blend kernel
     (``ops/cuda/warp_pair.py``); under "fused" one call of the fused
     kernel (``ops/cuda/warp_fused.py``) per position; under "pallas" two
     calls of the one-direction sampler (``ops/cuda/warp_sample.py``) per
     position, blended and level-mapped by one call of the blend kernel
     (``ops/cuda/blend_levels.py``).  In the JAX package "pair", "shift",
     "gather" and "pallas" are sampling strategies with identical
     outputs, and "fused" and "pallas" have kernels of their own, as here;
   * mode 2, model hopperx, under any sampler: the "pallas" composition
     with the blend kernel's occlusion correction (the JAX package takes
     hopperx off its pair and fused kernels too);
   * mode 2, models hopperq and hopperxq, under any sampler: one call of
     the bilinear kernel (``ops/cuda/warp_bilinear.py``) per position,
     hopperxq with the occlusion correction, with the sub-pel field under
     ``subpel_flow``;
   * modes 0 / 1 (warp12 / warp21), under any sampler and model: one call
     of the one-direction sampler per position, its raw samples as they
     are;
   * mode 3 (hsv), under any sampler and model: one call of the HSV view
     kernel (``ops/cuda/warp_views.warp_hsv``) per position -- the two
     directions' samples, their blend, the flow's colours (float32 in the
     JAX op order) and the level maps in one launch;
   * mode 4 (grey): the flow's magnitude, one call of the grey view kernel
     (``ops/cuda/warp_views.warp_grey``) a pair, its planes shared by every
     output; nothing sampled;
   * modes 5 / 6 (side by side), under any sampler and model: one call of
     the side-by-side kernel (``ops/cuda/warp_views.warp_sbs``) per
     position (the JAX package's XLA gathers; no Pallas kernel).  Mode 6
     also interpolates on the first source frame, paired with itself.

   The blend kernel is the counterpart of the XLA fusion in which the JAX
   package blends and level-maps outside its sampling kernel.

P010 frames run with scale_shift 8 (the JAX engine's ``_scale_shift``):
the flow's SAD and the cut score are shifted back to the 8-bit scale, the
blend keeps 16 fraction bits, and the outputs are uint16 capped at
255 << 8.  Black/white levels are rounded half to even.

The runtime state the control surfaces set (``api.Player``, the applet,
key bindings; JAX engine.py:808-816) is host attributes of the engine:
``frame_output_mode``, ``black_level``, ``white_level``,
``delta_scalar``, ``neighbor_bias_scalar``, ``scene`` (``enabled``,
``threshold``) and ``config.model``.  Each pair reads them once
(``PairKnobs``), so a change takes effect at the next pair; on the
grouped path they are part of a graph's key, and a change ends the
group being filled.  ``invalidate_geometry`` (``max-calc-res``) has the
next pair derive the geometry again.

The host side -- output cadence (``CadenceEngine``), the auto-quality
controller (``QualityController``, with its degradation ladder) and the
stats -- are the port's copies of the JAX package's modules.  The duration
the controller reads is the pair's calc time: CUDA events from before the
pair's first launch is enqueued to after its last kernel completes, so it
holds the host's enqueue time as well as the card's work (wall time on the
CPU).  It is read back at the next push so that no push waits for its own
pair.  With split timing one more event between the flow and the warp
stage gives ``flow_time``, ``warp_total`` and ``warp_time`` from the same
read-back.

The degradation ladder (``degrade_rungs``): each level past 0 runs its
rung's geometry (fewer pyramid iterations at a lower calc resolution) and
model; the controller steps onto a rung once the radius is at its floor
and unwinds the level before it grows the radius again.

Uploads (``stage``) run on the engine's own copy stream, from page-locked
buffers where the source reads into them (``io/pinned.PinnedPool``), on
the caller's thread -- the pipeline's prefetcher; the compute stream
waits for each frame's copies on the device before first use.

The main path's pair (mode 2, model hopper, the "pair" sampler) is three
kernel launches and no tensor op: C1, K1, K2.  On a card ``push`` runs
it on a launch plan (``pipeline/push_plan.py``): the wrappers' checks,
launch constants and intermediates once per key, so that a pair checks
its frames, allocates its two outputs and launches.  Every other pair
(other modes, samplers and models, ``subpel_flow``, the CPU) calls the
wrappers (``_pair_outputs``).

``push_many`` is the grouped encode path (JAX ``push_many``): the same
outputs as ``push``, with the pairs of a group run from static input
slots by one replay of a CUDA graph captured from the same pair body
(``_pair_outputs``), which replaces the launches a pair enqueues from
Python with one graph launch a group plus the slot and output copies.
On the CPU the body runs eagerly over the same slots.  Nothing compiles
per shape, rung or batch size, so ``batch_shapes``, background
precompile and the compile cache have nothing to do here
(``convert.NO_OP_KNOBS``).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from mpv_frame_interpolator_tpu_torch import models
from mpv_frame_interpolator_tpu_torch.convert import (
    DeviceFrame, frame_to_device, require_device)
from mpv_frame_interpolator_tpu_torch.frame import (
    NV12, FrameFormat, VideoFrame)
from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
from mpv_frame_interpolator_tpu_torch.ops import warp as warp_ops
from mpv_frame_interpolator_tpu_torch.ops.cuda import (
    _build, blend_levels as _k_blend_levels, blur as _k_blur,
    flow_step as _k_flow_step, prologue as _k_prologue, subpel as _k_subpel,
    warp_bilinear as _k_bilinear, warp_fused as _k_fused,
    warp_pair as _k_pair, warp_sample as _k_sample, warp_views as _k_views)
from mpv_frame_interpolator_tpu_torch.ops.cuda.blend_levels import (
    blend_levels)
from mpv_frame_interpolator_tpu_torch.ops.cuda.prologue import (
    pair_prologue)
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_bilinear import (
    bilinear_blend)
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_fused import fused_blend
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_pair import pair_blend
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_sample import sample_dir
from mpv_frame_interpolator_tpu_torch.pipeline import push_plan
from mpv_frame_interpolator_tpu_torch.pipeline import scene as scene_mod
from mpv_frame_interpolator_tpu_torch.pipeline.cadence import (
    CadenceEngine, InterpolationState)
from mpv_frame_interpolator_tpu_torch.pipeline.quality import (
    QualityController)
from mpv_frame_interpolator_tpu_torch.utils import StatsRegistry, get_logger
from mpv_frame_interpolator_tpu_torch.utils.trace import annotate

log = get_logger("engine")


@dataclasses.dataclass
class EngineConfig:
    """The part of the JAX EngineConfig the port covers, plus the
    device the engine runs on (no fallback: "cuda" needs a card)."""

    display_fps: float = 60.0
    frame_output_mode: int = warp_ops.BLENDED_FRAME
    auto_quality: bool = True
    initial_search_radius: int = 5
    too_slow_patience: int = 3
    scene_detection: bool = True
    scene_threshold: float = 28.0
    cut_policy: str = "nearest"                      # "nearest" | "hold"
    delta_scalar: int = 8
    neighbor_bias_scalar: int = 6
    black_level: float = 0.0
    white_level: float = 255.0
    max_calc_res: int = 270
    num_iterations: int = 0
    measure_timing: bool = True
    playback_speed: float = 1.0
    model: str = "hopper"                          # models.MODELS
    # mode 2 of hopper, blend and repeat: "pair", "shift", "gather":
    # every position of a pair in one K2 call; "fused": one K4 call per
    # position; "pallas": two K5 calls per position.  hopperx takes the
    # "pallas" route and hopperq/hopperxq Q1 under any sampler; modes 0
    # and 1 always run on K5, mode 3 on V2, mode 4 on V3, modes 5/6 on V1
    warp_sampling: str = "pair"
    # the flow kernel's layer count for a radius: the smallest bucket >=
    # the radius, else the radius (at least 16); () runs 16 layers up to
    # radius 16.  The output depends on the radius alone.
    layer_buckets: tuple = (5, 8, 16)
    # the ladder past the radius floor: (iteration_delta, res_divisor[,
    # model]) per rung, relative to the configured setup
    degrade_rungs: tuple = ((2, 2), (3, 4), (3, 4, "blend"))
    # flow/warp split telemetry: "auto" once request_split_timing() is
    # called, "always" every pair, "off" never
    split_timing: str = "auto"
    # measured 1/64-pel refinement of the flow (a quality option: it
    # changes the flow families' outputs)
    subpel_flow: bool = False
    # append each published calc time (source_frame_time, seconds) as a
    # line to this file (JAX engine.py:1210-1212; the reference's
    # SAVE_STATS); "" = off
    stats_log_path: str = ""
    device: str = "cuda"

    def __post_init__(self):
        if self.max_calc_res < 64:
            raise ValueError("max_calc_res must be at least 64")
        if self.num_iterations < 0:
            raise ValueError("num_iterations must be >= 0 (0 = maximum)")
        if not 2 <= self.initial_search_radius <= 256:
            raise ValueError("search radius must be within [2, 256]")
        if not 0 <= self.frame_output_mode <= 6:
            raise ValueError("frame_output_mode must be in [0, 6]")
        if self.display_fps <= 0:
            raise ValueError("display_fps must be positive")
        if self.cut_policy not in ("nearest", "hold"):
            raise ValueError("cut_policy must be 'nearest' or 'hold'")
        if not 0 <= self.delta_scalar <= 31 or \
                not 0 <= self.neighbor_bias_scalar <= 31:
            raise ValueError("delta and neighbour-bias scalars must be in "
                             "[0, 31]")
        if self.warp_sampling not in ("shift", "gather", "pallas", "pair",
                                      "fused"):
            raise ValueError(
                "warp_sampling must be shift|gather|pallas|pair|fused")
        if self.split_timing not in ("auto", "always", "off"):
            raise ValueError("split_timing must be auto|always|off")
        models.validate(self.model)
        self.layer_buckets = tuple(sorted(int(b) for b in
                                          self.layer_buckets))
        if any(b < 2 for b in self.layer_buckets):
            raise ValueError("layer buckets must be >= 2")
        rungs = []
        for rung in self.degrade_rungs:
            d, r = int(rung[0]), int(rung[1])
            m = rung[2] if len(rung) > 2 else None
            if d < 0 or r < 1:
                raise ValueError("degrade rungs must be (iteration_delta"
                                 ">=0, res_divisor>=1[, model])")
            if m is not None:
                models.validate(m)
            rungs.append((d, r, m))
        self.degrade_rungs = tuple(rungs)


def _to_numpy(plane) -> np.ndarray:
    if isinstance(plane, torch.Tensor):
        return plane.cpu().numpy()
    return np.asarray(plane)


class OutputFrame:
    """A produced frame; planes may live on the device until materialized.

    Warped outputs of one source pair share one batched tensor (from the
    pair-blend kernel) or one list of per-position planes; `index` selects
    this frame's planes lazily.  `ready`, on a card: the CUDA event
    recorded on the stream that computed the planes, after their work
    (``ready_event``); ``block`` and ``to_video_frame`` wait for it, so a
    consumer on another thread or stream (the stream farm's workers run
    their engines on streams of their own) reads finished planes."""

    __slots__ = ("pts", "fmt", "_y", "_uv", "_index", "_ready")

    def __init__(self, pts: float, fmt: FrameFormat, y, uv,
                 index: Optional[int] = None, ready=None):
        self.pts = pts
        self.fmt = fmt
        self._y = y
        self._uv = uv
        self._index = index
        self._ready = ready

    def block(self):
        """Wait until the frame's planes are computed: for the event of
        the stream that made them; a frame without one (a passthrough of
        device planes) waits for the caller's current stream."""
        if self._ready is not None:
            self._ready.synchronize()
            return self
        uv = self.device_planes()[1]
        if isinstance(uv, torch.Tensor) and uv.is_cuda:
            torch.cuda.current_stream(uv.device).synchronize()
        return self

    def device_planes(self):
        """(y, uv) as tensors (or host arrays for a passthrough frame)."""
        if self._index is None:
            return self._y, self._uv
        return self._y[self._index], self._uv[self._index]

    def to_video_frame(self) -> VideoFrame:
        self.block()
        y, uv = self.device_planes()
        return VideoFrame(_to_numpy(y), _to_numpy(uv), self.fmt,
                          pts=self.pts)


def ready_event(device):
    """On a card, an event recorded now on the current stream of `device`
    (what ``OutputFrame.ready`` holds); None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


FLOW_MODELS = ("hopper", "hopperx", "hopperq", "hopperxq")


class PairKnobs(NamedTuple):
    """The engine's runtime state as one pair reads it (JAX engine.py:
    808-816): taken once a pair, so that a setter on a control thread
    lands between two pairs and never inside one, and part of the grouped
    path's graph key, since a captured graph bakes in the arguments it
    was launched with."""

    mode: int
    model: str                  # the configured family (level 0's)
    levels: tuple               # (k, w) of the black and white levels
    delta_scalar: int
    neighbor_bias_scalar: int
    scene_enabled: bool
    scene_threshold: float


def _flow_stage(geom, scale_shift: int, model: str, f1: DeviceFrame,
                f2: DeviceFrame, probe, cut, radius: int, ds: int, nbs: int,
                layers: int, subpel: bool = False):
    """Hierarchical flow of one pair on the prologue's probe: (blurred
    flow, frac or None), zero where the pair's cut flag `cut` is set (K1's
    blur phase writes the zeros).  `layers` is the kernel's layer count
    for the radius.  The blend and repeat families search no flow: their
    field is zero.  Under `subpel` the unblurred offset is refined to 1/64
    pel and that field blurred (JAX engine.py:486-515): hopperq and
    hopperxq take its floor and the 1/64-pel remainder `frac`, hopper and
    hopperx its rounding to the nearest pel (a zeroed field gives a zero
    flow and a zero frac)."""
    if model not in FLOW_MODELS:
        return torch.zeros((2, geom.low_h, geom.low_w), dtype=torch.int32,
                           device=f1.y.device), None
    args = (geom, f1.y, f1.u, f1.v, f2.y, f2.u, f2.v)
    kw = dict(layers=layers, probe=probe, cut=cut)
    if not subpel:
        _, blurred = flow_ops.flow(*args, radius, ds, nbs, scale_shift, **kw)
        return blurred, None
    _, b64 = flow_ops.flow(*args, radius, ds, nbs, scale_shift, subpel=True,
                           **kw)
    if model in ("hopperq", "hopperxq"):
        blurred = b64 >> 6
        return blurred, b64 - (blurred << 6)
    return (b64 + 32) >> 6, None


def _warp_stage(geom, scale_shift: int, levels, mode: int, sampling: str,
                model: str, planes, blurred, ts, frac=None):
    """Every output of the pair: (y, uv), each indexable by position --
    (N, H, Wa) and (N, H/2, Wa) tensors from one pair-blend call, or lists
    of N planes.  `planes` is (f1y, f1uv, f2y, f2uv); `ts` the blend
    positions as the outputs take them (in the engine, the prologue's, with
    the cut and model "repeat" folded in); `frac` the sub-pel field of the
    bilinear families (their blended mode reads it) or None."""
    rs, wa = geom.res_scalar, geom.actual_width
    args = (*planes, blurred)
    n = ts.shape[0]
    blended = mode == warp_ops.BLENDED_FRAME
    if mode == warp_ops.GREY_FLOW:
        y, uv = _k_views.warp_grey(blurred, rs, geom.height, wa, scale_shift,
                                   planes[0].dtype)
        return [y] * n, [uv] * n
    if blended and model in ("hopperq", "hopperxq"):
        outs = [bilinear_blend(*args, ts[i], rs, wa, scale_shift, levels,
                               model == "hopperxq", frac) for i in range(n)]
    elif blended and model == "hopperx":
        outs = [_blended_from_samples(scale_shift, levels, rs, wa, args,
                                      ts[i], occlusion=True)
                for i in range(n)]
    elif blended and sampling not in ("fused", "pallas"):
        return pair_blend(*args, ts, rs, wa, scale_shift, levels)
    elif blended and sampling == "fused":
        outs = [fused_blend(*args, ts[i], rs, wa, scale_shift, levels)
                for i in range(n)]
    elif mode in (warp_ops.WARPED_FRAME_12, warp_ops.WARPED_FRAME_21):
        direction = 12 if mode == warp_ops.WARPED_FRAME_12 else 21
        outs = [sample_dir(*args, ts[i], direction, rs, wa)
                for i in range(n)]
    elif mode in (warp_ops.SIDE_BY_SIDE_1, warp_ops.SIDE_BY_SIDE_2):
        outs = [_k_views.warp_sbs(mode, *args, ts[i], rs, wa, scale_shift,
                                  levels) for i in range(n)]
    elif mode == warp_ops.HSV_FLOW:
        outs = [_k_views.warp_hsv(*args, ts[i], rs, wa, scale_shift, levels)
                for i in range(n)]
    else:
        outs = [_blended_from_samples(scale_shift, levels, rs, wa, args,
                                      ts[i]) for i in range(n)]
    return [y for y, _ in outs], [uv for _, uv in outs]


def _blended_from_samples(scale_shift: int, levels, rs: int, wa: int, args,
                          t, occlusion: bool = False):
    """Mode 2 under "pallas" (and of hopperx, with the occlusion
    correction) at one position: the two directions' raw samples (K5),
    then the blend and level maps (G1)."""
    y12, uv12 = sample_dir(*args, t, 12, rs, wa)
    y21, uv21 = sample_dir(*args, t, 21, rs, wa)
    return blend_levels(y12, uv12, y21, uv21, t, scale_shift, levels,
                        occlusion)


# every kernel wrapper's launch counters: a replayed graph calls no
# wrapper, so the engine adds each graph's captured launches per replay
_KERNEL_COUNTS = (_k_flow_step.counts, _k_blur.counts, _k_pair.counts,
                  _k_fused.counts, _k_sample.counts, _k_blend_levels.counts,
                  _k_bilinear.counts, _k_subpel.counts, _k_views.sbs_counts,
                  _k_views.hsv_counts, _k_views.grey_counts,
                  _k_prologue.counts)


def _snapshot_counts():
    return [(c.kernel, getattr(c, "fused", 0)) for c in _KERNEL_COUNTS]


def _restore_counts(snapshot):
    for c, (kernel, fused) in zip(_KERNEL_COUNTS, snapshot):
        c.kernel = kernel
        if hasattr(c, "fused"):
            c.fused = fused


class _GroupSlots:
    """Static inputs of a group of k chained pairs: k + 1 frames (pair j
    runs frame j -> frame j + 1) and the (k, n_batch) blend positions,
    filled by device-to-device copies before each run of the group's
    body (a captured graph reads these addresses and no others)."""

    def __init__(self, fmt: FrameFormat, k: int, n_batch: int, device):
        h, s = fmt.height, fmt.stride
        dt = torch.uint8 if fmt.pixfmt == NV12 else torch.uint16
        self.y = torch.empty((k + 1, h, s), dtype=dt, device=device)
        self.uv = torch.empty((k + 1, h // 2, s), dtype=dt, device=device)
        self.u = torch.empty((k + 1, h // 2, s // 2), dtype=dt,
                             device=device)
        self.v = torch.empty_like(self.u)
        self.ts = torch.empty((k, n_batch), dtype=torch.float32,
                              device=device)
        self.frames = [DeviceFrame(self.y[j], self.uv[j], self.u[j],
                                   self.v[j], fmt) for j in range(k + 1)]
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in (self.y, self.uv, self.u, self.v,
                                    self.ts))

    def fill(self, chunk, ts: torch.Tensor) -> int:
        """Copy the chunk's frames and blend positions in; returns the
        copies enqueued."""
        sources = [chunk[0][0]] + [pair[1] for pair in chunk]
        for slot, src in zip(self.frames, sources):
            for dst, plane in ((slot.y, src.y), (slot.uv, src.uv),
                               (slot.u, src.u), (slot.v, src.v)):
                dst.copy_(plane)
        self.ts.copy_(ts)
        return 4 * len(sources) + 1


class _GroupGraph:
    """A group's body captured once as a CUDA graph and replayed for every
    later group with the same key.

    Warm-up: the body runs once eagerly on a side stream before capture
    (torch.cuda.graph's rule; it also builds and loads the kernel library,
    and the capture would refuse any host sync in the body); its launches
    ran and stay counted.  The capture calls every kernel wrapper, which
    counts a launch that did not run: the counters are put back, and each
    replay adds the launches captured (`launches`, by counter).
    `nbytes`: the device memory the capture reserved for the graph's
    private pool (intermediates and outputs), plus the static slots;
    `capture_s` the host seconds of warm-up and capture."""

    def __init__(self, slots: _GroupSlots, body, cuts: torch.Tensor):
        dev = slots.y.device
        t0 = time.perf_counter()
        self.slots = slots
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            body(slots, torch.zeros((), dtype=torch.int32, device=dev))
            after_warm = _snapshot_counts()
            reserved = torch.cuda.memory_reserved(dev)
            # thread-local capture: the prefetch thread goes on uploading
            # (its copies, event waits and page-locked allocations are
            # not the capture's); torch.cuda.graph's device sync and cache
            # flush are not needed here.  No garbage collection may run
            # inside it: one that frees another graph (a cycle holding an
            # old engine) destroys that graph, which a capture forbids and
            # so invalidates
            collecting = gc.isenabled()
            gc.disable()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.outs = body(slots, cuts)
            finally:
                self.graph.capture_end()
                if collecting:
                    gc.enable()
        cur.wait_stream(side)
        after = _snapshot_counts()
        _restore_counts(after_warm)
        self.launches = [(a[0] - b[0], a[1] - b[1])
                         for a, b in zip(after, after_warm)]
        # the capture allocates from a private pool: the growth is its
        # segments
        self.nbytes = (torch.cuda.memory_reserved(dev) - reserved
                       + slots.nbytes)
        self.replays = 0
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        _restore_counts([(c.kernel + n, getattr(c, "fused", 0) + f)
                         for c, (n, f) in zip(_KERNEL_COUNTS,
                                              self.launches)])

    def kernel_launches(self) -> int:
        """Kernel launches one replay runs (K3's fused phases are part of
        K1's launches)."""
        return sum(n for n, _ in self.launches)


class InterpolationEngine:
    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.device = require_device(self.config.device)
        self.cadence = CadenceEngine(self.config.display_fps,
                                     self.config.playback_speed)
        self.quality = QualityController(
            enabled=self.config.auto_quality,
            search_radius=self.config.initial_search_radius,
            too_slow_patience=self.config.too_slow_patience,
            max_level=len(self.config.degrade_rungs))
        self.stats = StatsRegistry()
        # the runtime-mutable state (JAX engine.py:808-816): each starts
        # from the config, and every pair reads it (`_knobs`); the control
        # surfaces (api.Player, the applet, key bindings) set these host
        # attributes from their own threads and launch nothing.  The model
        # is `config.model`, read every pair as well
        self.scene = scene_mod.SceneChangeDetector(
            enabled=self.config.scene_detection,
            threshold=self.config.scene_threshold)
        self.frame_output_mode = self.config.frame_output_mode
        self.black_level = self.config.black_level
        self.white_level = self.config.white_level
        self.delta_scalar = self.config.delta_scalar
        self.neighbor_bias_scalar = self.config.neighbor_bias_scalar

        self.geom: Optional[flow_ops.FlowGeometry] = None
        self._geoms: List[flow_ops.FlowGeometry] = []  # [level 0, rung 1..]
        # each rung's own model, None where it runs the configured one
        self._rung_models: List[Optional[str]] = []
        self._scale_shift = 0
        self._fmt: Optional[FrameFormat] = None
        # set by invalidate_geometry (another thread): the next pair
        # derives the geometry again
        self._geometry_stale = False
        self._prev: Optional[DeviceFrame] = None
        self._cur: Optional[DeviceFrame] = None
        self._warm = False          # a pair of this geometry has run
        self._last_calc_duration = 0.0
        # the last pair's (start, flow end or None, end) CUDA events and
        # its output count
        self._pending_timing = None
        self._split_wanted = self.config.split_timing == "always"
        # the last pair's cut score: the tensor, and on a card its value
        # as the last timing read-back brought it to the host
        self._last_cut_score = None
        self._host_cut_score = 0.0
        # device count of folded scene cuts, added to in place (a captured
        # graph adds to this tensor at every replay)
        self._cuts = torch.zeros((), dtype=torch.int32, device=self.device)
        # C1's partial sums: the pairs of one engine run in one stream's
        # order, eager or replayed, so they share it
        self._partials = _k_prologue.scratch(self.device)
        self._ts_cache = {}
        # the stream uploads run on (stage), off the compute stream
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # push_many: captured group graphs by key, least recently used
        # first; group keys that ran once (their duration is a
        # measurement from the second run on)
        self._graphs: "OrderedDict[tuple, _GroupGraph]" = OrderedDict()
        self._group_warm = set()
        # host work of the grouped path: graphs captured, replays, copies
        # enqueued around them (slot fills and output copy-outs), pairs
        self.group_stats = {"captures": 0, "replays": 0, "copies": 0,
                            "pairs": 0, "groups": 0}
        # push's launch plan (`_push_pair`), the latest key's only; off on
        # the CPU (a test turns it off on a card to hold it against the
        # wrappers).  plan_stats: plans built, push pairs run on a plan,
        # push pairs that called the wrappers
        self._plan_enabled = self.device.type == "cuda"
        self._push_plan: Optional[push_plan.PushPlan] = None
        self.plan_stats = {"builds": 0, "pairs": 0, "fallbacks": 0}

    # ------------------------------------------------------------------ #

    def set_speed(self, speed: float):
        self.cadence.set_speed(speed)

    @property
    def levels(self):
        """(k, w): the live black and white levels, rounded half to even
        (derived again from the attributes at every read)."""
        return warp_ops.level_ints(self.black_level, self.white_level)

    def _knobs(self) -> PairKnobs:
        return PairKnobs(int(self.frame_output_mode), self.config.model,
                         self.levels, int(self.delta_scalar),
                         int(self.neighbor_bias_scalar),
                         bool(self.scene.enabled),
                         float(self.scene.threshold))

    def invalidate_geometry(self):
        """Derive the flow geometry again at the next pair (after a
        change of `config.max_calc_res`; the JAX Player sets the engine's
        `_fmt` to None for this).  Host state only: safe from any thread;
        the engine's own thread re-derives, resets the cadence and the
        flow anchor, and drops its captured graphs."""
        self._geometry_stale = True

    def reset(self):
        """Seek reset: counters only; the next two source frames
        re-anchor the device buffers."""
        self.cadence.reset()
        self._prev = None
        self._cur = None

    def stage(self, frame: Union[VideoFrame, DeviceFrame]) -> DeviceFrame:
        """Upload a host frame to the engine's device (a frame already
        staged is returned as it is); safe to call from a reader thread
        (the pipeline's prefetcher does), while another thread pushes.

        On a card the copies run on the engine's copy stream without
        blocking the host (``convert.frame_to_device``); push and push_many
        make the compute stream wait for them on the device.  A frame with
        a ``recycle`` hook is handed back to its pool once its copies have
        completed, which this call waits for; their device time is then
        recorded as ``upload_time``."""
        if isinstance(frame, DeviceFrame):
            return frame
        if self._copy_stream is None:
            return frame_to_device(frame, self.device)
        start = None
        if frame.recycle is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._copy_stream)
        staged = frame_to_device(frame, self.device, self._copy_stream)
        if start is not None:       # frame_to_device waited for the copy
            self.stats.add("upload_time",
                           start.elapsed_time(staged.ready) * 1e-3)
        return staged

    def _use(self, frame: Union[VideoFrame, DeviceFrame]) -> DeviceFrame:
        """The frame on the device, with the compute stream ordered after
        its upload.  A host frame is uploaded here without its recycle
        hook (``with_pts`` drops it, as the JAX engine's own upload never
        recycles): its buffers stay the caller's, who may still pass them
        through."""
        if not isinstance(frame, DeviceFrame):
            frame = self.stage(frame.with_pts(frame.pts))
        if self.device.type == "cuda":
            frame.wait_on(torch.cuda.current_stream(self.device))
        return frame

    def _needs_geometry(self, fmt: FrameFormat) -> bool:
        return self._geometry_stale or self._fmt is None or (
            fmt.height, fmt.stride, fmt.width, fmt.pixfmt) != (
            self._fmt.height, self._fmt.stride, self._fmt.width,
            self._fmt.pixfmt)

    def _ensure_geometry(self, fmt: FrameFormat):
        if not self._needs_geometry(fmt):
            return
        # cleared before the config is read: a change landing meanwhile
        # marks the geometry stale again
        self._geometry_stale = False
        max_calc_res = self.config.max_calc_res
        geom = flow_ops.FlowGeometry.create(
            fmt.height, fmt.stride, fmt.width, max_calc_res,
            self.config.num_iterations)
        self._geoms = [geom]
        self._rung_models = [None]
        for d_iter, res_div, model in self.config.degrade_rungs:
            self._geoms.append(flow_ops.FlowGeometry.create(
                fmt.height, fmt.stride, fmt.width,
                max(max_calc_res // res_div, 64),
                max(geom.iterations - d_iter, 1)))
            self._rung_models.append(model)
        self.geom = geom
        self._scale_shift = 0 if fmt.pixfmt == NV12 else 8
        self._fmt = fmt
        self._prev = None
        self._cur = None
        self._warm = False
        self._graphs.clear()
        self._group_warm.clear()
        self._push_plan = None
        self.cadence.reset()
        log.info("flow geometry: %s (pixfmt=%s, device %s)", self.geom,
                 fmt.pixfmt, self.device)

    def _active_level(self) -> int:
        """The degradation level this push runs: the controller's level.
        The JAX engine demotes it to the nearest rung whose programs have
        compiled, and gates the controller's steps on that
        (``QualityController.rung_warm``); the port compiles nothing per
        shape or rung -- its kernel library builds once, at first use --
        so every rung is warm once it is loaded, and it sets no gate."""
        return self.quality.level

    def _layers_for(self, radius: int) -> int:
        """The flow kernel's layer count serving `radius`: the smallest
        configured bucket >= radius (``EngineConfig.layer_buckets``), else
        the radius itself, at least MAX_SEARCH_RADIUS (JAX engine.py
        ``_layers_for``)."""
        for b in self.config.layer_buckets:
            if b >= radius:
                return b
        return max(radius, flow_ops.MAX_SEARCH_RADIUS)

    def request_split_timing(self):
        """Called by a telemetry consumer: under split_timing "auto" every
        timed pair from now on publishes its flow/warp split (one more CUDA
        event a pair, read back with the pair's duration)."""
        self._split_wanted = True

    def _split(self) -> bool:
        mode = self.config.split_timing
        return mode == "always" or (mode == "auto" and self._split_wanted)

    def _ts_for(self, blends: tuple) -> torch.Tensor:
        """Device blend vector, cached by value: fixed-rate cadences
        cycle through a few blend tuples."""
        ts = self._ts_cache.get(blends)
        if ts is None:
            if len(self._ts_cache) >= 64:
                self._ts_cache.pop(next(iter(self._ts_cache)))
            ts = torch.tensor(blends, dtype=torch.float32,
                              device=self.device)
            self._ts_cache[blends] = ts
        return ts

    def _out_fmt(self) -> FrameFormat:
        return FrameFormat(self.geom.actual_width, self.geom.height,
                           self._fmt.pixfmt, primaries=self._fmt.primaries,
                           transfer=self._fmt.transfer,
                           matrix=self._fmt.matrix)

    def _collect_timing(self):
        """Turn the previous pair's (or group's) CUDA events into its
        duration a pair, and its flow/warp split when it recorded one
        (waits for that pair or group only), and bring its cut score to
        the host (it is computed by then)."""
        if self._pending_timing is None:
            return
        start, mid, end, n_outputs, pairs, score = self._pending_timing
        self._pending_timing = None
        with annotate("mfi.engine.wait"):
            end.synchronize()
            self._record_duration(start.elapsed_time(end) * 1e-3 / pairs)
            if mid is not None:
                self._record_split(start.elapsed_time(mid) * 1e-3,
                                   mid.elapsed_time(end) * 1e-3, n_outputs)
            if score is not None:
                self._host_cut_score = self.scene.last_score = float(score)

    def _record_duration(self, dur: float):
        self._last_calc_duration = dur
        self.stats.add("source_frame_time", dur)
        if self.config.stats_log_path:
            with open(self.config.stats_log_path, "a") as fh:
                fh.write(f"{dur:.6f}\n")

    def _record_split(self, flow_t: float, warp_t: float, n_outputs: int):
        self.stats.add("flow_time", flow_t)
        self.stats.add("warp_total", warp_t)
        self.stats.add("warp_time", warp_t / max(n_outputs, 1))

    # ------------------------------------------------------------------ #

    def push(self, frame: Union[VideoFrame, DeviceFrame]) -> List[OutputFrame]:
        """Process one source frame; returns the output frames due."""
        with annotate("mfi.push"):
            self._ensure_geometry(frame.fmt)
            knobs = self._knobs()
            plan = self._plan(frame, knobs.mode)
            if plan.passthrough:
                return [self._passthrough(frame)]

            # the controller reads the previous pair's duration
            self._collect_timing()
            self.quality.update(self._last_calc_duration, self.cadence)

            self._prev = self._cur
            self._cur = self._use(frame)
            f1, f2 = self._prev, self._cur
            if f1 is None:
                f1 = f2
            radius = self.quality.search_radius
            level = self._active_level()
            n_out = len(plan.outputs)
            ts = self._ts_for(tuple(slot.blend for slot in plan.outputs))
            # the first pair of a geometry carries the kernel build: its
            # duration is no measurement (0.0, as the JAX engine's cold pair)
            timed = self.config.measure_timing and self._warm
            split = timed and self._split()
            on_cuda = self.device.type == "cuda"
            if timed and on_cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                mid = torch.cuda.Event(enable_timing=True) if split else None
                start.record()
            t0 = time.perf_counter()
            t_mid = [t0]

            def flow_done():
                if split and on_cuda:
                    mid.record()
                t_mid[0] = time.perf_counter()

            y, uv, score = self._push_pair(level, radius, f1, f2, ts, knobs,
                                           flow_done)
            if not timed:
                self._last_calc_duration = 0.0
            elif on_cuda:
                end.record()
                self._pending_timing = (start, mid, end, n_out, 1, score)
            else:
                t_end = time.perf_counter()
                self._record_duration(t_end - t0)
                if split:
                    self._record_split(t_mid[0] - t0, t_end - t_mid[0], n_out)
            if self.config.measure_timing:
                self.stats.add("outputs", n_out)
            self._warm = True
            self._last_cut_score = score
            out_fmt = self._out_fmt()
            ready = ready_event(self.device)
            return [OutputFrame(slot.pts, out_fmt, y, uv, index=i, ready=ready)
                    for i, slot in enumerate(plan.outputs)]

    def _plan(self, frame, mode: int):
        # SideBySide2 interpolates on the first source frame as well (its
        # pair is the frame with itself)
        plan = self.cadence.on_source_frame(
            frame.pts, frame.nominal_fps,
            first_frame_interpolates=mode == warp_ops.SIDE_BY_SIDE_2)
        if plan.inconsistent_detected:
            log.warning("Inconsistent frame timings detected. Using less "
                        "accurate frame timing method to maintain A/V sync.")
        return plan

    def _passthrough(self, frame) -> OutputFrame:
        """The output of a frame the cadence passes through (its own
        planes, host or device: the engine's upload of a host frame leaves
        its buffers to the caller).  The first frame of a stream is kept
        as the flow anchor."""
        if self.cadence.state == InterpolationState.ACTIVE \
                and self.cadence.source_frame_num == 1:
            self._prev = self._cur
            self._cur = self._use(frame)
        return OutputFrame(frame.pts, frame.fmt, frame.y, frame.uv)

    def _model_for(self, level: int, knobs: PairKnobs) -> str:
        """The model a level runs: its rung's, else the configured one as
        the pair read it (a switch of `config.model` reaches level 0 and
        every rung without a model of its own at the next pair)."""
        return self._rung_models[level] or knobs.model

    def _plan_serves(self, model: str, knobs: PairKnobs) -> bool:
        """Whether a push pair takes the launch plan: its route is C1, K1
        with the blur phase and K2 (mode 2, model hopper, a sampler of
        K2's -- "pair", "shift" or "gather" -- and no ``subpel_flow``),
        on a card."""
        return (self._plan_enabled
                and knobs.mode == warp_ops.BLENDED_FRAME
                and model == "hopper"
                and self.config.warp_sampling not in ("fused", "pallas")
                and not self.config.subpel_flow)

    def _push_pair(self, level: int, radius: int, f1: DeviceFrame,
                   f2: DeviceFrame, ts: torch.Tensor, knobs: PairKnobs,
                   flow_done):
        """push's pair: on the launch plan of its key where the plan
        serves it and both frames fit it (a plan is built at the first
        pair of a new key, and replaces the one before), else through the
        wrappers (``_pair_outputs``).  Returns what ``_pair_outputs``
        does."""
        model = self._model_for(level, knobs)
        plan = None
        if self._plan_serves(model, knobs):
            fmt = self._fmt
            # on the engine's own device (`_cuts` is on it): frames
            # elsewhere take the wrappers
            stream = _build.stream_of(self._cuts)
            layers = self._layers_for(radius)
            key = (level, self._geoms[level], layers, radius, knobs, model,
                   self.config.warp_sampling, self.config.cut_policy,
                   fmt.pixfmt, (fmt.height, fmt.stride, fmt.width), stream)
            plan = self._push_plan
            if plan is None or plan.key != key:
                self._push_plan = plan = None       # its scratch freed
                if push_plan.frames_fit(
                        f1, f2, self._cuts.device,
                        torch.uint8 if fmt.pixfmt == NV12 else torch.uint16,
                        push_plan.plane_shapes(fmt.height, fmt.stride)):
                    plan = push_plan.PushPlan(
                        key, self._geoms[level], f1, f2, ts, self._cuts,
                        self._partials, knobs, radius, layers,
                        self._scale_shift, self.config.cut_policy, stream)
                    self._push_plan = plan
                    self.plan_stats["builds"] += 1
            elif not plan.fits(f1, f2):
                plan = None
        if plan is None:
            self.plan_stats["fallbacks"] += 1
            return self._pair_outputs(level, radius, f1, f2, ts, self._cuts,
                                      knobs, flow_done)
        self.plan_stats["pairs"] += 1
        return plan.run(f1, f2, ts, flow_done)

    def _pair_outputs(self, level: int, radius: int, f1: DeviceFrame,
                      f2: DeviceFrame, ts: torch.Tensor, cuts: torch.Tensor,
                      knobs: PairKnobs, flow_done=None):
        """The body of one pair at the given level, radius and runtime
        state: the prologue (the score, the cut -- added in place to
        `cuts`, so a captured graph adds at every replay -- the folded
        positions and the probe), the flow stage (zero under a cut), then
        every output of the folded positions.  `ts` is never written (the
        engine caches it).  Returns (y, uv, cut score or None);
        `flow_done` is called between the stages (split timing).  push
        runs it once a pair, push_many k times a group."""
        geom, model = self._geoms[level], self._model_for(level, knobs)
        with annotate("mfi.pair"):
            pro = pair_prologue(
                geom, f1.y, f2.y, f2.u, f2.v, ts, cuts, self._scale_shift,
                knobs.scene_enabled, knobs.scene_threshold,
                self.config.cut_policy, model == "repeat",
                probe=model in FLOW_MODELS, partials=self._partials)
            blurred, frac = _flow_stage(
                geom, self._scale_shift, model, f1, f2, pro.probe, pro.cut,
                radius, knobs.delta_scalar, knobs.neighbor_bias_scalar,
                self._layers_for(radius), self.config.subpel_flow)
            if flow_done is not None:
                flow_done()
            y, uv = _warp_stage(geom, self._scale_shift, knobs.levels,
                                knobs.mode, self.config.warp_sampling, model,
                                (f1.y, f1.uv, f2.y, f2.uv), blurred, pro.ts,
                                frac)
        return y, uv, pro.score

    # -- grouped dispatch (the encode path) ------------------------------

    _GROUP_BUCKETS = (8, 4, 2, 1)
    GRAPH_CACHE = 4         # captured group graphs kept, least recent out

    def push_many(self, frames, group_size: int = 8) -> List[OutputFrame]:
        """Process many source frames with pair-grouped dispatch: the
        outputs of push(f) for every frame (the same pts and bit-identical
        planes), with the interpolating pairs run a group of up to
        `group_size` at a time (JAX ``engine.push_many``).

        A group of k pairs copies its k + 1 frames and its blend positions
        into static slots (``_GroupSlots``) and runs the pair body k times
        over them: on a card as one replay of a CUDA graph captured once
        per key (level, layers, radius, k, n_batch, the runtime state
        ``PairKnobs``, model, sampler, pixel format, frame size;
        ``_GroupGraph``, the last GRAPH_CACHE kept), whose outputs are
        then copied out on the stream (the next replay overwrites the
        graph's own); on the CPU eagerly, in place of the replay.  Groups
        are chunked to the sizes in _GROUP_BUCKETS; pairs whose output
        counts differ within a group are padded to the group's largest
        count (padded outputs computed, never emitted).  Passthrough
        frames come out in stream order; a geometry switch and a change
        of the runtime state drain the pending pairs first.  The quality controller is
        updated once per group, and a timed group's duration (CUDA events
        around it, read one group later) is divided by its pair count.
        Adds up to `group_size` source intervals of latency: an encode
        path; playback keeps push()."""
        with annotate("mfi.push_many"):
            outputs: List[OutputFrame] = []
            pending = []    # (f1, f2, blends, slots, knobs) awaiting a group
            for frame in frames:
                if pending and self._needs_geometry(frame.fmt):
                    # a geometry switch resets engine state: drain the old
                    # geometry's pairs first
                    self._flush_group(pending, outputs, group_size)
                self._ensure_geometry(frame.fmt)
                knobs = self._knobs()
                if pending and pending[-1][4] != knobs:
                    # a property changed: the pairs before it run as they were
                    # set, the pairs after it start a group of their own
                    self._flush_group(pending, outputs, group_size)
                plan = self._plan(frame, knobs.mode)
                if plan.passthrough:
                    # emit in stream order: queued pairs precede this frame
                    self._flush_group(pending, outputs, group_size)
                    outputs.append(self._passthrough(frame))
                    continue
                self._prev = self._cur
                self._cur = self._use(frame)
                f1 = self._prev if self._prev is not None else self._cur
                pending.append((f1, self._cur,
                                tuple(slot.blend for slot in plan.outputs),
                                plan.outputs, knobs))
                if len(pending) >= group_size:
                    self._flush_group(pending, outputs, group_size)
            self._flush_group(pending, outputs, group_size)
            return outputs

    def _flush_group(self, pending, outputs, group_size: int):
        while pending:
            k = next(b for b in self._GROUP_BUCKETS
                     if b <= len(pending) and b <= max(group_size, 1))
            chunk = pending[:k]
            del pending[:k]
            outputs.extend(self._dispatch_group(chunk))

    def _dispatch_group(self, chunk) -> List[OutputFrame]:
        # controller ordering mirrors push(): the previous measurement
        # first
        self._collect_timing()
        self.quality.update(self._last_calc_duration, self.cadence)
        k = len(chunk)
        for (_, f2, _, _, _), (f1, _, _, _, _) in zip(chunk, chunk[1:]):
            if f1 is not f2:
                raise RuntimeError("a group's pairs must chain (each "
                                   "pair's newer frame the next one's "
                                   "older)")
        knobs = chunk[0][4]
        n_batch = max(len(blends) for _, _, blends, _, _ in chunk)
        radius = self.quality.search_radius
        level = self._active_level()
        fmt = self._fmt
        # the flow geometry (max-calc-res) is not in the key: deriving it
        # again drops every graph (_ensure_geometry)
        key = (level, self._layers_for(radius), radius, k, n_batch, knobs,
               self._model_for(level, knobs), self.config.warp_sampling,
               fmt.pixfmt, (fmt.height, fmt.stride, fmt.width))
        padded = tuple(blends + (blends[-1],) * (n_batch - len(blends))
                       for _, _, blends, _, _ in chunk)
        ts = self._ts_for(padded)
        timed = self.config.measure_timing and key in self._group_warm
        on_cuda = self.device.type == "cuda"
        if timed and on_cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()

        def body(slots, cuts):
            return [self._pair_outputs(level, radius, slots.frames[j],
                                       slots.frames[j + 1], slots.ts[j],
                                       cuts, knobs) for j in range(k)]

        if on_cuda:
            graph = self._graphs.pop(key, None)
            slots = (_GroupSlots(fmt, k, n_batch, self.device)
                     if graph is None else graph.slots)
            with annotate("mfi.group.fill"):
                self.group_stats["copies"] += slots.fill(chunk, ts)
            if graph is None:
                with annotate("mfi.group.capture"):
                    graph = _GroupGraph(slots, body, self._cuts)
                self.group_stats["captures"] += 1
                log.info("captured a group graph %s: %d kernel launches a "
                         "replay, %.1f MB", key, graph.kernel_launches(),
                         graph.nbytes / 1e6)
                if len(self._graphs) >= self.GRAPH_CACHE:
                    # a key captured again carries a capture: untimed
                    self._group_warm.discard(
                        self._graphs.popitem(last=False)[0])
            self._graphs[key] = graph
            with annotate("mfi.group.replay"):
                graph.replay()
            self.group_stats["replays"] += 1
            with annotate("mfi.group.copy_out"):
                results = self._copy_out(graph.outs)
        else:
            slots = _GroupSlots(fmt, k, n_batch, self.device)
            with annotate("mfi.group.fill"):
                slots.fill(chunk, ts)
            results = body(slots, self._cuts)
        self.group_stats["groups"] += 1
        self.group_stats["pairs"] += k

        n_out = sum(len(out_slots) for _, _, _, out_slots, _ in chunk)
        if not timed:
            self._last_calc_duration = 0.0
        elif on_cuda:
            end.record()
            self._pending_timing = (start, None, end, n_out, k,
                                    results[-1][2])
        else:
            self._record_duration((time.perf_counter() - t0) / k)
        if self.config.measure_timing:
            self.stats.add("outputs", n_out)
        self._group_warm.add(key)
        self._warm = True
        self._last_cut_score = results[-1][2]
        out_fmt = self._out_fmt()
        ready = ready_event(self.device)
        return [OutputFrame(slot.pts, out_fmt, y, uv, index=i, ready=ready)
                for (y, uv, _), (_, _, _, out_slots, _) in zip(results,
                                                               chunk)
                for i, slot in enumerate(out_slots)]

    def _copy_out(self, outs):
        """The graph's outputs copied out on the stream (each tensor once,
        a tensor repeated in a list once; of the cut scores the last), so
        that the next replay cannot overwrite frames the caller still
        holds."""
        copies = {}

        def out(t):
            if t is None:
                return None
            if id(t) not in copies:
                copies[id(t)] = t.clone()
            return copies[id(t)]

        results = []
        for j, (y, uv, score) in enumerate(outs):
            if isinstance(y, torch.Tensor):
                y, uv = out(y), out(uv)
            else:
                y, uv = [out(p) for p in y], [out(p) for p in uv]
            # only the group's last cut score is read (last_cut_score)
            results.append((y, uv, out(score) if j == len(outs) - 1
                            else None))
        self.group_stats["copies"] += len(copies)
        return results

    def graph_stats(self) -> List[dict]:
        """Each captured group graph kept: its key, kernel launches a
        replay, replays and device memory."""
        return [{"key": key, "kernel_launches": g.kernel_launches(),
                 "replays": g.replays, "bytes": g.nbytes,
                 "capture_s": g.capture_s}
                for key, g in self._graphs.items()]

    def flush(self) -> List[OutputFrame]:
        """End of stream: nothing is held back; reads the last pair's
        timing so the stats cover every pair."""
        self._collect_timing()
        return []

    # telemetry
    def last_cut_score(self) -> float:
        """The last pair's cut score (0.0 before the first).  A getter of
        the control surfaces, called from their threads: on a card it
        serves the value that the pair's timing read-back brought to the
        host (`_collect_timing`, on the engine's thread, after the pair's
        end event) and never synchronises the card itself, which would be
        illegal while the engine's thread captures a graph; untimed pairs
        leave the last value read.  On the CPU the score is read as it
        is."""
        score = self._last_cut_score
        if score is None:
            return 0.0
        if isinstance(score, torch.Tensor) and score.is_cuda:
            return self._host_cut_score
        return float(score)

    def scene_cuts(self) -> int:
        """How many pairs so far had a scene cut folded in (host sync)."""
        return int(self._cuts)
