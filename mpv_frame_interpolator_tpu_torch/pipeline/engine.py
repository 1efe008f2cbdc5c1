"""InterpolationEngine of the port (counterpart of the JAX package's
``pipeline/engine.py``): every model family (``models.MODELS``), output
modes 0-6, 8-bit NV12 or 10-bit P010, any black/white levels.

Per source pair, on the engine's device and without a host sync:

1. the scene-cut score (``pipeline/scene.cut_score``);
2. the flow pyramid and its blur (``ops/flow.flow``: one launch of the
   flow-pyramid kernel, whose last phase is the blur) for the flow
   families (hopper, hopperx, hopperq, hopperxq), on the kernel's
   instantiation for the layer count of the live radius
   (``layer_buckets``); ``blend`` and ``repeat`` search no flow and take
   a zero field.  Under ``subpel_flow`` the pyramid runs without its blur
   phase, the sub-pel kernel (``ops/cuda/subpel.py``) turns the unblurred
   offset into the 1/64-pel field (offset << 6) + frac, and the blur
   kernel blurs that on its own; hopperq and hopperxq take the floor of
   the blur and its 1/64-pel remainder, hopper and hopperx the blur
   rounded to the nearest pel;
3. the cut folded in on the device: where the score exceeds the
   threshold the flow is zeroed and the blend positions snap to the
   nearer source (``torch.where``, no host branch); model ``repeat`` then
   snaps every position to 0 or 1;
4. the outputs, luma and interleaved chroma, by output mode and model:

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
   * mode 3 (hsv): two calls per position, blended by the blend kernel at
     the default levels, recoloured by the flow (``ops/warp.hsv_planes``)
     and level-mapped as tensor ops (float colour math);
   * mode 4 (grey): the flow's magnitude as tensor ops; nothing sampled;
   * modes 5 / 6 (side by side): ``ops/warp.warp_sbs`` per position as
     tensor ops (the JAX package's XLA gathers; no Pallas kernel).  Mode 6
     also interpolates on the first source frame, paired with itself.

   The blend kernel is the counterpart of the XLA fusion in which the JAX
   package blends and level-maps outside its sampling kernel.

P010 frames run with scale_shift 8 (the JAX engine's ``_scale_shift``):
the flow's SAD and the cut score are shifted back to the 8-bit scale, the
blend keeps 16 fraction bits, and the outputs are uint16 capped at
255 << 8.  Black/white levels are rounded half to even once, when the
engine is made.

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

Not ported yet: ``push_many`` and the grouped pipeline.  Nothing compiles
per shape, rung or batch size, so ``batch_shapes``, background precompile
and the compile cache have nothing to do here (``convert.NO_OP_KNOBS``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from mpv_frame_interpolator_tpu_torch import models
from mpv_frame_interpolator_tpu_torch.convert import (
    DeviceFrame, frame_to_device)
from mpv_frame_interpolator_tpu_torch.frame import (
    NV12, FrameFormat, VideoFrame)
from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
from mpv_frame_interpolator_tpu_torch.ops import warp as warp_ops
from mpv_frame_interpolator_tpu_torch.ops.cuda.blend_levels import (
    blend_levels)
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_bilinear import (
    bilinear_blend)
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_fused import fused_blend
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_pair import pair_blend
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_sample import sample_dir
from mpv_frame_interpolator_tpu_torch.pipeline import scene as scene_mod
from mpv_frame_interpolator_tpu_torch.pipeline.cadence import (
    CadenceEngine, InterpolationState)
from mpv_frame_interpolator_tpu_torch.pipeline.quality import (
    QualityController)
from mpv_frame_interpolator_tpu_torch.utils import StatsRegistry, get_logger

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
    # "pallas" route and hopperq/hopperxq Q1 under any sampler; modes 0,
    # 1 and 3 always run on K5, modes 4-6 on none
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
    this frame's planes lazily."""

    __slots__ = ("pts", "fmt", "_y", "_uv", "_index")

    def __init__(self, pts: float, fmt: FrameFormat, y, uv,
                 index: Optional[int] = None):
        self.pts = pts
        self.fmt = fmt
        self._y = y
        self._uv = uv
        self._index = index

    def block(self):
        """Wait until the frame's planes are computed."""
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
        y, uv = self.device_planes()
        return VideoFrame(_to_numpy(y), _to_numpy(uv), self.fmt,
                          pts=self.pts)


FLOW_MODELS = ("hopper", "hopperx", "hopperq", "hopperxq")


def _flow_stage(geom, scale_shift: int, scene_enabled: bool, model: str,
                f1: DeviceFrame, f2: DeviceFrame, radius: int, ds: int,
                nbs: int, layers: int, subpel: bool = False):
    """Scene score + hierarchical flow of one pair: (blurred flow, frac or
    None, cut_score or None).  `layers` is the kernel's layer count for
    the radius.  The blend and repeat families search no flow: their field
    is zero (the score still runs).  Under `subpel` the unblurred offset
    is refined to 1/64 pel and that field blurred (JAX engine.py:486-515):
    hopperq and hopperxq take its floor and the 1/64-pel remainder `frac`,
    hopper and hopperx its rounding to the nearest pel."""
    score = (scene_mod.cut_score(f1.y, f2.y, geom.res_scalar, scale_shift)
             if scene_enabled else None)
    if model not in FLOW_MODELS:
        return torch.zeros((2, geom.low_h, geom.low_w), dtype=torch.int32,
                           device=f1.y.device), None, score
    args = (geom, f1.y, f1.u, f1.v, f2.y, f2.u, f2.v)
    if not subpel:
        _, blurred = flow_ops.flow(*args, radius, ds, nbs, scale_shift,
                                   layers=layers)
        return blurred, None, score
    offset = flow_ops.flow(*args, radius, ds, nbs, scale_shift,
                           layers=layers, blur=False)
    b64 = flow_ops.blur_flow(flow_ops.subpel_flow(*args[:1], offset,
                                                  *args[1:], scale_shift))
    if model in ("hopperq", "hopperxq"):
        blurred = b64 >> 6
        return blurred, b64 - (blurred << 6), score
    return (b64 + 32) >> 6, None, score


def _warp_stage(geom, scale_shift: int, levels, cut_policy: str,
                mode: int, sampling: str, model: str, planes, blurred, cut,
                ts, frac=None):
    """Cut folding + every output of the pair: (y, uv), each indexable by
    position -- (N, H, Wa) and (N, H/2, Wa) tensors from one pair-blend
    call, or lists of N planes.  `planes` is (f1y, f1uv, f2y, f2uv);
    `cut` is a 0-dim bool tensor or None; `frac` the sub-pel field of the
    bilinear families (their blended mode reads it) or None."""
    if cut is not None:
        blurred = blurred.masked_fill(cut, 0)
        if frac is not None:
            frac = frac.masked_fill(cut, 0)
        ts_cut = ((ts >= 0.5).to(torch.float32) if cut_policy == "nearest"
                  else torch.zeros_like(ts))
        ts = torch.where(cut, ts_cut, ts)
    if model == "repeat":
        ts = (ts >= 0.5).to(torch.float32)
    rs, wa = geom.res_scalar, geom.actual_width
    args = (*planes, blurred)
    n = ts.shape[0]
    blended = mode == warp_ops.BLENDED_FRAME
    if mode == warp_ops.GREY_FLOW:
        y, uv = warp_ops.grey_planes(blurred, rs, geom.height, wa,
                                     scale_shift, planes[0].dtype)
        return [y] * n, [uv] * n
    if blended and model in ("hopperq", "hopperxq"):
        outs = [bilinear_blend(*args, ts[i], rs, wa, scale_shift, levels,
                               model == "hopperxq", frac) for i in range(n)]
    elif blended and model == "hopperx":
        outs = [_blended_from_samples(mode, scale_shift, levels, rs, wa,
                                      args, ts[i], occlusion=True)
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
        outs = [warp_ops.warp_sbs(mode, *args, ts[i], rs, wa, scale_shift,
                                  levels) for i in range(n)]
    else:
        outs = [_blended_from_samples(mode, scale_shift, levels, rs, wa,
                                      args, ts[i]) for i in range(n)]
    return [y for y, _ in outs], [uv for _, uv in outs]


def _blended_from_samples(mode: int, scale_shift: int, levels, rs: int,
                          wa: int, args, t, occlusion: bool = False):
    """Mode 2 under "pallas" (and of hopperx, with the occlusion
    correction) and mode 3 at one position: the two directions' raw
    samples (K5), then the blend and level maps (G1); mode 3 blends at the
    default levels, recolours by the flow and level-maps the colours."""
    y12, uv12 = sample_dir(*args, t, 12, rs, wa)
    y21, uv21 = sample_dir(*args, t, 21, rs, wa)
    if mode != warp_ops.HSV_FLOW:
        return blend_levels(y12, uv12, y21, uv21, t, scale_shift, levels,
                            occlusion)
    # the default levels clip the blend to 255 << scale_shift, which the
    # colours cannot see: they read the blend >> scale_shift
    b_y, b_uv = blend_levels(y12, uv12, y21, uv21, t, scale_shift)
    b_y, b_uv = warp_ops.hsv_planes(b_y.to(torch.int32),
                                    b_uv.to(torch.int32), args[4], rs, wa,
                                    scale_shift)
    k, w = levels
    dtype = y12.dtype
    return (warp_ops.levels_y(b_y, k, w, scale_shift).to(dtype),
            warp_ops.levels_uv(b_uv, w, scale_shift).to(dtype))


class InterpolationEngine:
    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.config.device!r}: CUDA is not available "
                "(torch.cuda.is_available() is False)")
        self.cadence = CadenceEngine(self.config.display_fps,
                                     self.config.playback_speed)
        self.quality = QualityController(
            enabled=self.config.auto_quality,
            search_radius=self.config.initial_search_radius,
            too_slow_patience=self.config.too_slow_patience,
            max_level=len(self.config.degrade_rungs))
        self.stats = StatsRegistry()
        self.levels = warp_ops.level_ints(self.config.black_level,
                                          self.config.white_level)

        self.geom: Optional[flow_ops.FlowGeometry] = None
        self._geoms: List[flow_ops.FlowGeometry] = []  # [level 0, rung 1..]
        self._level_models: List[str] = []             # model per level
        self._scale_shift = 0
        self._fmt: Optional[FrameFormat] = None
        self._prev: Optional[DeviceFrame] = None
        self._cur: Optional[DeviceFrame] = None
        self._warm = False          # a pair of this geometry has run
        self._last_calc_duration = 0.0
        # the last pair's (start, flow end or None, end) CUDA events and
        # its output count
        self._pending_timing = None
        self._split_wanted = self.config.split_timing == "always"
        self._last_cut_score = None
        self._cuts = None           # device count of folded scene cuts
        self._ts_cache = {}

    # ------------------------------------------------------------------ #

    def set_speed(self, speed: float):
        self.cadence.set_speed(speed)

    def reset(self):
        """Seek reset: counters only; the next two source frames
        re-anchor the device buffers."""
        self.cadence.reset()
        self._prev = None
        self._cur = None

    def stage(self, frame: Union[VideoFrame, DeviceFrame]) -> DeviceFrame:
        """Upload a host frame to the engine's device (a frame already
        staged is returned as it is)."""
        if isinstance(frame, DeviceFrame):
            return frame
        return frame_to_device(frame, self.device)

    def _ensure_geometry(self, fmt: FrameFormat):
        if self._fmt is not None and (fmt.height, fmt.stride, fmt.width,
                                      fmt.pixfmt) == (
                self._fmt.height, self._fmt.stride, self._fmt.width,
                self._fmt.pixfmt):
            return
        self.geom = flow_ops.FlowGeometry.create(
            fmt.height, fmt.stride, fmt.width, self.config.max_calc_res,
            self.config.num_iterations)
        self._geoms = [self.geom]
        self._level_models = [self.config.model]
        for d_iter, res_div, model in self.config.degrade_rungs:
            self._geoms.append(flow_ops.FlowGeometry.create(
                fmt.height, fmt.stride, fmt.width,
                max(self.config.max_calc_res // res_div, 64),
                max(self.geom.iterations - d_iter, 1)))
            self._level_models.append(model or self.config.model)
        self._scale_shift = 0 if fmt.pixfmt == NV12 else 8
        self._fmt = fmt
        self._prev = None
        self._cur = None
        self._warm = False
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
        """Turn the previous pair's CUDA events into its duration, and its
        flow/warp split when it recorded one (waits for that pair only)."""
        if self._pending_timing is None:
            return
        start, mid, end, n_outputs = self._pending_timing
        self._pending_timing = None
        end.synchronize()
        self._record_duration(start.elapsed_time(end) * 1e-3)
        if mid is not None:
            self._record_split(start.elapsed_time(mid) * 1e-3,
                               mid.elapsed_time(end) * 1e-3, n_outputs)

    def _record_duration(self, dur: float):
        self._last_calc_duration = dur
        self.stats.add("source_frame_time", dur)

    def _record_split(self, flow_t: float, warp_t: float, n_outputs: int):
        self.stats.add("flow_time", flow_t)
        self.stats.add("warp_total", warp_t)
        self.stats.add("warp_time", warp_t / max(n_outputs, 1))

    # ------------------------------------------------------------------ #

    def push(self, frame: Union[VideoFrame, DeviceFrame]) -> List[OutputFrame]:
        """Process one source frame; returns the output frames due."""
        self._ensure_geometry(frame.fmt)
        # SideBySide2 interpolates on the first source frame as well (its
        # pair is the frame with itself)
        plan = self.cadence.on_source_frame(
            frame.pts, frame.nominal_fps,
            first_frame_interpolates=(self.config.frame_output_mode
                                      == warp_ops.SIDE_BY_SIDE_2))
        if plan.inconsistent_detected:
            log.warning("Inconsistent frame timings detected. Using less "
                        "accurate frame timing method to maintain A/V sync.")

        if plan.passthrough:
            if self.cadence.state == InterpolationState.ACTIVE \
                    and self.cadence.source_frame_num == 1:
                # first frame: keep it as the flow anchor
                self._prev = self._cur
                self._cur = self.stage(frame)
            return [OutputFrame(frame.pts, frame.fmt, frame.y, frame.uv)]

        # the controller reads the previous pair's duration
        self._collect_timing()
        self.quality.update(self._last_calc_duration, self.cadence)

        self._prev = self._cur
        self._cur = self.stage(frame)
        f1, f2 = self._prev, self._cur
        if f1 is None:
            f1 = f2
        radius = self.quality.search_radius
        level = self._active_level()
        geom = self._geoms[level]
        model = self._level_models[level]
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

        blurred, frac, score = _flow_stage(
            geom, self._scale_shift, self.config.scene_detection, model,
            f1, f2, radius, self.config.delta_scalar,
            self.config.neighbor_bias_scalar, self._layers_for(radius),
            self.config.subpel_flow)
        if split and on_cuda:
            mid.record()
        t_mid = time.perf_counter()
        cut = None
        if score is not None:
            cut = score > self.config.scene_threshold
            self._cuts = cut.to(torch.int32) if self._cuts is None \
                else self._cuts + cut
        y, uv = _warp_stage(geom, self._scale_shift, self.levels,
                            self.config.cut_policy,
                            self.config.frame_output_mode,
                            self.config.warp_sampling, model,
                            (f1.y, f1.uv, f2.y, f2.uv), blurred, cut, ts,
                            frac)

        if not timed:
            self._last_calc_duration = 0.0
        elif on_cuda:
            end.record()
            self._pending_timing = (start, mid, end, n_out)
        else:
            t_end = time.perf_counter()
            self._record_duration(t_end - t0)
            if split:
                self._record_split(t_mid - t0, t_end - t_mid, n_out)
        if self.config.measure_timing:
            self.stats.add("outputs", n_out)
        self._warm = True
        self._last_cut_score = score
        out_fmt = self._out_fmt()
        return [OutputFrame(slot.pts, out_fmt, y, uv, index=i)
                for i, slot in enumerate(plan.outputs)]

    def flush(self) -> List[OutputFrame]:
        """End of stream: nothing is held back; reads the last pair's
        timing so the stats cover every pair."""
        self._collect_timing()
        return []

    # telemetry
    def last_cut_score(self) -> float:
        if self._last_cut_score is None:
            return 0.0
        return float(self._last_cut_score)

    def scene_cuts(self) -> int:
        """How many pairs so far had a scene cut folded in (host sync)."""
        return 0 if self._cuts is None else int(self._cuts)
