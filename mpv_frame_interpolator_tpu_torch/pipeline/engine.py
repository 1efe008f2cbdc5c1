"""InterpolationEngine of the port (counterpart of the JAX package's
``pipeline/engine.py``): model ``hopper``, blended output (mode 2), 8-bit
NV12 or 10-bit P010, any black/white levels.

Per source pair, on the engine's device and without a host sync:

1. the scene-cut score (``pipeline/scene.cut_score``);
2. the flow pyramid and its blur (``ops/flow.flow``: the flow-step and
   blur kernels);
3. the cut folded in on the device: where the score exceeds the
   threshold the flow is zeroed and the blend positions snap to the
   nearer source (``torch.where``, no host branch);
4. the blended outputs, luma and interleaved chroma: under
   ``warp_sampling`` "pair" (the default), "shift" or "gather" every blend
   position of the pair in one call of the pair-blend kernel
   (``ops/cuda/warp_pair.py``); under "fused" one call of the fused kernel
   (``ops/cuda/warp_fused.py``) per blend position.  In the JAX package
   "pair", "shift" and "gather" are XLA or Pallas sampling strategies with
   identical outputs, so here they share one kernel; "fused" has its own,
   as the JAX package's has.  "pallas" (the JAX package's tiled sampler,
   K5) is not ported yet.

P010 frames run with scale_shift 8 (the JAX engine's ``_scale_shift``):
the flow's SAD and the cut score are shifted back to the 8-bit scale, the
blend keeps 16 fraction bits, and the outputs are uint16 capped at
255 << 8.  Black/white levels are rounded half to even once, when the
engine is made.

The host side -- output cadence (``CadenceEngine``), the auto-quality
controller (``QualityController``) and the stats -- are the port's copies
of the JAX package's modules.  The duration the controller reads is the
pair's calc time: CUDA events from before the pair's first launch is
enqueued to after its last kernel completes, so it holds the host's
enqueue time as well as the card's work (wall time on the CPU).  It is read back at the next push so that no push
waits for its own pair.

Not ported yet: degradation rungs, ``push_many``, split timing,
background precompile and the compile cache.  A configuration the port
does not cover raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from mpv_frame_interpolator_tpu_torch.convert import (
    DeviceFrame, frame_to_device)
from mpv_frame_interpolator_tpu_torch.frame import (
    NV12, FrameFormat, VideoFrame)
from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
from mpv_frame_interpolator_tpu_torch.ops import warp as warp_ops
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_fused import fused_blend
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_pair import pair_blend
from mpv_frame_interpolator_tpu_torch.pipeline import scene as scene_mod
from mpv_frame_interpolator_tpu_torch.pipeline.cadence import (
    CadenceEngine, InterpolationState)
from mpv_frame_interpolator_tpu_torch.pipeline.quality import (
    QualityController)
from mpv_frame_interpolator_tpu_torch.utils import StatsRegistry, get_logger

log = get_logger("engine")


@dataclasses.dataclass
class EngineConfig:
    """The slice of the JAX EngineConfig the port covers, plus the
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
    model: str = "hopper"
    # "pair", "shift", "gather": every position of a pair in one K2 call;
    # "fused": one K4 call per position; "pallas": not ported (K5)
    warp_sampling: str = "pair"
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
        if self.frame_output_mode != warp_ops.BLENDED_FRAME:
            raise NotImplementedError(
                f"output mode {self.frame_output_mode}: the port covers "
                "mode 2 (blended) only")
        if self.model != "hopper":
            raise NotImplementedError(
                f"model {self.model!r}: the port covers 'hopper' only")
        if self.warp_sampling == "pallas":
            raise NotImplementedError(
                "warp_sampling 'pallas' runs the TPU's tiled sampler "
                "(K5, ops/pallas/warp_sample.py), which is not ported yet; "
                "'pair', 'shift', 'gather' and 'fused' are")
        if self.initial_search_radius > flow_ops.MAX_SEARCH_RADIUS:
            raise NotImplementedError(
                f"search radius above {flow_ops.MAX_SEARCH_RADIUS} is not "
                "ported")


def _to_numpy(plane) -> np.ndarray:
    if isinstance(plane, torch.Tensor):
        return plane.cpu().numpy()
    return np.asarray(plane)


class OutputFrame:
    """A produced frame; planes may live on the device until materialized.

    Warped outputs of one source pair share one batched tensor (or, from
    the fused kernel, one list of per-position planes); `index` selects
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


def _flow_stage(geom, scale_shift: int, scene_enabled: bool,
                f1: DeviceFrame, f2: DeviceFrame, radius: int, ds: int,
                nbs: int):
    """Scene score + hierarchical flow of one pair: (blurred flow,
    cut_score or None)."""
    score = (scene_mod.cut_score(f1.y, f2.y, geom.res_scalar, scale_shift)
             if scene_enabled else None)
    _, blurred = flow_ops.flow(geom, f1.y, f1.u, f1.v, f2.y, f2.u, f2.v,
                               radius, ds, nbs, scale_shift)
    return blurred, score


def _warp_stage(geom, scale_shift: int, levels, cut_policy: str,
                fused: bool, f1: DeviceFrame, f2: DeviceFrame, blurred,
                cut, ts):
    """Cut folding + every blend position of the pair: (y, uv), each
    indexable by position -- (N, H, Wa) and (N, H/2, Wa) tensors from one
    pair-blend call, or lists of N planes from N fused calls.  `cut` is a
    0-dim bool tensor or None."""
    if cut is not None:
        blurred = blurred.masked_fill(cut, 0)
        ts_cut = ((ts >= 0.5).to(torch.float32) if cut_policy == "nearest"
                  else torch.zeros_like(ts))
        ts = torch.where(cut, ts_cut, ts)
    args = (f1.y, f1.uv, f2.y, f2.uv, blurred)
    rest = (geom.res_scalar, geom.actual_width, scale_shift, levels)
    if not fused:
        return pair_blend(*args, ts, *rest)
    outs = [fused_blend(*args, ts[i], *rest) for i in range(ts.shape[0])]
    return [y for y, _ in outs], [uv for _, uv in outs]


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
            too_slow_patience=self.config.too_slow_patience)
        self.stats = StatsRegistry()
        self.levels = warp_ops.level_ints(self.config.black_level,
                                          self.config.white_level)

        self.geom: Optional[flow_ops.FlowGeometry] = None
        self._scale_shift = 0
        self._fmt: Optional[FrameFormat] = None
        self._prev: Optional[DeviceFrame] = None
        self._cur: Optional[DeviceFrame] = None
        self._warm = False          # a pair of this geometry has run
        self._last_calc_duration = 0.0
        self._pending_timing = None  # (start, end) events of the last pair
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
        self._scale_shift = 0 if fmt.pixfmt == NV12 else 8
        self._fmt = fmt
        self._prev = None
        self._cur = None
        self._warm = False
        self.cadence.reset()
        log.info("flow geometry: %s (pixfmt=%s, device %s)", self.geom,
                 fmt.pixfmt, self.device)

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
        """Turn the previous pair's CUDA events into its duration (waits
        for that pair only)."""
        if self._pending_timing is None:
            return
        start, end = self._pending_timing
        self._pending_timing = None
        end.synchronize()
        self._record_duration(start.elapsed_time(end) * 1e-3)

    def _record_duration(self, dur: float):
        self._last_calc_duration = dur
        self.stats.add("source_frame_time", dur)

    # ------------------------------------------------------------------ #

    def push(self, frame: Union[VideoFrame, DeviceFrame]) -> List[OutputFrame]:
        """Process one source frame; returns the output frames due."""
        self._ensure_geometry(frame.fmt)
        plan = self.cadence.on_source_frame(frame.pts, frame.nominal_fps)
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
        geom = self.geom
        ts = self._ts_for(tuple(slot.blend for slot in plan.outputs))
        # the first pair of a geometry carries the kernel build: its
        # duration is no measurement (0.0, as the JAX engine's cold pair)
        timed = self.config.measure_timing and self._warm
        on_cuda = self.device.type == "cuda"
        if timed and on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()

        blurred, score = _flow_stage(
            geom, self._scale_shift, self.config.scene_detection, f1, f2,
            self.quality.search_radius,
            self.config.delta_scalar, self.config.neighbor_bias_scalar)
        cut = None
        if score is not None:
            cut = score > self.config.scene_threshold
            self._cuts = cut.to(torch.int32) if self._cuts is None \
                else self._cuts + cut
        y, uv = _warp_stage(geom, self._scale_shift, self.levels,
                            self.config.cut_policy,
                            self.config.warp_sampling == "fused", f1, f2,
                            blurred, cut, ts)

        if not timed:
            self._last_calc_duration = 0.0
        elif on_cuda:
            end.record()
            self._pending_timing = (start, end)
        else:
            self._record_duration(time.perf_counter() - t0)
        if self.config.measure_timing:
            self.stats.add("outputs", len(plan.outputs))
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
