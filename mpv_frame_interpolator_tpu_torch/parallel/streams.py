"""Multi-stream serving: K independent streams on one card (counterpart of
the JAX package's ``parallel/streams.py``).

    ms = MultiStreamEngine(EngineConfig(...), n_streams=4)
    for step_frames in zip(*sources):          # one frame per stream
        outs = ms.push_batch(step_frames)      # {stream_id: [OutputFrame]}

Each stream is a full InterpolationEngine -- its own cadence, quality
controller, scene state, stats and telemetry, like K instances of the
reference filter (the per-instance priv of vf_HopperRender.c).  When one
stream's content gets expensive, only that stream degrades (search
radius, TooSlow).

Dispatch: by default each stream's engine pushes its frame in turn
(sequential, ``push``: its own timing, its own controller, its own
ladder).  ``batch_dispatch=True`` keeps the JAX package's lockstep
semantics without its ``vmap``: one host call runs the step's pairs back
to back on the current stream, inside one event-timed window (CUDA events
on a card, the host clock on the CPU), each pair at its own stream's
radius (and so on the kernel instantiation of that radius' layer bucket)
with its blend positions padded to the step's widest count with its last
blend.  That window's duration is the one timing signal: it feeds every
stream's controller at the next step (a step whose (mode, width, model)
ran for the first time records none), and each stream's scene detector is
fed its own score.  Its outputs equal the sequential path's.

All streams share one geometry and pixel format (mixed formats go to
separate engines, or to ``parallel/farm.StreamFarm``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from mpv_frame_interpolator_tpu_torch.frame import FrameFormat, VideoFrame
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine, OutputFrame, ready_event)
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("streams")


class MultiStreamEngine:
    def __init__(self, config: Optional[EngineConfig] = None,
                 n_streams: int = 2, batch_dispatch: bool = False):
        self.config = config or EngineConfig()
        self.n = n_streams
        self.batch_dispatch = batch_dispatch
        # one full engine per stream: per-instance cadence, quality,
        # scene and stats, like K instances of the reference filter
        self.engines: List[InterpolationEngine] = [
            InterpolationEngine(self.config) for _ in range(n_streams)]
        self.device = self.engines[0].device
        self._fmt: Optional[FrameFormat] = None
        # batch-dispatch state (the batched path manages pairs itself)
        self._prev: List = [None] * n_streams
        self._last_batch_dur = 0.0
        self._warm = set()    # (mode, n_max, model) that ran once

    # views over the per-stream engines ----------------------------------

    @property
    def cadences(self):
        return [e.cadence for e in self.engines]

    @property
    def qualities(self):
        return [e.quality for e in self.engines]

    def stats(self, sid: int):
        return self.engines[sid].stats

    # ---------------------------------------------------------------------

    def _ensure_geometry(self, frame: VideoFrame):
        fmt = frame.fmt
        if self._fmt is None:
            self._fmt = fmt
        elif (fmt.height, fmt.stride, fmt.width, fmt.pixfmt) != (
                self._fmt.height, self._fmt.stride, self._fmt.width,
                self._fmt.pixfmt):
            raise ValueError("all streams in a batch share one geometry; "
                             "route other formats to a separate engine")

    def push_batch(self, frames: Sequence[Optional[VideoFrame]]
                   ) -> Dict[int, List[OutputFrame]]:
        """One frame per stream (None = stream idle this step).  Returns
        {stream_index: [OutputFrame, ...]}."""
        if len(frames) != self.n:
            raise ValueError(f"{len(frames)} frames for {self.n} streams")
        for frame in frames:
            if frame is not None:
                self._ensure_geometry(frame)
        if not self.batch_dispatch:
            # each stream's own engine does cadence, quality, scene and
            # telemetry, so behaviour matches K single engines
            return {sid: self.engines[sid].push(frame)
                    for sid, frame in enumerate(frames)
                    if frame is not None}
        return self._push_batched(frames)

    def _push_batched(self, frames) -> Dict[int, List[OutputFrame]]:
        results: Dict[int, List[OutputFrame]] = {}
        batch = []   # (stream_id, plan, f1, f2)
        timing = self.config.measure_timing

        for sid, frame in enumerate(frames):
            if frame is None:
                continue
            eng = self.engines[sid]
            eng._ensure_geometry(frame.fmt)
            # the last step's shared duration to this stream's controller
            # (lockstep dispatch: one timing signal)
            if timing:
                eng.quality.update(self._last_batch_dur, eng.cadence)
            plan = eng.cadence.on_source_frame(frame.pts,
                                               frame.nominal_fps)
            if plan.passthrough:
                if eng.cadence.source_frame_num == 1:
                    self._prev[sid] = frame
                results[sid] = [OutputFrame(frame.pts, frame.fmt, frame.y,
                                            frame.uv)]
                continue
            f1 = self._prev[sid] if self._prev[sid] is not None else frame
            batch.append((sid, plan, f1, frame))

        if not batch:
            return results

        n_max = max(len(p.outputs) for _, p, _, _ in batch)
        on_cuda = self.device.type == "cuda"
        if timing and on_cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        outs = []
        for sid, plan, f1, f2 in batch:
            eng = self.engines[sid]
            d1, d2 = eng._use(f1), eng._use(f2)
            self._prev[sid] = d2
            blends = tuple(s.blend for s in plan.outputs)
            # padded with the last blend (wasted slots, one width a step)
            ts = eng._ts_for(blends + (blends[-1],) * (n_max - len(blends)))
            outs.append(eng._pair_outputs(0, eng.quality.search_radius, d1,
                                          d2, ts, eng._cuts, eng._knobs()))
        ready = ready_event(self.device)

        for (sid, plan, _, _), (y, uv, _) in zip(batch, outs):
            out_fmt = self.engines[sid]._out_fmt()
            results[sid] = [
                OutputFrame(slot.pts, out_fmt, y, uv, index=k, ready=ready)
                for k, slot in enumerate(plan.outputs)]
        if timing:
            if on_cuda:
                end.record()
                end.synchronize()
                dur = start.elapsed_time(end) * 1e-3
            else:
                dur = time.perf_counter() - t0
            spec = (self.config.frame_output_mode, n_max, self.config.model)
            was_warm = spec in self._warm
            self._warm.add(spec)
            # the first run of a spec carries the kernel build: no
            # measurement
            self._last_batch_dur = dur if was_warm else 0.0
            for (sid, plan, _, _), (_, _, score) in zip(batch, outs):
                eng = self.engines[sid]
                if was_warm:
                    eng.stats.add("source_frame_time", self._last_batch_dur)
                eng.stats.add("outputs", len(plan.outputs))
                eng.scene.is_cut(0.0 if score is None else float(score))
        return results
