"""Pair-parallel scaling: one source pair per device slot (counterpart of
the JAX package's ``parallel/batch.py``).

Consecutive source pairs are independent given the cadence plan (the
flow is computed from scratch for each pair, opticalFlowCalc.c:153), so
slot d computes every D-th pair's flow and outputs.  No collectives: the
slots share nothing but the host's cadence.  A slot is a device and a
``torch.cuda.Stream`` of its own on it, so a device may be named more
than once: two slots on one card run their pairs on two streams, which
may overlap.  (The latency-oriented decomposition of one pair --
layer-sharded flow, row-sharded warp -- is ``parallel/sharding.py``.)
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, List, Optional, Sequence

import torch

from mpv_frame_interpolator_tpu_torch.convert import require_device
from mpv_frame_interpolator_tpu_torch.frame import FrameFormat, VideoFrame
from mpv_frame_interpolator_tpu_torch.pipeline.cadence import CadenceEngine
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine, OutputFrame, ready_event)
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("pairpool")


class _Slot:
    """One device slot: an engine whose pair body (flow stage, warp stage)
    runs the slot's pairs, on the slot's own stream on a card."""

    def __init__(self, config: EngineConfig, device: torch.device):
        self.device = device
        self.engine = InterpolationEngine(dataclasses.replace(
            config, device=str(device)))
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.pairs = 0

    def context(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())


class PairParallelPool:
    """Round-robin source pairs over device slots.

    push(frame) plans the cadence on the host (serial, cheap) with a fixed
    radius (the config's initial radius, no quality controller) and runs
    the pair's body on slot i % D; the outputs carry the shared cadence's
    pts, so the stream is the single engine's, computed in parallel.
    `devices` defaults to every visible card (to the config's device when
    that is the CPU); each output's planes are on its slot's device and
    its ``block``/``to_video_frame`` wait for the slot's stream."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 devices: Optional[Sequence] = None):
        self.config = config or EngineConfig()
        if devices is None:
            base = require_device(self.config.device)
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if base.type == "cuda" else [base])
        devices = [require_device(d) for d in devices]
        if not devices:
            raise ValueError("a pair pool needs at least one device")
        self.devices = devices
        self._slots = [_Slot(self.config, d) for d in devices]
        self.cadence = CadenceEngine(self.config.display_fps,
                                     self.config.playback_speed)
        self._fmt: Optional[FrameFormat] = None
        self._prev_host: Optional[VideoFrame] = None
        self._i = 0

    def pairs_per_slot(self) -> List[int]:
        """The pairs each slot has computed."""
        return [s.pairs for s in self._slots]

    def _ensure_geometry(self, frame: VideoFrame):
        fmt = frame.fmt
        if self._fmt is not None and (fmt.height, fmt.stride, fmt.width,
                                      fmt.pixfmt) == (
                self._fmt.height, self._fmt.stride, self._fmt.width,
                self._fmt.pixfmt):
            return
        self._fmt = fmt
        self._prev_host = None
        self.cadence.reset()

    def push(self, frame: VideoFrame) -> List[OutputFrame]:
        self._ensure_geometry(frame)
        plan = self.cadence.on_source_frame(frame.pts, frame.nominal_fps)
        if plan.passthrough:
            if self.cadence.source_frame_num == 1:
                self._prev_host = frame
            return [OutputFrame(frame.pts, frame.fmt, frame.y, frame.uv)]

        slot = self._slots[self._i % len(self._slots)]
        self._i += 1
        f1 = self._prev_host if self._prev_host is not None else frame
        self._prev_host = frame
        eng = slot.engine
        eng._ensure_geometry(frame.fmt)
        with slot.context():
            # each pair uploads both of its frames to its slot (the
            # engine's upload leaves a frame's buffers to the caller)
            d1, d2 = eng._use(f1), eng._use(frame)
            ts = eng._ts_for(tuple(s.blend for s in plan.outputs))
            y, uv, _ = eng._pair_outputs(0, self.config.initial_search_radius,
                                         d1, d2, ts, eng._cuts, eng._knobs())
            ready = ready_event(slot.device)
        slot.pairs += 1
        out_fmt = eng._out_fmt()
        return [OutputFrame(s.pts, out_fmt, y, uv, index=i, ready=ready)
                for i, s in enumerate(plan.outputs)]

    def run(self, source: Iterable[VideoFrame]):
        for frame in source:
            yield from self.push(frame)
