"""The one general traffic driver: plays the ring of source frames through
the engine by the API its traffic mix names, and stamps each call.

* ``api: "push_many"`` -- a closed loop with dispatch ahead: each call
  hands ``frames_per_call`` frames to ``InterpolationEngine.push_many``
  with ``group_size``;
* ``api: "push"`` -- the player's path: one frame a call to
  ``InterpolationEngine.push``, back to back.

With ``"stamp_calls": true`` each call also gets two CUDA events on the
device clock: one recorded on an idle stream of its own as the
call begins (the card timestamps it at once), one on the engine's stream
after the call returns (after its last output).  ``latencies_ms`` reads
them once the card has drained.

Frames are the ring's, in order and wrapping, each a ``DeviceFrame`` of
planes already on the device, with pts i / source_fps for the i-th frame
of the stream.  Each call's outputs are dropped as soon as it returns (the
caching allocator reuses their memory only after the stream's work on
them), except the outputs of the frames the check samples and those of
the last call; the call's pts are kept.  ``drain`` waits until the card
has finished everything enqueued.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from mpv_frame_interpolator_tpu_torch.convert import DeviceFrame
from mpv_frame_interpolator_tpu_torch.frame import FrameFormat


@dataclasses.dataclass
class Call:
    first: int              # stream index of the call's first frame
    frames: int
    t0: float               # host clock before the call
    t1: float               # host clock after it returned
    pts: tuple              # its outputs' pts, in order
    marks: tuple = ()       # (start, end) CUDA events, with stamp_calls


class Stream:
    """The ring's frames in order, wrapping, as DeviceFrames."""

    def __init__(self, ring, fmt: FrameFormat, fps: float):
        self.ring = [DeviceFrame(y, uv, uv[:, 0::2].contiguous(),
                                 uv[:, 1::2].contiguous(), fmt)
                     for y, uv in ring]
        self.fps = fps
        self.next_index = 0

    def take(self, n: int) -> List[DeviceFrame]:
        i, self.next_index = self.next_index, self.next_index + n
        return [dataclasses.replace(self.ring[j % len(self.ring)],
                                    pts=j / self.fps, nominal_fps=self.fps)
                for j in range(i, i + n)]


class Driver:
    """Calls the engine as the traffic mix says."""

    def __init__(self, engine, stream: Stream, traffic: dict):
        if traffic["api"] not in ("push_many", "push"):
            raise ValueError(f"unknown api {traffic['api']!r}")
        self.engine = engine
        self.stream = stream
        self.many = traffic["api"] == "push_many"
        self.per_call = int(traffic["frames_per_call"])
        self.group = int(traffic["group_size"])
        if not self.many and self.per_call != 1:
            raise ValueError("push takes one frame a call")
        self.keep_pts: Dict[float, int] = {}    # pts -> sampled frame
        self.kept: Dict[int, list] = {}         # frame -> its outputs
        self.last: Optional[list] = None        # the last call's outputs
        self.side = None                        # the stamps' idle stream
        device = getattr(engine, "device", None)
        if (traffic.get("stamp_calls")
                and getattr(device, "type", None) == "cuda"):
            import torch
            self.side = torch.cuda.Stream(device)

    def _call(self, frames) -> Call:
        start = None
        if self.side is not None:
            import torch
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.side)
        t0 = time.perf_counter()
        if self.many:
            outs = self.engine.push_many(frames, group_size=self.group)
        else:
            outs = self.engine.push(frames[0])
        t1 = time.perf_counter()
        marks = ()
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            marks = (start, end)
        for o in outs:
            frame = self.keep_pts.get(o.pts)
            if frame is not None:
                self.kept.setdefault(frame, []).append(o)
        self.last = outs
        return Call(self.stream.next_index - len(frames), len(frames), t0,
                    t1, tuple(o.pts for o in outs), marks)

    def warm(self, calls: int, hold_pairs: int):
        """The stream's first frame (it passes through and anchors the
        flow) with the first call, then `calls` calls as the window makes
        them.  As many outputs as a run holds at its most are held to the
        end -- the `hold_pairs` pairs the check keeps through the window,
        the window's last call (kept for the check while a traced stretch
        follows) and the stretch's last call -- so that the caching
        allocator holds their memory when the window starts and makes no
        new segment in the window or the stretch."""
        self._call(self.stream.take(1 + (self.per_call if self.many else 0)))
        keep = -(-hold_pairs // self.per_call) + 2  # calls, rounded up
        held = []
        for _ in range(calls):
            self._call(self.stream.take(self.per_call))
            held = (held + [self.last])[-keep:]

    def run(self, seconds: float, max_calls: Optional[int] = None
            ) -> List[Call]:
        """Calls back to back until `seconds` have passed since the first
        (or `max_calls` calls)."""
        calls = []
        deadline = time.perf_counter() + seconds
        while True:
            calls.append(self._call(self.stream.take(self.per_call)))
            if max_calls is not None:
                if len(calls) >= max_calls:
                    return calls
            elif calls[-1].t1 >= deadline:
                return calls


def latencies_ms(calls: List[Call], device) -> List[float]:
    """Each call's time from its start to its last output (ms), once the
    card has drained: the device clock's where the calls were stamped; on
    the CPU, where a call returns its outputs computed, the call's span on
    the host clock; else none (a card's host span ends before its work)."""
    if calls and calls[0].marks:
        return [c.marks[0].elapsed_time(c.marks[1]) for c in calls]
    if device.type == "cpu":
        return [(c.t1 - c.t0) * 1e3 for c in calls]
    return []


def drain(device) -> float:
    """Wait until the card has finished all the work enqueued; the host
    clock then."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    return time.perf_counter()
