"""Present clock: display pacing and display-sync accounting (the port's
copy of the JAX package's ``pipeline/present.py``, without the feedback
statistics -- refresh estimate and jitter -- that the port does not
report yet).

Host-side analog of the reference's VO timing machinery:

* vo_null's simulated display (video/out/vo_null.c:39-53): flips are
  quantized to a vblank grid; `VOCTRL_GET_DISPLAY_FPS` reports the nominal
  rate (:79-83).  `untimed` skips the waiting entirely
  (options/options.c:803 --untimed), which is what benchmarks use.
  `actual_fps` simulates a panel whose true refresh differs from the
  nominal mode (the 59.94-vs-60 case vo.c's estimation exists for).
* flips are recorded with the vblank slot they landed on
  (video/out/vo.c:416-530), so skipped vblanks are counted;
* display-sync scheduling (player/video.c:810-944): each content frame is
  assigned an integer number of vsyncs; the sub-vsync error accumulates so
  e.g. 24 fps content on a 60 Hz grid gets the 3:2 cadence, and the next
  frame is never scheduled inside the previous frame's repeats.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional


@dataclasses.dataclass
class PresentInfo:
    vsync_index: int        # which vblank this frame was assigned to
    num_vsyncs: int         # display-sync repeats for this frame
    scheduled_time: float   # wall-clock target
    late_by: float          # >0 if the frame missed its vblank
    dropped: bool


class PresentClock:
    """Paces frame presentation against a real or simulated display.

    `clock` is injectable (perf_counter/sleep) so display-sync behavior is
    testable without real-time waits."""

    def __init__(self, display_fps: float = 60.0, untimed: bool = False,
                 history: int = 1000, actual_fps: Optional[float] = None,
                 clock=time):
        self.display_fps = display_fps          # nominal (what the mode says)
        self.vsync_interval = 1.0 / (actual_fps or display_fps)
        self.untimed = untimed
        self._clock = clock
        self._t0: Optional[float] = None
        self._vsync_index = -1
        self._flips = deque(maxlen=history)   # (time, slot) ring (vo.c:481)
        self.drops = 0
        self.skips = 0            # vsync_skip_detection analog (vo.c:451)
        self.presented = 0
        self._last_pts: Optional[float] = None
        self._pts0: Optional[float] = None
        self._vsync_error = 0.0   # sub-vsync drift accumulator (video.c:868)

    def present(self, pts: float) -> PresentInfo:
        """Schedule one output frame carrying content timestamp `pts`.

        Maps the pts timeline onto the vblank grid anchored at the first
        present; holds each frame for its display-sync repeat count; waits
        for the assigned vblank unless untimed."""
        now = self._clock.perf_counter()
        if self._t0 is None:
            self._t0 = now
            self._pts0 = pts

        ideal = self._t0 + (pts - self._pts0)
        slot = max(round((ideal - self._t0) / self.vsync_interval), 0)

        # display-sync repeats: the inter-frame pts gap in vsync units,
        # with the fractional error carried over (player/video.c:868-880)
        # so 24fps-on-60Hz produces the 3:2 pulldown cadence, not a
        # constant round().
        num_vsyncs = 1
        if self._last_pts is not None:
            ratio = (pts - self._last_pts) / self.vsync_interval
            num_vsyncs = max(int(round(ratio + self._vsync_error)), 1)
            self._vsync_error += ratio - num_vsyncs
            # never schedule inside the previous frame's repeats
            slot = max(slot, self._vsync_index + num_vsyncs)
        elif self._vsync_index >= 0:
            slot = max(slot, self._vsync_index + 1)
        self._last_pts = pts

        target = self._t0 + slot * self.vsync_interval
        late = 0.0
        dropped = False
        if not self.untimed:
            wait = target - self._clock.perf_counter()
            if wait > 0:
                self._clock.sleep(wait)
            else:
                late = -wait
                # vo.c:958-967: frames later than one vsync are dropped
                if late > self.vsync_interval:
                    dropped = True
                    self.drops += 1
        now2 = self._clock.perf_counter()
        if self._flips and not self.untimed:
            # flip landed far beyond its assigned vblank = skipped vblanks
            t_prev, slot_prev = self._flips[-1]
            expected = max(slot - slot_prev, 1) * self.vsync_interval
            if now2 - t_prev > 1.5 * expected:
                self.skips += 1
        self._vsync_index = slot
        self._flips.append((now2, slot))
        self.presented += 1
        return PresentInfo(slot, num_vsyncs, target, late, dropped)
