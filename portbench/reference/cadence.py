"""The output cadence of a constant-rate source (vf_HopperRender.c:412-505).

For each source frame: nothing (the frame passes through, or it is the
first of the stream) or the list of (pts, blend position) it emits.  The
float recurrences are the filter's own, in the same order, so equal
arithmetic gives equal bits: the blend position advances by the ratio of
the display to the source frame time and wraps at 1.0, and the output pts
advances by the display frame time, re-anchored on the first two frames
and whenever it drifts more than 50 ms from the source pts.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

DRIFT_LIMIT_S = 0.05        # vf_HopperRender.c:470
MAX_OUTPUTS = 128           # a cap on outputs a source frame


class Cadence:
    """The cadence of one stream at `display_fps`, playback speed 1."""

    def __init__(self, display_fps: float):
        self.target = 1.0 / display_fps
        self.blend = 0.0
        self.frames = 0
        self.pts = 0.0
        self.drifted = False

    def on_frame(self, pts: float, source_fps: float
                 ) -> Optional[List[Tuple[float, float]]]:
        """The (pts, blend) outputs of the next source frame, or None where
        the frame is passed through unchanged."""
        source_time = 1.0 / (source_fps * 1.0)
        if source_time <= self.target:
            return None
        self.frames += 1
        if self.frames <= 2 or self.drifted:
            self.pts = pts
        else:
            self.pts += self.target * 1.0
            if abs(pts - self.pts) > DRIFT_LIMIT_S:
                self.drifted = True
                self.pts = pts
        ratio = self.target / source_time
        count = int(min(max(math.ceil((1.0 - self.blend) / ratio), 1.0),
                        MAX_OUTPUTS))
        if self.frames < 2:
            return None
        out = [(self.pts, self.blend)]
        self._advance(source_time)
        for _ in range(1, count):
            self.pts += self.target * 1.0
            out.append((self.pts, self.blend))
            self._advance(source_time)
        return out

    def _advance(self, source_time: float):
        self.blend += self.target / source_time
        if self.blend >= 1.0:
            self.blend -= 1.0


def plan(frames: int, source_fps: float, display_fps: float):
    """The outputs of source frames 0 .. frames - 1 with pts i / fps: a
    list, None for a frame that emits nothing of its own."""
    c = Cadence(display_fps)
    return [c.on_frame(i / source_fps, source_fps) for i in range(frames)]
