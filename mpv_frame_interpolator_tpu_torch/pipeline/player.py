"""Pipeline of the port: source -> engine -> present -> sink (counterpart
of the JAX package's ``pipeline/player.Pipeline``, its untimed core).

Unlike the JAX pipeline this slice is not fail-open: an engine error
propagates instead of turning into passed-through source frames, so a
kernel that fails cannot hide behind a playing video.  Prefetch threads,
commands, pause, seek and looping are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, Optional

from mpv_frame_interpolator_tpu_torch.frame import VideoFrame
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    InterpolationEngine)
from mpv_frame_interpolator_tpu_torch.pipeline.present import PresentClock


class Pipeline:
    def __init__(self, source: Iterable[VideoFrame],
                 engine: InterpolationEngine, sink,
                 present: Optional[PresentClock] = None):
        self.source = source
        self.engine = engine
        self.sink = sink
        self.present = present
        self.frames_in = 0
        self.frames_out = 0

    def run(self, max_source_frames: Optional[int] = None) -> int:
        """Push every source frame through the engine and hand each due
        output to the sink (dropping what the present clock drops);
        returns the number of frames written."""
        try:
            for frame in self.source:
                outs = self.engine.push(frame)
                self.frames_in += 1
                for out in outs:
                    if self.present is not None \
                            and self.present.present(out.pts).dropped:
                        continue
                    self.sink.write(out)
                    self.frames_out += 1
                if max_source_frames and self.frames_in >= max_source_frames:
                    break
            self.engine.flush()
        finally:
            self.sink.close()
        return self.frames_out
