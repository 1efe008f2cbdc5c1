"""Output-cadence engine: N display-rate outputs per source frame (the
port's copy of the JAX package's ``pipeline/cadence.py``).

Pure-Python state machine reproducing the timing semantics of the reference
filter glue (vf_HopperRender.c):

* source/display timing + bypass decision        (vf_HopperRender.c:425-438)
* PTS synthesis: re-anchor on first 2 frames, on resync, or when drift
  exceeds 50 ms ("inconsistent timings" fallback) (vf_HopperRender.c:463-477)
* number of interpolated outputs per source      (vf_HopperRender.c:481)
* blending-scalar advance with wrap at 1.0       (vf_HopperRender.c:371-374)
* intermediate-frame PTS                         (vf_HopperRender.c:389-390)
* speed-change command -> resync                 (vf_HopperRender.c:541-555)
* seek reset                                     (vf_HopperRender.c:562-567)
* InterpolationState machine {Deactivated, NotNeeded, Active, TooSlow}
                                                 (vf_HopperRender.c:23)

It is deliberately free of any device/compute dependency so it can be
property-tested exhaustively (SURVEY.md §7 hard-part #5).

Deliberate simplification vs the reference: all of a source frame's output
slots are planned eagerly when the frame arrives, so a speed command lands
between source frames; the reference trickles intermediates through
repeated filter invocations and can in principle observe a speed change
between two intermediates of the same pair (vf_HopperRender.c:541-555 is
asynchronous).  The observable difference is at most one source frame of
command latency.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List

DEFAULT_SOURCE_FPS = 24000.0 / 1001.0   # vf_HopperRender.c:689
PTS_DRIFT_LIMIT = 0.05                  # vf_HopperRender.c:470

# Safety cap absent in the reference: a corrupt nominal_fps (e.g. 1e-9 from
# broken container metadata) would make numIntFrames explode
# (vf_HopperRender.c:481 has no bound) and wedge the pipeline emitting
# millions of intermediates for one source frame.  No sane display/source
# combination exceeds this.
MAX_INT_FRAMES = 128


class InterpolationState(enum.Enum):
    DEACTIVATED = 0
    NOT_NEEDED = 1
    ACTIVE = 2
    TOO_SLOW = 3


@dataclasses.dataclass
class OutputSlot:
    """One frame the engine must emit for the current source frame."""
    pts: float
    blend: float            # blendingScalar for the warp
    is_source_slot: bool    # first output (reference warps in-place into the
                            # source frame, vf_HopperRender.c:495-500)


@dataclasses.dataclass
class SourcePlan:
    """Decision for one incoming source frame."""
    passthrough: bool                  # emit source unmodified, untouched pts
    compute_flow: bool                 # sourceFrameNum >= 2
    outputs: List[OutputSlot]          # empty if passthrough
    inconsistent_detected: bool = False


class CadenceEngine:
    def __init__(self, display_fps: float = 60.0, playback_speed: float = 1.0):
        self.target_frame_time = 1.0 / display_fps
        self.playback_speed = playback_speed
        self.source_fps = DEFAULT_SOURCE_FPS
        self.source_frame_time = 1.0 / DEFAULT_SOURCE_FPS
        self.current_output_pts = 0.0
        self.blending_scalar = 0.0
        self.source_frame_num = 0
        self.num_int_frames = 1
        self.resync = False
        self.inconsistent_timings = False
        self.state = InterpolationState.ACTIVE

    # ---- commands -------------------------------------------------------

    def set_speed(self, speed: float):
        """Playback-speed command (vf_HopperRender.c:541-555): any command
        re-activates a NotNeeded/TooSlow filter; a speed change also
        triggers a PTS resync."""
        if self.playback_speed != speed:
            self.playback_speed = speed
            self.resync = True
        if self.state != InterpolationState.DEACTIVATED:
            self.state = InterpolationState.ACTIVE

    def set_active(self, active: bool):
        """Applet codes 0/1 (vf_HopperRender.c:128-135)."""
        if active:
            self.state = InterpolationState.ACTIVE
        else:
            self.state = InterpolationState.DEACTIVATED
            self.source_frame_num = 0
            self.blending_scalar = 0.0

    def reset(self):
        """Seek reset (vf_HopperRender.c:562-567)."""
        self.source_frame_num = 0
        self.blending_scalar = 0.0

    def mark_too_slow(self):
        self.state = InterpolationState.TOO_SLOW

    # ---- per-source-frame planning ---------------------------------------

    def on_source_frame(self, pts: float, nominal_fps: float,
                        first_frame_interpolates: bool = False) -> SourcePlan:
        """Plan the outputs for one incoming source frame.

        Mirrors vf_HopperRender_process_new_source_frame
        (vf_HopperRender.c:412-505) minus the device work.

        first_frame_interpolates reproduces the SideBySide2 special case
        (vf_HopperRender.c:495: that mode interpolates even on source frame
        1, so the layout is visible immediately); the engine pairs the
        first frame with itself there instead of reading an uninitialized
        device buffer like the reference does."""
        if nominal_fps > 0.0:
            self.source_fps = nominal_fps
        self.source_frame_time = 1.0 / (self.source_fps * self.playback_speed)

        # bypass decisions (vf_HopperRender.c:431-438)
        if self.source_frame_time <= self.target_frame_time:
            self.state = InterpolationState.NOT_NEEDED
            return SourcePlan(True, False, [])
        elif self.state == InterpolationState.NOT_NEEDED:
            self.state = InterpolationState.ACTIVE
        elif self.state != InterpolationState.ACTIVE:
            return SourcePlan(True, False, [])

        self.source_frame_num += 1
        inconsistent_detected = False

        # PTS anchoring (vf_HopperRender.c:463-477)
        if self.source_frame_num <= 2 or self.resync or self.inconsistent_timings:
            self.current_output_pts = pts
            self.resync = False
        else:
            self.current_output_pts += self.target_frame_time * self.playback_speed
            if abs(pts - self.current_output_pts) > PTS_DRIFT_LIMIT:
                inconsistent_detected = True
                self.inconsistent_timings = True
                self.current_output_pts = pts

        # outputs per source frame (vf_HopperRender.c:481), safety-capped
        ratio = self.target_frame_time / self.source_frame_time
        self.num_int_frames = int(min(
            max(math.ceil((1.0 - self.blending_scalar) / ratio), 1.0),
            MAX_INT_FRAMES))

        outputs: List[OutputSlot] = []
        if self.source_frame_num >= 2 or first_frame_interpolates:
            # first output replaces the source frame (vf:495-500)
            outputs.append(OutputSlot(self.current_output_pts,
                                      self.blending_scalar, True))
            self._advance_blend()
            for _ in range(1, self.num_int_frames):
                self.current_output_pts += self.target_frame_time * self.playback_speed
                outputs.append(OutputSlot(self.current_output_pts,
                                          self.blending_scalar, False))
                self._advance_blend()
            return SourcePlan(False, self.source_frame_num >= 2, outputs,
                              inconsistent_detected=inconsistent_detected)

        # first frame ever: emitted unmodified, but pts already rewritten
        return SourcePlan(True, False, [],
                          inconsistent_detected=inconsistent_detected)

    def _advance_blend(self):
        """vf_HopperRender.c:371-374.

        Reference-exact float accumulation, including its wrap artifact:
        at exact integer display/source ratios whose step is not binary-
        representable (e.g. 6->60, step 0.1), N accumulated steps can land
        just BELOW 1.0, missing the wrap; the next pair then plans ~1
        output and the pts-drift fallback re-anchors.  24->60 (0.4) and
        30->60 (0.5) are unaffected.  Kept as-is deliberately: the
        reference computes the same float recurrence."""
        self.blending_scalar += self.target_frame_time / self.source_frame_time
        if self.blending_scalar >= 1.0:
            self.blending_scalar -= 1.0
