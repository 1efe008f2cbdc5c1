"""Auto quality-scaling controller (the port's copy of the JAX package's
``pipeline/quality.py``, its degradation ladder included).

Reproduces vf_HopperRender_auto_adjust_settings (vf_HopperRender.c:304-349)
with the thresholds from config.h:6-13: if the measured per-source-frame
compute time (flow calc + all warps) exceeds sourceFrameTime/UPPER_PERF_BUFFER
the search radius is decremented (floor MIN_SEARCH_RADIUS, then the
degradation ladder's rungs, then the filter declares itself TooSlow); with
headroom beyond LOWER_PERF_BUFFER the ladder unwinds first and the radius
is then incremented back up to MAX_SEARCH_RADIUS."""

from __future__ import annotations

import dataclasses

from mpv_frame_interpolator_tpu_torch.pipeline.cadence import CadenceEngine

MIN_SEARCH_RADIUS = 5      # config.h:6
MAX_SEARCH_RADIUS = 16     # config.h:7
UPPER_PERF_BUFFER = 1.4    # config.h:12
LOWER_PERF_BUFFER = 1.6    # config.h:13


@dataclasses.dataclass
class QualityController:
    enabled: bool = True                       # config.h:10
    search_radius: int = MIN_SEARCH_RADIUS     # opticalFlowCalc.c:330
    min_radius: int = MIN_SEARCH_RADIUS
    max_radius: int = MAX_SEARCH_RADIUS
    upper_buffer: float = UPPER_PERF_BUFFER
    lower_buffer: float = LOWER_PERF_BUFFER
    # The reference flips TooSlow on the FIRST over-budget frame at the
    # floor radius (vf_HopperRender.c:330-337), so one scheduler hiccup
    # permanently disables interpolation until a user command arrives.
    # patience > 1 requires that many consecutive over-budget frames --
    # set to 1 for exact reference behavior.
    too_slow_patience: int = 3
    # Degradation LADDER beyond the radius floor (EngineConfig.
    # degrade_rungs): level 0 = configured quality; each +1 is one rung
    # down (fewer pyramid iterations, a lower calc resolution, or a
    # cheaper family).  Stepping down is gated on rung_warm, a callable
    # level -> bool an engine may set; None lets every rung be entered
    # (the port's engine builds its kernels once, so every rung is warm).
    max_level: int = 0
    level: int = 0
    rung_warm = None          # callable level->bool, set by an engine
    _over_budget_streak: int = 0

    def _rung_ready(self, lvl: int) -> bool:
        return self.rung_warm is None or self.rung_warm(lvl)

    def update(self, calc_duration: float, cadence: CadenceEngine):
        """Feed the measured flow+warp duration for the previous source
        frame; possibly adjusts the radius, steps the degradation ladder,
        or flips the cadence state to TooSlow (vf_HopperRender.c:326-345).

        calc_duration <= 0 means "no valid measurement" (e.g. the previous
        pair built the kernels)."""
        if not self.enabled or calc_duration <= 0.0:
            return
        sft = cadence.source_frame_time
        if calc_duration * self.upper_buffer > sft:
            if self.search_radius > self.min_radius:
                self.search_radius -= 1
                self._over_budget_streak = 0
            elif self.level < self.max_level and \
                    self._rung_ready(self.level + 1):
                self.level += 1
                self._over_budget_streak = 0
            else:
                self._over_budget_streak += 1
                if self._over_budget_streak >= self.too_slow_patience:
                    cadence.mark_too_slow()
                    self._over_budget_streak = 0
        elif calc_duration * self.lower_buffer < sft:
            self._over_budget_streak = 0
            # recovery unwinds in reverse: restore full-geometry quality
            # (the most recent sacrifice) before growing the radius back
            if self.level > 0:
                self.level -= 1
            elif self.search_radius < self.max_radius:
                self.search_radius += 1
        else:
            self._over_budget_streak = 0
