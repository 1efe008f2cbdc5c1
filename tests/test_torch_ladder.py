"""The auto-quality path's ladder and split timing on the port (the
analogs of ``tests/test_degrade_rungs.py`` and
``tests/test_split_timing.py``), on the CPU:

* the controller steps the ladder once the radius is at its floor, only
  onto a warm rung, then flips TooSlow; recovery unwinds the level before
  it grows the radius;
* an engine on rung k equals the JAX engine on rung k (levels 1-3 of the
  default ladder, the last the blend family), an engine statically
  configured with the rung's geometry (also at 96 x 544, where the rungs
  run res scalars 3 and 4 where level 0 runs 2), and on the blend rung a
  blend-configured engine, which searches no flow;
* over-budget durations walk the engine down the ladder and better ones
  back up, with playback ACTIVE; rung validation;
* split timing: the same outputs under "off", "auto" and "always";
  ``flow_time``, ``warp_total`` and ``warp_time`` published every timed
  pair under "always", under "auto" only once ``request_split_timing``
  was called, never under "off"; flow + warp is the pair's time.

Bit-exact throughout (tolerance 0).
"""

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch.ops import flow as TF
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine
from mpv_frame_interpolator_tpu_torch.pipeline.cadence import CadenceEngine
from mpv_frame_interpolator_tpu_torch.pipeline.quality import (
    QualityController)

torch.set_num_threads(1)


def _cad():
    c = CadenceEngine(60.0)
    c.on_source_frame(0.0, 24.0)
    return c


class TestControllerLadder:
    def test_steps_ladder_after_radius_floor_then_too_slow(self):
        c = _cad()
        q = QualityController(search_radius=6, too_slow_patience=2,
                              max_level=2)
        slow = c.source_frame_time
        q.update(slow, c)
        assert (q.search_radius, q.level) == (5, 0)
        q.update(slow, c)
        assert (q.search_radius, q.level) == (5, 1)
        q.update(slow, c)
        assert (q.search_radius, q.level) == (5, 2)
        q.update(slow, c)               # ladder exhausted: streak 1
        assert c.state.name == "ACTIVE"
        q.update(slow, c)               # streak 2 -> TooSlow
        assert c.state.name == "TOO_SLOW"

    def test_cold_rung_is_not_entered(self):
        c = _cad()
        q = QualityController(search_radius=5, too_slow_patience=99,
                              max_level=2)
        warm = {0, 2}
        q.rung_warm = lambda lvl: lvl in warm
        slow = c.source_frame_time
        q.update(slow, c)
        assert q.level == 0             # rung 1 cold: no step, streak
        warm.add(1)
        q.update(slow, c)
        assert q.level == 1

    def test_recovery_unwinds_level_before_radius(self):
        c = _cad()
        q = QualityController(search_radius=5, max_level=2)
        q.level = 2
        fast = c.source_frame_time / 10
        q.update(fast, c)
        assert (q.search_radius, q.level) == (5, 1)
        q.update(fast, c)
        assert (q.search_radius, q.level) == (5, 0)
        q.update(fast, c)
        assert (q.search_radius, q.level) == (6, 0)


def _frames(n=10, w=96, h=64):
    cfg = synthetic.SyntheticConfig(width=w, height=h, fps=24.0)
    return list(synthetic.moving_box(cfg, n))


def _port(**kw):
    kw.setdefault("measure_timing", False)
    return port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", display_fps=60.0, **kw))


def _outputs(engine, frames):
    return [(o.pts, o.to_video_frame()) for f in frames
            for o in engine.push(f)]


def _assert_same(got, ref):
    assert len(got) == len(ref) > 0
    for (pa, a), (pb, b) in zip(got, ref):
        assert pa == pb
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.uv, b.uv)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_rung_outputs_equal_the_jax_engine(level):
    """Each level of the default ladder ((2, 2), (3, 4), (3, 4, blend)):
    the port's engine on that rung writes the JAX engine's bytes."""
    frames = _frames(5)
    kw = dict(display_fps=48.0, auto_quality=True, initial_search_radius=5,
              measure_timing=False, scene_detection=True)
    ref = jax_engine.InterpolationEngine(jax_engine.EngineConfig(
        background_precompile=False, **kw))
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", **kw))
    ref.quality.level = port.quality.level = level
    _assert_same(_outputs(port, frames), _outputs(ref, frames))


@pytest.mark.parametrize("w,h,rung,rs", [(96, 64, (1, 2), (0, 0)),
                                         (96, 544, (2, 2), (2, 3)),
                                         (96, 544, (3, 4), (2, 4))])
def test_rung_outputs_match_static_config(w, h, rung, rs):
    """An engine degraded to a rung produces bit-identical outputs to an
    engine statically configured with that rung's geometry (at 96 x 544
    the rung's calc resolution moves the res scalar from 2 to 3 or 4)."""
    frames = _frames(6, w, h)
    base = TF.FlowGeometry.create(h, w, w)
    e_dyn = _port(auto_quality=True, initial_search_radius=5,
                  degrade_rungs=(rung,))
    e_dyn.quality.level = 1
    e_static = _port(auto_quality=False, initial_search_radius=5,
                     num_iterations=max(base.iterations - rung[0], 1),
                     max_calc_res=max(270 // rung[1], 64))
    got = _outputs(e_dyn, frames)
    ref = _outputs(e_static, frames)
    assert (e_dyn.geom.res_scalar, e_dyn._geoms[1].res_scalar) == rs
    assert e_dyn._geoms[1] == e_static.geom
    _assert_same(got, ref)


def test_blend_rung_matches_blend_model():
    """The last-resort rung switches the family: on the blend rung the
    engine produces what a blend-configured engine produces, and launches
    no flow search."""
    frames = _frames()
    e_dyn = _port(auto_quality=True, initial_search_radius=5,
                  degrade_rungs=((2, 2), (2, 2, "blend")))
    e_dyn.quality.level = 2
    e_blend = _port(auto_quality=False, initial_search_radius=5,
                    model="blend")
    before = KS.counts.plain
    got = _outputs(e_dyn, frames)
    assert KS.counts.plain == before
    _assert_same(got, _outputs(e_blend, frames))


def test_over_budget_engine_steps_down_and_recovers():
    """Over-budget durations walk the radius to the floor, then the ladder
    down, with playback ACTIVE while rungs remain; better durations
    unwind the ladder and then grow the radius."""
    e = _port(auto_quality=True, initial_search_radius=6,
              too_slow_patience=3, degrade_rungs=((1, 1), (2, 2)))
    levels = []
    for f in _frames(6):
        e.push(f)
        levels.append((e.quality.search_radius, e.quality.level))
        e._last_calc_duration = e.cadence.source_frame_time
    assert (e.quality.search_radius, e.quality.level) == (5, 2)
    assert levels[:4] == [(6, 0), (5, 0), (5, 1), (5, 2)]
    assert e.cadence.state.name == "ACTIVE"
    for f in _frames(12)[6:]:
        e._last_calc_duration = e.cadence.source_frame_time / 100
        e.push(f)
    assert e.quality.level == 0 and e.quality.search_radius == 9


def test_default_ladder_and_rung_validation():
    rungs = port_engine.EngineConfig(device="cpu").degrade_rungs
    assert rungs == ((2, 2, None), (3, 4, None), (3, 4, "blend"))
    assert _port().quality.max_level == 3
    for bad in (((-1, 1),), ((1, 0),), ((1, 1, "nope"),)):
        with pytest.raises(ValueError):
            port_engine.EngineConfig(device="cpu", degrade_rungs=bad)
    with pytest.raises(ValueError):
        port_engine.EngineConfig(device="cpu", layer_buckets=(1, 8))
    with pytest.raises(ValueError):
        port_engine.EngineConfig(device="cpu", split_timing="sometimes")


_SPLIT_KEYS = ("flow_time", "warp_total", "warp_time")


def _timed(mode, requested=False, subpel=False):
    e = _port(measure_timing=True, auto_quality=False, split_timing=mode,
              scene_detection=False, subpel_flow=subpel, model="hopperq")
    if requested:
        e.request_split_timing()
    return e


@pytest.mark.parametrize("mode,requested,published", [
    ("off", False, False), ("off", True, False), ("auto", False, False),
    ("auto", True, True), ("always", False, True)])
def test_split_timing_stats(mode, requested, published):
    """The same outputs under every mode; the split's keys are published
    as the mode says, and on the CPU flow + warp is the pair's time."""
    frames = _frames(5)
    e = _timed(mode, requested, subpel=True)
    got = _outputs(e, frames)
    _assert_same(got, _outputs(_port(scene_detection=False, subpel_flow=True,
                                     model="hopperq"), frames))
    summary = e.stats.summary()
    pairs = summary["source_frame_time"]["count"]
    assert pairs == 3               # the first pair builds: untimed
    for key in _SPLIT_KEYS:
        assert (key in summary) == published, key
    if published:
        last = {k: v["last"] for k, v in summary.items()}
        assert all(summary[k]["count"] == pairs for k in _SPLIT_KEYS)
        assert last["flow_time"] > 0 and last["warp_total"] > 0
        assert last["source_frame_time"] == pytest.approx(
            last["flow_time"] + last["warp_total"], rel=1e-6)
        assert last["warp_time"] == pytest.approx(
            last["warp_total"] / last["outputs"], rel=1e-6)
