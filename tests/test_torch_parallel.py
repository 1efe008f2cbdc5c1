"""The port's pair pool and multi-stream engine on the CPU: the analogs of
the JAX package's tests/test_parallel.py (TestPairParallel, TestMultiStream)
and tests/test_multistream_quality.py.  Every output is bit-exact against
single port engines, and one clip of each against the JAX engine."""

import dataclasses as dc

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.io import synthetic as jax_synthetic
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.parallel.batch import PairParallelPool
from mpv_frame_interpolator_tpu_torch.parallel.streams import (
    MultiStreamEngine)
from mpv_frame_interpolator_tpu_torch.pipeline.cadence import (
    InterpolationState)
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)

from _stream_timing import OVERLOAD, pin_healthy

torch.set_num_threads(1)

KW = dict(scene_detection=False, auto_quality=False, measure_timing=False,
          initial_search_radius=5)
SMALL = synthetic.SyntheticConfig(width=64, height=48, fps=24.0)


def cfg(**kw):
    return EngineConfig(device="cpu", **kw)


def sources(n_streams, n_frames, fps=None, source="gradient_pan"):
    cfgs = [dc.replace(SMALL, seed=SMALL.seed + k,
                       **({"fps": fps} if fps else {}))
            for k in range(n_streams)]
    return [list(getattr(synthetic, source)(c, n_frames)) for c in cfgs]


def same(a, b):
    assert a.pts == pytest.approx(b.pts)
    va, vb = a.to_video_frame(), b.to_video_frame()
    np.testing.assert_array_equal(va.y, vb.y)
    np.testing.assert_array_equal(va.uv, vb.uv)


def singles(config, srcs, n_frames):
    engines = [InterpolationEngine(config) for _ in srcs]
    outs = [[] for _ in srcs]
    for step in range(n_frames):
        for k, (e, s) in enumerate(zip(engines, srcs)):
            outs[k].extend(e.push(s[step]))
    return outs


def jax_outputs(n_frames, seed=SMALL.seed, source="gradient_pan", **kw):
    """One clip through the JAX engine (the same clip as the port's)."""
    eng = jax_engine.InterpolationEngine(jax_engine.EngineConfig(
        background_precompile=False, **kw))
    jcfg = jax_synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                         seed=seed)
    out = []
    for f in getattr(jax_synthetic, source)(jcfg, n_frames):
        out.extend(eng.push(f))
    return out


class TestPairParallel:
    def test_outputs_match_single_engine_and_jax(self):
        frames = list(synthetic.moving_box(SMALL, 5))
        expect = singles(cfg(**KW), [frames], 5)[0]
        pool = PairParallelPool(cfg(**KW), devices=("cpu", "cpu"))
        got = list(pool.run(frames))
        assert len(got) == len(expect)
        for a, b in zip(expect, got):
            same(a, b)
        ref = jax_outputs(5, source="moving_box", **KW)
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            same(a, b)

    def test_uses_every_slot(self):
        pool = PairParallelPool(cfg(**KW), devices=("cpu", "cpu"))
        list(pool.run(synthetic.moving_box(SMALL, 4)))
        assert pool.pairs_per_slot() == [2, 1]

    def test_default_devices(self):
        assert PairParallelPool(cfg(**KW)).devices == [torch.device("cpu")]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                PairParallelPool(EngineConfig(**KW))


class TestMultiStream:
    def test_sequential_matches_single_and_jax(self):
        srcs = sources(3, 4)
        expect = singles(cfg(**KW), srcs, 4)
        ms = MultiStreamEngine(cfg(**KW), n_streams=3)
        got = [[] for _ in range(3)]
        for step in range(4):
            for k, frames in ms.push_batch([s[step] for s in srcs]).items():
                got[k].extend(frames)
        for k in range(3):
            assert len(expect[k]) == len(got[k])
            for a, b in zip(expect[k], got[k]):
                same(a, b)
        ref = jax_outputs(4, **KW)
        assert len(ref) == len(got[0])
        for a, b in zip(ref, got[0]):
            same(a, b)

    def test_idle_stream_and_mixed_cadence(self):
        for batch in (False, True):
            ms = MultiStreamEngine(cfg(scene_detection=False,
                                       auto_quality=False,
                                       measure_timing=False), n_streams=2,
                                   batch_dispatch=batch)
            frames = list(synthetic.moving_box(SMALL, 3))
            outs0 = ms.push_batch([frames[0], None])
            assert 0 in outs0 and 1 not in outs0
            outs1 = ms.push_batch([frames[1], frames[0]])
            assert len(outs1[0]) == 3      # stream 0 interpolating
            assert len(outs1[1]) == 1      # stream 1 anchor passthrough

    def test_geometry_mismatch_rejected(self):
        ms = MultiStreamEngine(cfg(scene_detection=False,
                                   auto_quality=False, measure_timing=False),
                               n_streams=2)
        big = synthetic.SyntheticConfig(width=128, height=96)
        f_small = next(iter(synthetic.moving_box(SMALL, 1)))
        f_big = next(iter(synthetic.moving_box(big, 1)))
        with pytest.raises(ValueError, match="share one geometry"):
            ms.push_batch([f_small, f_big])

    @pytest.mark.parametrize("scene", [False, True])
    def test_batched_dispatch_matches_sequential(self, scene):
        kw = dict(KW, scene_detection=scene)
        srcs = sources(2, 3) if not scene else [
            list(synthetic.scene_cut(SMALL, 4, cut_at=2)),
            sources(1, 4)[0]]
        a = MultiStreamEngine(cfg(**kw), n_streams=2)
        b = MultiStreamEngine(cfg(**kw), n_streams=2, batch_dispatch=True)
        for step in range(len(srcs[0])):
            ra = a.push_batch([s[step] for s in srcs])
            rb = b.push_batch([s[step] for s in srcs])
            assert set(ra) == set(rb)
            for sid in ra:
                assert len(ra[sid]) == len(rb[sid])
                for x, y in zip(ra[sid], rb[sid]):
                    same(x, y)
        if scene:
            cuts = [e.scene_cuts() for e in b.engines]
            assert cuts == [e.scene_cuts() for e in a.engines]
            assert cuts[0] >= 1


class TestMultiStreamQuality:
    def test_per_stream_quality_controllers(self):
        ms = MultiStreamEngine(cfg(
            scene_detection=False, auto_quality=True, measure_timing=True,
            initial_search_radius=8), n_streams=3)
        assert len({id(e.quality) for e in ms.engines}) == 3
        assert len({id(e.stats) for e in ms.engines}) == 3
        assert len({id(e.scene) for e in ms.engines}) == 3
        assert ms.qualities[2] is ms.engines[2].quality
        assert ms.cadences[1] is ms.engines[1].cadence

    def test_one_stream_degrades_alone(self):
        """An over-budget measurement in stream 1 only: its radius drops
        while stream 0's stays (8 fps: a generous budget a pair)."""
        ms = MultiStreamEngine(cfg(
            scene_detection=False, auto_quality=True, measure_timing=True,
            initial_search_radius=8, too_slow_patience=1000), n_streams=2)
        srcs = sources(2, 6, fps=8.0)
        for step in range(3):
            pin_healthy(ms.engines[0])
            ms.push_batch([srcs[0][step], srcs[1][step]])
        r0 = ms.engines[0].quality.search_radius
        r1 = ms.engines[1].quality.search_radius
        for step in range(3, 6):
            pin_healthy(ms.engines[0])
            ms.engines[1]._last_calc_duration = OVERLOAD
            ms.push_batch([srcs[0][step], srcs[1][step]])
        assert ms.engines[1].quality.search_radius <= max(r1 - 3, 5)
        assert ms.engines[0].quality.search_radius >= r0
        assert ms.engines[0].cadence.state == InterpolationState.ACTIVE

    def test_too_slow_isolated(self):
        ms = MultiStreamEngine(cfg(
            scene_detection=False, auto_quality=True, measure_timing=True,
            initial_search_radius=5, too_slow_patience=1,
            degrade_rungs=()), n_streams=2)
        srcs = sources(2, 10, fps=8.0)
        for step in range(2):
            pin_healthy(ms.engines[0])
            ms.push_batch([srcs[0][step], srcs[1][step]])
        for step in range(2, 9):
            pin_healthy(ms.engines[0])
            ms.engines[1]._last_calc_duration = OVERLOAD   # persistent overload
            outs = ms.push_batch([srcs[0][step], srcs[1][step]])
        assert ms.engines[1].cadence.state == InterpolationState.TOO_SLOW
        assert ms.engines[0].cadence.state == InterpolationState.ACTIVE
        assert len(outs[1]) == 1
        assert len(outs[0]) >= 2

    def test_per_stream_stats_and_scene(self):
        ms = MultiStreamEngine(cfg(
            scene_detection=True, auto_quality=False, measure_timing=True),
            n_streams=2)
        srcs = sources(2, 4)
        for step in range(4):
            ms.push_batch([srcs[0][step], srcs[1][step]])
        for e in ms.engines:
            assert e.stats.last("source_frame_time") > 0
        assert ms.stats(0) is not ms.stats(1)

    def test_batched_radius_vector(self):
        """batch_dispatch carries each stream's radius: streams at
        different radii (and layer buckets) give their own outputs."""
        srcs = sources(2, 3)
        ms = MultiStreamEngine(cfg(**KW), n_streams=2, batch_dispatch=True)
        ms.engines[1].quality.search_radius = 11
        got = [[] for _ in range(2)]
        for step in range(3):
            for k, fr in ms.push_batch([srcs[0][step],
                                        srcs[1][step]]).items():
                got[k].extend(fr)
        for k, radius in ((0, 5), (1, 11)):
            expect = singles(cfg(**dict(KW, initial_search_radius=radius)),
                             [srcs[k]], 3)[0]
            assert len(expect) == len(got[k])
            for a, b in zip(expect, got[k]):
                same(a, b)

    def test_batched_timing_feeds_every_controller(self):
        """One shared duration a step: none from the first step of a
        spec (mode, output count, model), then every stream's controller
        and stats read the same (24 -> 48 fps: two outputs every pair)."""
        ms = MultiStreamEngine(cfg(
            scene_detection=True, auto_quality=True, measure_timing=True,
            initial_search_radius=8, display_fps=48.0), n_streams=2,
            batch_dispatch=True)
        srcs = sources(2, 4)
        ms.push_batch([srcs[0][0], srcs[1][0]])     # passthrough anchors
        ms.push_batch([srcs[0][1], srcs[1][1]])     # first batch: warm-up
        assert ms._last_batch_dur == 0.0
        assert all(e.stats.count("source_frame_time") == 0
                   for e in ms.engines)
        ms.push_batch([srcs[0][2], srcs[1][2]])
        dur = ms._last_batch_dur
        assert dur > 0
        assert [e.stats.last("source_frame_time") for e in ms.engines] == \
            [dur, dur]
        assert all(e.scene.last_score > 0 for e in ms.engines)
