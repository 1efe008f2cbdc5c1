"""Grouped dispatch of the port (``InterpolationEngine.push_many``) on the
CPU: the same outputs as ``push`` -- the same pts, bit-identical planes --
over the same static slots, padding and indexing the card's CUDA graphs
replay (the analogs of the JAX package's ``tests/test_push_many.py``),
every model family and output mode 0-6, the grouped ``Pipeline``, and
the port's grouped pipeline against the JAX package's, byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.io import synthetic as jax_synthetic
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu.pipeline import player as jax_player
from mpv_frame_interpolator_tpu_torch import cli as port_cli
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator_tpu_torch.pipeline.player import Pipeline

torch.set_num_threads(1)


def _build(display_fps, **kw):
    kw.setdefault("measure_timing", False)
    kw.setdefault("initial_search_radius", 5)
    return InterpolationEngine(EngineConfig(
        display_fps=display_fps, auto_quality=False, device="cpu", **kw))


def _materialize(outs):
    return [(o.pts, o.to_video_frame().y, o.to_video_frame().uv)
            for o in outs]


def _same(ref, got):
    assert len(got) == len(ref) and ref
    for (p1, y1, uv1), (p2, y2, uv2) in zip(_materialize(ref),
                                            _materialize(got)):
        assert p1 == p2
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(uv1, uv2)


@pytest.mark.parametrize("display_fps,group", [(60.0, 4), (120.0, 3)])
def test_push_many_matches_push(display_fps, group):
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 11))
    e1, e2 = _build(display_fps), _build(display_fps)
    ref = [o for f in frames for o in e1.push(f)]
    got = e2.push_many(frames, group_size=group)
    _same(ref, got)
    # 10 pairs in groups of at most `group`, chunked to 8/4/2/1: 4 4 2,
    # or 2 1 2 1 2 1 1
    assert e2.group_stats["pairs"] == 10
    assert e2.group_stats["groups"] == (3 if group == 4 else 7)


def test_push_many_scene_cut_matches():
    """A hard cut inside a group folds as in push (the pair body is
    shared); the cut count adds up in place over the group."""
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 8))
    frames = [dataclasses.replace(f, y=(255 - f.y) if i >= 4 else f.y)
              for i, f in enumerate(frames)]
    e1, e2 = _build(60.0), _build(60.0)
    ref = [o for f in frames for o in e1.push(f)]
    got = e2.push_many(frames, group_size=8)
    _same(ref, got)
    assert e1.scene_cuts() == e2.scene_cuts() == 1
    assert e2.last_cut_score() == e1.last_cut_score()


def test_push_many_incremental_calls():
    """The same stream over several push_many calls (partial groups at
    each boundary) still matches."""
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 10))
    e1, e2 = _build(60.0), _build(60.0)
    ref = [o for f in frames for o in e1.push(f)]
    got = []
    got += e2.push_many(frames[:3], group_size=4)
    got += e2.push_many(frames[3:7], group_size=4)
    got += e2.push_many(frames[7:], group_size=4)
    _same(ref, got)


@pytest.mark.parametrize("model,mode,pixfmt", [
    *[(m, 2, "nv12") for m in ("hopper", "hopperx", "hopperq", "hopperxq",
                                "blend", "repeat")],
    *[("hopper", m, "nv12") for m in (0, 1, 3, 4, 5, 6)],
    ("hopperxq", 6, "p010"), ("hopperx", 3, "p010")])
def test_push_many_every_family_and_mode(model, mode, pixfmt):
    """Every model family and output mode, with a cut in the second
    group and 24 -> 60's mixed output counts (padded to the group's
    largest): the grouped outputs equal push's."""
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                    pixfmt=pixfmt)
    frames = list(synthetic.scene_cut(cfg, 8, cut_at=5))
    kw = dict(model=model, frame_output_mode=mode, black_level=16.0,
              white_level=235.0, initial_search_radius=8)
    e1, e2 = _build(60.0, **kw), _build(60.0, **kw)
    ref = [o for f in frames for o in e1.push(f)]
    got = e2.push_many(frames, group_size=4)
    _same(ref, got)
    assert e1.scene_cuts() == e2.scene_cuts()


class _CollectSink:
    def __init__(self):
        self.frames = []

    def write(self, out):
        f = out.to_video_frame()
        self.frames.append((out.pts, np.array(f.y), np.array(f.uv)))

    def close(self):
        pass


def _same_frames(a, b):
    assert len(a) == len(b) and a
    for (p1, y1, uv1), (p2, y2, uv2) in zip(a, b):
        assert abs(p1 - p2) < 1e-9
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(uv1, uv2)


def test_pipeline_group_matches_ungrouped():
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 9))
    s1, s2 = _CollectSink(), _CollectSink()
    Pipeline(iter(frames), _build(60.0), s1, present=None,
             stage_uploads=False).run()
    pipe = Pipeline(iter(frames), _build(60.0), s2, present=None,
                    group=4)
    pipe.run()
    _same_frames(s1.frames, s2.frames)
    assert pipe.engine_failures() == 0


def test_pipeline_group_matches_the_jax_pipeline():
    """The port's Pipeline(group=4) writes the JAX Pipeline(group=4)'s
    frames, pts and bytes."""
    cfg = jax_synthetic.SyntheticConfig(width=64, height=48, fps=24.0)
    frames = list(jax_synthetic.moving_box(cfg, 9))
    ref, port = _CollectSink(), _CollectSink()
    jax_player.Pipeline(iter(frames), jax_engine.InterpolationEngine(
        jax_engine.EngineConfig(display_fps=60.0, auto_quality=False,
                                initial_search_radius=5,
                                measure_timing=False,
                                background_precompile=False)),
        ref, present=None, stage_uploads=False, group=4).run()
    port_frames = list(synthetic.moving_box(
        synthetic.SyntheticConfig(width=64, height=48, fps=24.0), 9))
    Pipeline(iter(port_frames), _build(60.0), port, present=None,
             group=4).run()
    _same_frames(ref.frames, port.frames)


def test_cli_group_requires_an_output():
    with pytest.raises(SystemExit):
        port_cli.main(["synthetic:moving_box", "--frames", "3", "--group",
                       "4", "--width", "64", "--height", "48", "--untimed",
                       "--device", "cpu"])


def test_push_many_timing_feeds_the_controller():
    """A timed group's duration, divided by its pairs, lands in the stats
    the controller reads -- from the second group of a key on (the first
    is a warm-up, as a geometry's first pair is under push)."""
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 10))
    e = _build(60.0, measure_timing=True)
    outs = e.push_many(frames, group_size=4)
    assert outs
    summary = e.stats.summary()
    # groups of 4, 4, 1 pairs: the second group of 4 is timed
    assert summary["source_frame_time"]["count"] == 1
    assert summary["source_frame_time"]["last"] > 0.0
    assert summary["outputs"]["count"] == 3
