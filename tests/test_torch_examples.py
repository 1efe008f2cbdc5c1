"""The port's examples (``examples/embed.py`` and ``serving_farm.py``) at
64x48 over a few frames against the JAX ``api.Player`` and
``parallel/streams.MultiStreamEngine`` built here with the same
configuration and sources: the same output bytes.

The serving farm runs with auto-quality on, whose radius follows the
measured pair time; both sides' controllers are fed one fixed duration
per measured pair (well inside the budget), so that neither depends on
this machine's load."""

import io
import re

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.api import Player as JaxPlayer
from mpv_frame_interpolator_tpu.io import synthetic as jax_synthetic
from mpv_frame_interpolator_tpu.io.y4m import Y4MWriter as JaxY4MWriter
from mpv_frame_interpolator_tpu.parallel.streams import (
    MultiStreamEngine as JaxMultiStreamEngine)
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu.pipeline import quality as jax_quality
from mpv_frame_interpolator_tpu_torch.examples import embed, serving_farm
from mpv_frame_interpolator_tpu_torch.pipeline import quality as port_quality

torch.set_num_threads(1)

W, H = 64, 48


def test_embed_writes_the_jax_players_bytes(tmp_path):
    out = tmp_path / "embed.y4m"
    n = embed.run(str(out), "cpu", W, H, frames=6)
    player = JaxPlayer(jax_engine.EngineConfig(
        display_fps=60.0, model="hopperq", auto_quality=False,
        initial_search_radius=8, measure_timing=False))
    cfg = jax_synthetic.SyntheticConfig(width=W, height=H, fps=24.0)
    buf = io.BytesIO()
    writer = JaxY4MWriter(buf, W, H, 60.0)
    want = 0
    for frame in player.feed_all(jax_synthetic.moving_box(cfg, 6, vx=4,
                                                          vy=1)):
        writer.write(frame.to_video_frame())
        want += 1
    assert n == want > 6
    assert out.read_bytes() == buf.getvalue()


def _pin_durations(monkeypatch, controller, seconds=1e-3):
    """Feed every `controller` `seconds` for each pair it measured."""
    update = controller.update
    monkeypatch.setattr(controller, "update", lambda self, d, cadence: update(
        self, seconds if d > 0 else d, cadence))


def test_serving_farm_returns_the_jax_farms_frames(monkeypatch, capsys):
    n_streams, n_frames = 3, 6
    _pin_durations(monkeypatch, port_quality.QualityController)
    _pin_durations(monkeypatch, jax_quality.QualityController)
    got = serving_farm.run("cpu", n_streams, n_frames, W, H)
    radii = [int(r) for r in re.findall(r"radius=(\d+)",
                                        capsys.readouterr().out)]

    jax_farm = JaxMultiStreamEngine(jax_engine.EngineConfig(
        display_fps=60.0, auto_quality=True, measure_timing=True,
        initial_search_radius=8), n_streams=n_streams)
    srcs = [list(jax_synthetic.gradient_pan(jax_synthetic.SyntheticConfig(
        width=W, height=H, fps=24.0, seed=k), n_frames, vx=2 + k))
        for k in range(n_streams)]
    want = {k: [] for k in range(n_streams)}
    for step in range(n_frames):
        for sid, frames in jax_farm.push_batch(
                [srcs[k][step] for k in range(n_streams)]).items():
            want[sid].extend(frames)
    for k in range(n_streams):
        assert len(got[k]) == len(want[k]) > n_frames
        for a, b in zip(got[k], want[k]):
            va, vb = a.to_video_frame(), b.to_video_frame()
            assert a.pts == pytest.approx(b.pts)
            np.testing.assert_array_equal(va.y, vb.y)
            np.testing.assert_array_equal(va.uv, vb.uv)
    # the controllers acted: every measured pair raised the radius (the
    # JAX engine measures fewer pairs, none of those that compiled a
    # program, so its radius rises less; the frames do not depend on it)
    assert len(radii) == n_streams and min(radii) > 8
    assert all(e.quality.search_radius > 8 for e in jax_farm.engines)


@pytest.mark.parametrize("example", ["embed", "serving_farm"])
def test_examples_need_the_card(tmp_path, example):
    """Both examples default to the card and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if example == "embed":
            embed.main([str(tmp_path / "e.y4m")])
        else:
            serving_farm.main([])
    assert not (tmp_path / "e.y4m").exists()
