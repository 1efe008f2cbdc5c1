"""The model families of the port (the analogs of ``tests/test_models.py``)
on the CPU, against the JAX package and the NumPy oracle:

* an unknown family is refused (``tests/test_torch_package.py`` holds
  the registry against the original);
* the ``HopperModel`` facade against the oracle (flow and blended warp),
  its batch shapes and its blend-position guard;
* ``blend`` is a zero-flow cross-fade and ``repeat`` outputs the sources,
  neither searching any flow;
* hopperx moves the blend toward the nearer source where the two
  directions disagree and equals hopper where they agree;
* the engine writes the JAX engine's bytes in mode 2 of hopperx,
  hopperq, hopperxq, blend and repeat, NV12 and P010 with levels (16,
  235), and hopperx and hopperq write the same bytes under "fused" and
  "pallas" as under "pair";
* ``EngineConfig(model=...)`` converts from the JAX config for every
  family, and ``--model`` through the port's CLI writes the JAX CLI's
  bytes, as do the CLI flags the port took over with non-default values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu import cli as jax_cli
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops import oracle
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch import cli as port_cli
from mpv_frame_interpolator_tpu_torch import convert
from mpv_frame_interpolator_tpu_torch import models
from mpv_frame_interpolator_tpu_torch.models.hopper import HopperModel
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine

from conftest import frame_pair, planar

torch.set_num_threads(1)


def _eng(**kw):
    kw.setdefault("scene_detection", False)
    kw.setdefault("auto_quality", False)
    kw.setdefault("measure_timing", False)
    return port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", **kw))


def _run(e, frames):
    outs = []
    for f in frames:
        outs.extend(e.push(f))
    return outs


def test_unknown_model_is_refused():
    with pytest.raises(ValueError, match="unknown interpolator model"):
        _eng(model="bogus")


def test_facade_matches_oracle(small_cfg):
    f1, f2 = frame_pair(small_cfg)
    m = HopperModel.for_frame(f1.fmt.height, f1.fmt.width, search_radius=6,
                              device="cpu")
    a = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (*planar(f1), *planar(f2))]
    off, blur = m.analyze(*a)
    off_ref, blur_ref = oracle.calculate_optical_flow(
        f1.y, f1.uv, f2.y, f2.uv, search_radius=6,
        res_scalar=m.geom.res_scalar, lh=m.geom.low_h, lw=m.geom.low_w)
    np.testing.assert_array_equal(off_ref.astype(np.int32), off.numpy())
    np.testing.assert_array_equal(blur_ref.astype(np.int32), blur.numpy())
    y, u, v = m.synthesize(*a, blur, 0.4)
    ry, ruv = oracle.warp_frame(f1.y, f1.uv, f2.y, f2.uv, blur_ref, 0.4,
                                oracle.BLENDED_FRAME, m.geom.res_scalar,
                                m.geom.actual_width)
    np.testing.assert_array_equal(ry, y.numpy())
    np.testing.assert_array_equal(ruv[:, 0::2], u.numpy())
    np.testing.assert_array_equal(ruv[:, 1::2], v.numpy())
    with pytest.raises(ValueError, match="blending scalar"):
        m.synthesize(*a, blur, 1.5)


def test_facade_interpolate_batch(small_cfg):
    f1, f2 = frame_pair(small_cfg)
    m = HopperModel.for_frame(f1.fmt.height, f1.fmt.width, device="cpu",
                              mode=oracle.SIDE_BY_SIDE_2)
    a = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (*planar(f1), *planar(f2))]
    y, u, v = m.interpolate(*a, ts=[0.0, 0.25, 0.5, 0.75])
    assert y.shape == (4, 48, 64) and u.shape == v.shape == (4, 24, 32)
    _, blur = m.analyze(*a)
    y1, u1, _ = m.synthesize(*a, blur, 0.5)
    np.testing.assert_array_equal(y1.numpy(), y[2].numpy())
    np.testing.assert_array_equal(u1.numpy(), u[2].numpy())


def test_blend_is_zero_flow_crossfade(small_cfg):
    frames = list(synthetic.moving_box(small_cfg, 3))
    before = KS.counts.plain
    e = _eng(model="blend")
    outs = _run(e, frames)
    assert KS.counts.plain == before          # no flow search at all
    geom = e.geom
    zero = np.zeros((2, geom.low_h, geom.low_w), np.int16)
    ry, ruv = oracle.warp_frame(frames[0].y, frames[0].uv, frames[1].y,
                                frames[1].uv, zero, 0.4,
                                oracle.BLENDED_FRAME, geom.res_scalar,
                                geom.actual_width)
    got = outs[2].to_video_frame()   # second output of pair 1: t = 0.4
    np.testing.assert_array_equal(ry, got.y)
    np.testing.assert_array_equal(ruv, got.uv)


def test_repeat_outputs_source_frames(small_cfg):
    """Every position snaps to a source: t = 0.4 gives frame 1 and t = 0.8
    frame 2, through the warp's zero-flow sample (whose mirror_edge2 maps
    the outermost row and column inward) and the levels."""
    frames = list(synthetic.moving_box(small_cfg, 3))
    e = _eng(model="repeat")
    outs = _run(e, frames)
    geom = e.geom
    zero = np.zeros((2, geom.low_h, geom.low_w), np.int16)
    for out, t in ((outs[2], 0.0), (outs[3], 1.0)):
        ry, ruv = oracle.warp_frame(frames[0].y, frames[0].uv, frames[1].y,
                                    frames[1].uv, zero, t,
                                    oracle.BLENDED_FRAME, geom.res_scalar,
                                    geom.actual_width)
        got = out.to_video_frame()
        np.testing.assert_array_equal(ry, got.y)
        np.testing.assert_array_equal(ruv, got.uv)
        src = frames[0] if t == 0.0 else frames[1]
        np.testing.assert_array_equal(got.y[1:-1, 1:-1], src.y[1:-1, 1:-1])


def test_hopperx_snaps_at_high_disagreement():
    """moving_box's box edges are occluded at the t = 0.5 midpoints: there
    hopperx differs from hopper."""
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    src = list(synthetic.moving_box(cfg, 4, vx=4, vy=0))
    outs = [_run(_eng(model=m, display_fps=48.0, initial_search_radius=8),
                 src) for m in ("hopper", "hopperx")]
    differ = sum(not np.array_equal(a.to_video_frame().y,
                                    b.to_video_frame().y)
                 for a, b in zip(*outs))
    assert differ >= 1


def test_hopperx_identical_when_samples_agree(small_cfg):
    still = next(iter(synthetic.moving_box(small_cfg, 1)))
    frames = []
    for i in range(4):
        f = still.with_pts(i / 24.0)
        f.nominal_fps = 24.0
        frames.append(f)
    a = _run(_eng(model="hopper", initial_search_radius=8), frames)
    b = _run(_eng(model="hopperx", initial_search_radius=8), frames)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.to_video_frame().y,
                                      y.to_video_frame().y)


_TV = (16.0, 235.0)
_DL = (0.0, 255.0)


@pytest.mark.parametrize("model,sampling,pixfmt,levels", [
    ("hopperx", "pair", "nv12", _DL), ("hopperx", "pallas", "p010", _TV),
    ("hopperq", "pair", "nv12", _DL), ("hopperxq", "pair", "p010", _TV),
    ("blend", "pair", "p010", _TV), ("repeat", "pair", "nv12", _DL)])
def test_engine_equals_jax(small_cfg, model, sampling, pixfmt, levels):
    """Mode 2 of every family the port added, NV12 and P010 with levels
    (16, 235): the JAX engine's bytes and pts on a moving box, a scene
    cut (which zeroes the flow and snaps the positions) and a smooth pan
    after it.  The arithmetic of each family's warp is held against the
    JAX package's functions in test_torch_bilinear.py and
    test_torch_blend_levels.py; this pins the engine's dispatch."""
    cfg = dataclasses.replace(small_cfg, pixfmt=pixfmt)
    kw = dict(auto_quality=False, measure_timing=False, display_fps=60.0,
              scene_detection=True, initial_search_radius=8, model=model,
              warp_sampling=sampling, black_level=levels[0],
              white_level=levels[1])
    ref = jax_engine.InterpolationEngine(jax_engine.EngineConfig(
        background_precompile=False, **kw))
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", **kw))
    n = 0
    for f in synthetic.scene_cut(cfg, 5, cut_at=3):
        r_outs, p_outs = ref.push(f), port.push(f)
        assert len(p_outs) == len(r_outs)
        for r, p in zip(r_outs, p_outs):
            assert p.pts == r.pts
            rf, pf = r.to_video_frame(), p.to_video_frame()
            np.testing.assert_array_equal(pf.y, rf.y)
            np.testing.assert_array_equal(pf.uv, rf.uv)
            n += 1
    assert n == 1 + 3 + 2 + 3 + 2


@pytest.mark.parametrize("model,pixfmt,levels", [("hopperx", "nv12", _DL),
                                                 ("hopperq", "p010", _TV)])
def test_samplers_do_not_change_these_families(small_cfg, model, pixfmt,
                                               levels):
    """hopperx and the bilinear families leave the nearest samplers' pair
    and fused kernels (as the JAX engine does, engine.py:563-585): under
    "fused" and "pallas" they write what they write under "pair", which
    test_engine_equals_jax holds against the JAX engine."""
    cfg = dataclasses.replace(small_cfg, pixfmt=pixfmt)
    outs = [_run(_eng(model=model, warp_sampling=ws, scene_detection=True,
                      initial_search_radius=8, black_level=levels[0],
                      white_level=levels[1]),
                 synthetic.scene_cut(cfg, 5, cut_at=3))
            for ws in ("pair", "fused", "pallas")]
    assert len(outs[0]) == 11
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            fa, fb = a.to_video_frame(), b.to_video_frame()
            assert a.pts == b.pts
            np.testing.assert_array_equal(fa.y, fb.y)
            np.testing.assert_array_equal(fa.uv, fb.uv)


def test_hopperxq_differs_from_its_parents(small_cfg):
    frames = list(synthetic.gradient_pan(small_cfg, 3, vx=3, vy=1))
    ys = {m: _run(_eng(model=m), frames)[2].to_video_frame().y
          for m in ("hopper", "hopperx", "hopperxq")}
    assert not np.array_equal(ys["hopperxq"], ys["hopperx"])
    assert not np.array_equal(ys["hopperxq"], ys["hopper"])


@pytest.mark.parametrize("model", models.MODELS)
def test_engine_config_converts_every_model(model):
    mapping = dataclasses.asdict(jax_engine.EngineConfig(model=model))
    pcfg = convert.engine_config_from_jax(mapping, device="cpu")
    assert pcfg.model == model


@pytest.mark.parametrize("extra", [
    ["--model", "hopperxq"], ["--model", "repeat", "--p010"],
    ["--scene-threshold", "5", "--delta-scalar", "6",
     "--neighbor-bias-scalar", "3", "--max-calc-res", "64",
     "--num-iterations", "2", "--speed", "1.25", "--no-present",
     "--display-fps", "72"]])
def test_cli_y4m_bytes(tmp_path, extra):
    argv = ["synthetic:scene_cut", "--width", "64", "--height", "48",
            "--frames", "5", "--untimed", "--no-auto-quality", *extra]
    jax_out, port_out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli.main(argv + ["-o", str(jax_out)]) == 0
    assert port_cli.main(argv + ["--device", "cpu", "-o",
                                 str(port_out)]) == 0
    data = port_out.read_bytes()
    assert data.count(b"FRAME\n") > 5
    assert data == jax_out.read_bytes()
