"""The port's slice as a whole on the CPU against the JAX package: the
engine's frames and pts on synthetic clips (with and without a scene cut),
the engine's speed and seek commands, and the CLI's y4m bytes.  Bit-exact;
the only tolerance is the scene-cut score (one ulp: the JAX package sums
in float32 in XLA's order), with the cut decision exact."""

import dataclasses

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu import cli as jax_cli
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch import cli as port_cli
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine

torch.set_num_threads(1)


def _engines(**kw):
    kw.setdefault("auto_quality", False)
    kw.setdefault("measure_timing", False)
    ref = jax_engine.InterpolationEngine(jax_engine.EngineConfig(
        background_precompile=False, **kw))
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", **kw))
    return ref, port


def _same_outputs(ref_outs, port_outs):
    assert len(port_outs) == len(ref_outs)
    for r, p in zip(ref_outs, port_outs):
        assert p.pts == r.pts
        rf, pf = r.to_video_frame(), p.to_video_frame()
        # each package has its own FrameFormat class: compare the fields
        assert dataclasses.asdict(pf.fmt) == dataclasses.asdict(rf.fmt)
        np.testing.assert_array_equal(pf.y, rf.y)
        np.testing.assert_array_equal(pf.uv, rf.uv)


def _same_cut(ref, port, threshold):
    a = np.float32(ref.last_cut_score())
    b = np.float32(port.last_cut_score())
    assert abs(a - b) <= np.spacing(max(abs(a), abs(b))), (a, b)
    assert (a > np.float32(threshold)) == (b > np.float32(threshold))


def _drive(ref, port, frames, check_cut=False):
    """Push the frames through both engines; returns (outputs, cuts the
    JAX engine folded in)."""
    n = cuts = 0
    for f in frames:
        r_outs, p_outs = ref.push(f), port.push(f)
        _same_outputs(r_outs, p_outs)
        n += len(p_outs)
        if check_cut and r_outs and r_outs[0]._index is not None:
            _same_cut(ref, port, ref.scene.threshold)
            cuts += ref.last_cut_score() > np.float32(ref.scene.threshold)
    return n, cuts


def test_moving_box_24_to_60(small_cfg):
    ref, port = _engines(display_fps=60.0, scene_detection=False)
    n, _ = _drive(ref, port, synthetic.moving_box(small_cfg, 6))
    assert n == 1 + 3 + 2 + 3 + 2 + 3


def test_scene_cut_clip(small_cfg):
    ref, port = _engines(display_fps=60.0, scene_detection=True,
                         initial_search_radius=16)
    _, cuts = _drive(ref, port, synthetic.scene_cut(small_cfg, 8, cut_at=5),
                     check_cut=True)
    assert cuts >= 1
    assert port.scene_cuts() == cuts


def test_jax_engine_on_its_pallas_pair_kernel(monkeypatch):
    """The JAX engine with its warp on the Pallas pair kernel (interpret
    mode; read when the step is traced, so the clip has a geometry no
    other test compiles)."""
    from mpv_frame_interpolator_tpu.ops.pallas import warp_pair
    traced = []
    kernel = warp_pair.blended_pair_from_prep
    monkeypatch.setattr(warp_pair, "blended_pair_from_prep",
                        lambda *a, **k: traced.append(1) or kernel(*a, **k))
    monkeypatch.setenv("MFI_PAIR_INTERPRET", "1")
    cfg = synthetic.SyntheticConfig(width=80, height=56, fps=24.0)
    ref, port = _engines(display_fps=60.0, scene_detection=True)
    n, _ = _drive(ref, port, synthetic.moving_box(cfg, 4), check_cut=True)
    assert n == 1 + 3 + 2 + 3
    assert traced, "the JAX engine did not put the Pallas kernel in its step"


def test_speed_and_seek_commands(small_cfg):
    ref, port = _engines(display_fps=60.0, scene_detection=True)
    frames = list(synthetic.moving_box(small_cfg, 9))
    _drive(ref, port, frames[:4])
    for e in (ref, port):
        e.set_speed(1.5)
    _drive(ref, port, frames[4:7])
    for e in (ref, port):
        e.reset()
    _drive(ref, port, frames[7:])


def test_cli_y4m_bytes(tmp_path):
    argv = ["synthetic:moving_box", "--width", "64", "--height", "48",
            "--frames", "6", "--untimed", "--no-auto-quality"]
    jax_out, port_out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli.main(argv + ["-o", str(jax_out)]) == 0
    assert port_cli.main(argv + ["--device", "cpu", "-o",
                                 str(port_out)]) == 0
    data = port_out.read_bytes()
    assert data.count(b"FRAME\n") == 1 + 3 + 2 + 3 + 2 + 3
    assert data == jax_out.read_bytes()


def test_cli_needs_cuda_for_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        port_cli.main(["synthetic:moving_box", "--device", "cuda"])


@pytest.mark.parametrize("kw", [dict(frame_output_mode=5,
                                     initial_search_radius=257),
                                dict(model="hopperq", initial_search_radius=1),
                                dict(frame_output_mode=6,
                                     initial_search_radius=300),
                                dict(initial_search_radius=0)])
def test_uncovered_configurations_raise(kw):
    """What the engine refuses, as the JAX engine does: search radii
    outside [2, 256], in any mode and model (radii 17-256 run since the
    flow kernel takes 16-layer chunks, tests/test_torch_layer_buckets.py)."""
    with pytest.raises(ValueError, match="radius"):
        port_engine.EngineConfig(device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(frame_output_mode=5),
                                dict(frame_output_mode=6),
                                *(dict(model=m) for m in ("hopperx", "hopperq",
                                                          "hopperxq", "blend",
                                                          "repeat"))])
def test_covered_configurations(kw):
    cfg = port_engine.EngineConfig(device="cpu", **kw)
    assert all(getattr(cfg, k) == v for k, v in kw.items())


def test_p010_raises(small_cfg):
    """P010 runs on every sampler and in the side-by-side modes, at radii
    above 16 too; what still raises for it is a search radius outside
    [2, 256], and an unknown sampler is refused outright."""
    cfg = dataclasses.replace(small_cfg, pixfmt="p010")
    for ws in ("pair", "fused", "pallas"):
        port = port_engine.InterpolationEngine(port_engine.EngineConfig(
            device="cpu", warp_sampling=ws))
        for frame in synthetic.moving_box(cfg, 2):
            outs = port.push(frame)
        assert outs and outs[0].to_video_frame().y.dtype == np.uint16
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", frame_output_mode=5))
    for frame in synthetic.moving_box(cfg, 2):
        outs = port.push(frame)
    assert outs and outs[0].to_video_frame().y.dtype == np.uint16
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", warp_sampling="pallas", frame_output_mode=5,
        initial_search_radius=32, auto_quality=False))
    for frame in synthetic.moving_box(cfg, 2):
        outs = port.push(frame)
    assert outs and outs[0].to_video_frame().y.dtype == np.uint16
    with pytest.raises(ValueError, match="radius"):
        port_engine.EngineConfig(device="cpu", warp_sampling="pallas",
                                 frame_output_mode=5,
                                 initial_search_radius=257)
    with pytest.raises(ValueError):
        port_engine.EngineConfig(device="cpu", warp_sampling="tiles")


def test_engine_errors_propagate_through_the_pipeline(small_cfg):
    """The port's pipeline is not fail-open: an engine error reaches the
    caller instead of turning into passed-through frames."""
    from mpv_frame_interpolator_tpu_torch.io.sinks import NullSink
    from mpv_frame_interpolator_tpu_torch.pipeline.player import Pipeline

    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu"))

    def broken(*a, **k):
        raise RuntimeError("kernel failed")

    port.stage = broken
    with pytest.raises(RuntimeError, match="kernel failed"):
        Pipeline(synthetic.moving_box(small_cfg, 3), port,
                 NullSink()).run()
