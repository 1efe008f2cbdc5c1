"""The side-by-side output modes 5 (SBS1) and 6 (SBS2) of the port
(``ops/warp.warp_sbs``, plain tensor ops) against the JAX package on the
CPU:

* the warp of one pair against the JAX batched warp
  (``make_warp_batch_fn(geom, 5 | 6)``) and the NumPy oracle
  (``oracle.warp_frame``) on ``tests/test_warp_golden.py``'s cases
  (``MODES_EXACT``), a stride wider than the picture (SBS2 splits at the
  stride, not at the width), res scalar 2, and P010 with levels (16, 235);
* the engine against the JAX engine, hopper and blend, NV12 and P010
  with levels, across a scene cut: mode 6 interpolates on the first
  source frame too (paired with itself);
* ``--mode sbs1`` and ``--mode sbs2`` through the port's CLI write the
  JAX CLI's bytes.

Bit-exact throughout."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpv_frame_interpolator_tpu import cli as jax_cli
from mpv_frame_interpolator_tpu.frame import interleave_chroma
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops import oracle
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry
from mpv_frame_interpolator_tpu.ops.warp import make_warp_batch_fn
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch import cli as port_cli
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine

from conftest import frame_pair, planar

torch.set_num_threads(1)

TS = [0.0, 0.4, 1.0]


def _setup(cfg, source="moving_box", radius=8):
    f1, f2 = frame_pair(cfg, source)
    geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride, f1.fmt.width)
    _, blur = oracle.calculate_optical_flow(
        f1.y, f1.uv, f2.y, f2.uv, search_radius=radius,
        res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
    return f1, f2, geom, blur.astype(np.int32)


def _port(f1, f2, geom, blur, mode, t, scale_shift=0, levels=(0, 255)):
    y, uv = TW.warp_sbs(mode, *(torch.from_numpy(p) for p in (
        f1.y, f1.uv, f2.y, f2.uv, blur)), torch.tensor(t), geom.res_scalar,
        geom.actual_width, scale_shift, levels)
    return y.numpy(), uv.numpy()


def _jax(f1, f2, geom, blur, mode, scale_shift=0, levels=(0.0, 255.0)):
    fn = make_warp_batch_fn(geom, mode, scale_shift)
    y, u, v = fn(*(jnp.asarray(p) for p in (*planar(f1), *planar(f2))),
                 jnp.asarray(blur), jnp.asarray(TS, jnp.float32),
                 jnp.float32(levels[0]), jnp.float32(levels[1]))
    return [(np.asarray(y[i]), interleave_chroma(np.asarray(u[i]),
                                                 np.asarray(v[i])))
            for i in range(len(TS))]


def _compare(f1, f2, geom, blur, mode, oracle_too=True):
    want = _jax(f1, f2, geom, blur, mode)
    wa = geom.actual_width
    for n, t in enumerate(TS):
        got = _port(f1, f2, geom, blur, mode, t)
        refs = [want[n]]
        if oracle_too:
            ry, ruv = oracle.warp_frame(f1.y, f1.uv, f2.y, f2.uv, blur, t,
                                        mode, geom.res_scalar, wa)
            refs.append((ry[:, :wa], ruv[:, :wa]))
        for ref in refs:
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype and g.shape == r.shape
                np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mode", [TW.SIDE_BY_SIDE_1, TW.SIDE_BY_SIDE_2])
def test_sbs_modes_exact(small_cfg, mode):
    _compare(*_setup(small_cfg), mode)


@pytest.mark.parametrize("mode", [TW.SIDE_BY_SIDE_1, TW.SIDE_BY_SIDE_2])
def test_sbs_with_stride_padding(mode):
    """stride 96 > width 64: SBS2's right half starts at column 48 (the
    stride's half), its left band reads source columns up to the stride."""
    cfg = synthetic.SyntheticConfig(width=64, height=48, stride=96)
    f1, f2, geom, blur = _setup(cfg)
    assert (geom.stride, geom.actual_width) == (96, 64)
    _compare(f1, f2, geom, blur, mode)


def test_sbs2_pyramid_geometry(pyramid_cfg):
    f1, f2, geom, blur = _setup(pyramid_cfg, "gradient_pan", radius=5)
    assert geom.res_scalar == 2
    _compare(f1, f2, geom, blur, TW.SIDE_BY_SIDE_2, oracle_too=False)


@pytest.mark.parametrize("mode", [TW.SIDE_BY_SIDE_1, TW.SIDE_BY_SIDE_2])
def test_sbs_p010_with_levels(small_cfg, mode):
    cfg = dataclasses.replace(small_cfg, pixfmt="p010", stride=80)
    f1, f2 = frame_pair(cfg, "moving_box")
    geom = FlowGeometry.create(48, 80, 64)
    rng = np.random.default_rng(mode)
    blur = rng.integers(-30, 31, (2, geom.low_h, geom.low_w)).astype(
        np.int32)
    want = _jax(f1, f2, geom, blur, mode, 8, (16.0, 235.0))
    for n, t in enumerate(TS):
        got = _port(f1, f2, geom, blur, mode, t, 8, TW.level_ints(16, 235))
        for g, r in zip(got, want[n]):
            assert g.dtype == np.uint16
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mode,model,pixfmt", [(5, "hopper", "p010"),
                                              (6, "hopper", "nv12"),
                                              (6, "blend", "p010")])
def test_engine_sbs_equals_jax(small_cfg, mode, model, pixfmt):
    """The engine against the JAX engine across a scene cut, levels (16,
    235), stride 80 > width 64; mode 6's first source frame gives warped
    outputs already (its pair is the frame with itself)."""
    cfg = dataclasses.replace(small_cfg, pixfmt=pixfmt, stride=80)
    kw = dict(auto_quality=False, measure_timing=False, display_fps=60.0,
              frame_output_mode=mode, model=model, initial_search_radius=8,
              black_level=16.0, white_level=235.0)
    ref = jax_engine.InterpolationEngine(jax_engine.EngineConfig(
        background_precompile=False, **kw))
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", **kw))
    n = 0
    for i, f in enumerate(synthetic.scene_cut(cfg, 4, cut_at=2)):
        r_outs, p_outs = ref.push(f), port.push(f)
        assert len(p_outs) == len(r_outs) > 0
        for r, p in zip(r_outs, p_outs):
            assert p.pts == r.pts
            rf, pf = r.to_video_frame(), p.to_video_frame()
            np.testing.assert_array_equal(pf.y, rf.y)
            np.testing.assert_array_equal(pf.uv, rf.uv)
            n += 1
        if i == 0:      # passed through in mode 5, warped in mode 6
            assert isinstance(p_outs[0].device_planes()[0],
                              torch.Tensor) == (mode == 6)
    assert n == (9 if mode == 5 else 10)


@pytest.mark.parametrize("mode", ["sbs1", "sbs2"])
def test_cli_sbs_bytes(tmp_path, mode):
    argv = ["synthetic:moving_box", "--width", "64", "--height", "48",
            "--frames", "4", "--untimed", "--no-auto-quality", "--mode",
            mode]
    jax_out, port_out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli.main(argv + ["-o", str(jax_out)]) == 0
    assert port_cli.main(argv + ["--device", "cpu", "-o",
                                 str(port_out)]) == 0
    data = port_out.read_bytes()
    assert data.count(b"FRAME\n") >= 4
    assert data == jax_out.read_bytes()
