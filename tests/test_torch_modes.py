"""Output modes 0-4 and the "pallas" sampler of the port (plain PyTorch
path) against the JAX package on the CPU:

* the warp of one pair, every mode, against the JAX batched warp
  (``make_warp_batch_fn``) and the NumPy oracle (``oracle.warp_frame``) on
  a 64x48 frame, a 96x544 frame (res scalar 2) and a stride wider than
  the picture -- the analogs of ``test_warp_golden.py::test_modes_exact``,
  ``::test_hsv_flow_near_exact`` and ``TestPyramidAllModes``;
* the engine against the JAX engine on clips with and without a scene
  cut, NV12 and P010: modes 0, 1 and 4 under the "pair" and "pallas"
  samplers, mode 2 under "pallas" with levels (16.5, 235), mode 3 (one
  JAX run a configuration and clip serves both samplers: on the CPU the
  JAX engine's "pallas" sampler runs its "pair" program);
* the CLI against the JAX CLI, y4m bytes.

Bit-exact, except mode 3: its colours are float32 math (atan2, trunc),
held as the JAX package holds its own (``test_warp_golden.py``): the
share of samples that differ by more than 2 stays under 0.005."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpv_frame_interpolator_tpu import cli as jax_cli
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops import oracle
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry
from mpv_frame_interpolator_tpu.ops.warp import make_warp_batch_fn
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch import cli as port_cli
from mpv_frame_interpolator_tpu_torch.convert import frame_to_device
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.ops.cuda import blend_levels as KG
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KS
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine

from conftest import frame_pair, planar

torch.set_num_threads(1)

TS = [0.0, 0.4, 1.0]


def _near(a, b):
    """The JAX package's HSV tolerance."""
    frac = np.mean(np.abs(a.astype(int) - b.astype(int)) > 2)
    assert frac < 0.005, f"{frac=}"


def _port_warp(f1, f2, geom, blur, mode, ts, scale_shift=0,
               levels=(0, 255), sampling="pair"):
    d1, d2 = frame_to_device(f1, "cpu"), frame_to_device(f2, "cpu")
    y, uv = port_engine._warp_stage(
        geom, scale_shift, levels, mode, sampling, "hopper",
        (d1.y, d1.uv, d2.y, d2.uv), torch.from_numpy(blur.astype(np.int32)),
        torch.tensor(ts, dtype=torch.float32))
    return ([np.asarray(y[i]) for i in range(len(ts))],
            [np.asarray(uv[i]) for i in range(len(ts))])


def _jax_warp(f1, f2, geom, blur, mode, ts, scale_shift=0):
    fn = make_warp_batch_fn(geom, mode, scale_shift)
    y, u, v = fn(*(jnp.asarray(p) for p in (*planar(f1), *planar(f2))),
                 jnp.asarray(blur.astype(np.int32)),
                 jnp.asarray(ts, jnp.float32), jnp.float32(0.0),
                 jnp.float32(255.0))
    y, u, v = (np.asarray(a) for a in (y, u, v))
    uv = np.empty((*u.shape[:2], u.shape[2] * 2), u.dtype)
    uv[..., 0::2], uv[..., 1::2] = u, v
    return y, uv


def _setup(cfg, source="moving_box", radius=8):
    f1, f2 = frame_pair(cfg, source)
    geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride, f1.fmt.width)
    _, blur = oracle.calculate_optical_flow(
        f1.y, f1.uv, f2.y, f2.uv, search_radius=radius,
        res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
    return f1, f2, geom, blur


def _compare_warp(f1, f2, geom, blur, mode):
    y, uv = _port_warp(f1, f2, geom, blur, mode, TS)
    jy, juv = _jax_warp(f1, f2, geom, blur, mode, TS)
    wa = geom.actual_width
    for n, t in enumerate(TS):
        ry, ruv = oracle.warp_frame(f1.y, f1.uv, f2.y, f2.uv, blur, t, mode,
                                    geom.res_scalar, wa)
        for got, want in ((y[n], jy[n]), (uv[n], juv[n]),
                          (y[n], ry[:, :wa]), (uv[n], ruv[:, :wa])):
            assert got.shape == want.shape and got.dtype == want.dtype
            if mode == TW.HSV_FLOW:
                _near(got, want)
            else:
                np.testing.assert_array_equal(got, want)


_MODES = [TW.WARPED_FRAME_12, TW.WARPED_FRAME_21, TW.HSV_FLOW, TW.GREY_FLOW]


@pytest.mark.parametrize("mode", _MODES)
def test_warp_modes(small_cfg, mode):
    _compare_warp(*_setup(small_cfg), mode)


@pytest.mark.parametrize("mode", _MODES)
def test_warp_modes_pyramid(pyramid_cfg, mode):
    f1, f2, geom, blur = _setup(pyramid_cfg, "gradient_pan", radius=5)
    assert geom.res_scalar >= 1
    _compare_warp(f1, f2, geom, blur, mode)


@pytest.mark.parametrize("mode", _MODES)
def test_warp_modes_with_stride_padding(mode):
    cfg = synthetic.SyntheticConfig(width=64, height=48, stride=80)
    f1, f2, geom, blur = _setup(cfg)
    assert geom.stride == 80 and geom.actual_width == 64
    _compare_warp(f1, f2, geom, blur, mode)


@pytest.mark.parametrize("mode", [TW.WARPED_FRAME_12, TW.WARPED_FRAME_21,
                                  TW.HSV_FLOW, TW.GREY_FLOW])
def test_warp_modes_p010(small_cfg, mode):
    """P010 against the JAX batched warp (the oracle is 8-bit): raw
    samples uncapped in modes 0/1, colours on the 8-bit scale shifted
    back in mode 3, the grey view << 8 in mode 4."""
    cfg = dataclasses.replace(small_cfg, pixfmt="p010")
    f1, f2 = frame_pair(cfg, "moving_box")
    f1.y[:4, :4] = 65535            # a raw sample above the 8-bit cap
    geom = FlowGeometry.create(48, 64, 64)
    rng = np.random.default_rng(mode)
    blur = rng.integers(-9, 10, (2, geom.low_h, geom.low_w)).astype(np.int32)
    y, uv = _port_warp(f1, f2, geom, blur, mode, TS, scale_shift=8)
    jy, juv = _jax_warp(f1, f2, geom, blur, mode, TS, scale_shift=8)
    for n in range(len(TS)):
        assert y[n].dtype == np.uint16
        for got, want in ((y[n], jy[n]), (uv[n], juv[n])):
            if mode == TW.HSV_FLOW:
                _near(got, want)
            else:
                np.testing.assert_array_equal(got, want)


def test_grey_needs_no_sampler(small_cfg):
    f1, f2, geom, blur = _setup(small_cfg)
    before = (KS.counts.kernel, KS.counts.plain)
    _port_warp(f1, f2, geom, blur, TW.GREY_FLOW, TS)
    assert (KS.counts.kernel, KS.counts.plain) == before


@pytest.mark.parametrize("mode,calls", [(0, 1), (1, 1), (2, 2), (3, 0)])
def test_sampler_calls_per_position(small_cfg, mode, calls):
    """K5 once a position in modes 0/1 and twice in mode 2 under "pallas";
    mode 3 samples inside its own kernel (V2, ``warp_views.warp_hsv``)."""
    f1, f2, geom, blur = _setup(small_cfg)
    before = KS.counts.plain
    _port_warp(f1, f2, geom, blur, mode, TS, sampling="pallas")
    assert KS.counts.plain == before + calls * len(TS)


@pytest.mark.parametrize("mode,calls", [(0, 0), (1, 0), (2, 1), (3, 0),
                                        (4, 0)])
def test_blend_kernel_calls_per_position(small_cfg, mode, calls):
    """The blend of the two directions (G1) runs once a position in mode 2
    under "pallas", and nowhere else: mode 3 blends inside V2."""
    f1, f2, geom, blur = _setup(small_cfg)
    before = (KG.counts.kernel, KG.counts.plain)
    _port_warp(f1, f2, geom, blur, mode, TS, sampling="pallas")
    assert (KG.counts.kernel, KG.counts.plain) == (
        before[0], before[1] + calls * len(TS))


# --- the engine against the JAX engine --------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's runs of this module, by configuration and clip."""
    return {}


def _jax_outputs(runs, cfg, clip, **kw):
    """The JAX engine's outputs for each frame of a 7-frame clip, run once
    a module for each configuration.  It runs its "pair" program under
    both samplers the port is held to here: on the CPU its "pallas"
    sampler is that program (the Pallas kernels are TPU-only,
    ``ops/warp.py`` ``use_pallas``, ``engine.py`` ``pair_active``)."""
    key = (clip, cfg.pixfmt, tuple(sorted(kw.items())))
    if key not in runs:
        ref = jax_engine.InterpolationEngine(jax_engine.EngineConfig(
            background_precompile=False, auto_quality=False,
            measure_timing=False, warp_sampling="pair", **kw))
        runs[key] = [[(o.pts, o.to_video_frame()) for o in ref.push(f)]
                     for f in getattr(synthetic, clip)(cfg, 7)]
    return runs[key]


def _drive(runs, cfg, clip, sampling, hsv=False, **kw):
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", auto_quality=False, measure_timing=False,
        warp_sampling=sampling, **kw))
    ref = _jax_outputs(runs, cfg, clip, **kw)
    frames = list(getattr(synthetic, clip)(cfg, 7))
    assert len(frames) == len(ref)
    n = 0
    for f, r_outs in zip(frames, ref):
        p_outs = port.push(f)
        assert len(p_outs) == len(r_outs)
        for (pts, rf), p in zip(r_outs, p_outs):
            assert p.pts == pts
            pf = p.to_video_frame()
            assert pf.y.dtype == rf.y.dtype and pf.y.shape == rf.y.shape
            for a, b in ((pf.y, rf.y), (pf.uv, rf.uv)):
                if hsv:
                    _near(a, b)
                else:
                    np.testing.assert_array_equal(a, b)
        n += len(p_outs)
    return n


_CLIPS = [("moving_box", "nv12"), ("scene_cut", "nv12"),
          ("moving_box", "p010"), ("scene_cut", "p010")]


@pytest.mark.parametrize("clip,pixfmt", _CLIPS)
@pytest.mark.parametrize("mode,sampling", [(0, "pair"), (0, "pallas"),
                                           (1, "pair"), (1, "pallas"),
                                           (4, "pair"), (4, "pallas")])
def test_engine_modes(small_cfg, jax_runs, clip, pixfmt, mode, sampling):
    cfg = dataclasses.replace(small_cfg, pixfmt=pixfmt)
    n = _drive(jax_runs, cfg, clip, sampling, display_fps=60.0,
               scene_detection=True, initial_search_radius=16,
               frame_output_mode=mode)
    assert n == 1 + 3 + 2 + 3 + 2 + 3 + 2


@pytest.mark.parametrize("clip,pixfmt", _CLIPS)
def test_engine_blend_on_the_pallas_sampler(small_cfg, jax_runs, clip,
                                            pixfmt):
    cfg = dataclasses.replace(small_cfg, pixfmt=pixfmt)
    before = KS.counts.plain
    n = _drive(jax_runs, cfg, clip, "pallas", display_fps=60.0,
               scene_detection=True, initial_search_radius=16,
               black_level=16.5, white_level=235.0)
    assert KS.counts.plain - before == 2 * (n - 1)


@pytest.mark.parametrize("clip,pixfmt", _CLIPS)
def test_engine_hsv(small_cfg, jax_runs, clip, pixfmt):
    cfg = dataclasses.replace(small_cfg, pixfmt=pixfmt)
    _drive(jax_runs, cfg, clip, "pair", hsv=True, display_fps=60.0,
           scene_detection=True, initial_search_radius=16,
           frame_output_mode=3)


# --- the CLI against the JAX CLI --------------------------------------------

@pytest.mark.parametrize("extra", [["--mode", "warp12"], ["--mode", "grey"],
                                   ["--mode", "blend", "--warp-sampling",
                                    "pallas", "--p010"]])
def test_cli_y4m_bytes(tmp_path, extra):
    argv = ["synthetic:moving_box", "--width", "64", "--height", "48",
            "--frames", "6", "--untimed", "--no-auto-quality", *extra]
    jax_out, port_out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli.main(argv + ["-o", str(jax_out)]) == 0
    assert port_cli.main(argv + ["--device", "cpu", "-o",
                                 str(port_out)]) == 0
    data = port_out.read_bytes()
    assert data.count(b"FRAME\n") == 1 + 3 + 2 + 3 + 2 + 3
    assert data == jax_out.read_bytes()


@pytest.mark.parametrize("mode", ["sbs1", "6", "bogus"])
def test_cli_modes_that_are_not_ported(mode):
    """The side-by-side modes run (tests/test_torch_sbs.py), at any search
    radius the engine takes (2..256, tests/test_torch_layer_buckets.py);
    with a radius outside it they are refused, as the JAX engine refuses
    it, and an unknown mode is refused."""
    err = SystemExit if mode == "bogus" else ValueError
    with pytest.raises(err):
        port_cli.main(["synthetic:moving_box", "--width", "64", "--height",
                       "48", "--frames", "2", "--device", "cpu", "--mode",
                       mode, "--search-radius", "257"])
