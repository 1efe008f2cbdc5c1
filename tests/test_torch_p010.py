"""10-bit P010 and black/white levels on the port, against the JAX package
on the CPU: the plain K2 (pair blend) with scale_shift 8 and levels
against the JAX batch warp and its per-position XLA warp, the plain K1
(flow step) and the whole flow on uint16 planes with luma_shift 8, the
scene-cut score with bit_shift 8, the engine on P010 clips under the
"pair" and "fused" samplers, and the CLI's y4m bytes.  Bit-exact; the
only tolerance is the cut score (one ulp: the JAX package sums in float32
in XLA's order), with the cut decision exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu import cli as jax_cli
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops import flow as F
from mpv_frame_interpolator_tpu.ops import warp as W
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu.pipeline import scene as jax_scene
from mpv_frame_interpolator_tpu_torch import cli as port_cli
from mpv_frame_interpolator_tpu_torch.ops import flow as TF
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine
from mpv_frame_interpolator_tpu_torch.pipeline import scene as port_scene

torch.set_num_threads(1)

# (black, white): the defaults, TV range, half-way values that round half
# to even (16.5 -> 16, 235.5 -> 236), and the extremes of
# tests/test_warp_golden.py, white == black among them
LEVELS = [(0.0, 255.0), (16.0, 235.0), (16.5, 235.5), (0.0, 1.0),
          (254.0, 255.0), (128.0, 128.0)]
TS = [0.0, 0.25, 0.4, 0.9999]


def _planar(rng, h, w, dt, hi):
    return (rng.integers(0, hi, (h, w)).astype(dt),
            rng.integers(0, hi, (h // 2, w // 2)).astype(dt),
            rng.integers(0, hi, (h // 2, w // 2)).astype(dt))


def _interleave(u, v):
    uv = np.empty((u.shape[0], u.shape[1] * 2), u.dtype)
    uv[:, 0::2], uv[:, 1::2] = u, v
    return uv


def test_level_ints_round_half_to_even():
    assert TW.level_ints(16.5, 235.5) == (16, 236)
    assert TW.level_ints(15.5, 234.5) == (16, 234)
    assert TW.level_ints(0.0, 255.0) == (0, 255)
    for b in (16.5, 17.5, -0.5, 127.49999):
        assert TW.level_ints(b, b)[0] == int(jnp.round(jnp.float32(b)))


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("black,white", LEVELS)
def test_level_maps_equal_the_jax_maps(scale_shift, black, white):
    """The port's level maps, the default levels' clip shortcut included,
    against the JAX package's full maps on every blended value (and past
    both ends of the range)."""
    b = np.arange(-300, (256 << scale_shift) + 300, dtype=np.int32)
    k, w = TW.level_ints(black, white)
    tb = torch.from_numpy(b)
    np.testing.assert_array_equal(
        TW.levels_y(tb, k, w, scale_shift).numpy(),
        np.asarray(W._levels_y(jnp.asarray(b), jnp.float32(black),
                               jnp.float32(white), scale_shift)))
    np.testing.assert_array_equal(
        TW.levels_uv(tb, w, scale_shift).numpy(),
        np.asarray(W._levels_uv(jnp.asarray(b), jnp.float32(white),
                                scale_shift)))


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("black,white", LEVELS)
def test_pair_blend_levels(scale_shift, black, white):
    h, w = 48, 64
    geom = F.FlowGeometry.create(h, w, w)
    rng = np.random.default_rng(int(black * 10 + white + scale_shift))
    dt = np.uint16 if scale_shift else np.uint8
    f1 = _planar(rng, h, w, dt, 1 << (16 if scale_shift else 8))
    f2 = _planar(rng, h, w, dt, 1 << (16 if scale_shift else 8))
    pick = rng.integers(0, 4, (geom.low_h, geom.low_w))
    vals = np.array([(0, 0), (3, -2), (-5, 4), (9, 7)], np.int32)
    blurred = np.stack([vals[pick, 0], vals[pick, 1]])

    got_y, got_uv = KW.pair_blend(
        *(torch.from_numpy(p) for p in (f1[0], _interleave(f1[1], f1[2]),
                                        f2[0], _interleave(f2[1], f2[2]))),
        torch.from_numpy(blurred), torch.tensor(TS, dtype=torch.float32),
        geom.res_scalar, w, scale_shift, TW.level_ints(black, white))
    got_y, got_uv = got_y.numpy(), got_uv.numpy()
    assert got_y.dtype == dt

    jf1 = [jnp.asarray(p) for p in f1]
    jf2 = [jnp.asarray(p) for p in f2]
    fn = W.make_warp_batch_fn(geom, W.BLENDED_FRAME, scale_shift)
    ry, ru, rv = fn(*jf1, *jf2, jnp.asarray(blurred),
                    jnp.asarray(TS, jnp.float32), jnp.float32(black),
                    jnp.float32(white))
    np.testing.assert_array_equal(got_y, np.asarray(ry))
    for n in range(len(TS)):
        np.testing.assert_array_equal(
            got_uv[n], _interleave(np.asarray(ru[n]), np.asarray(rv[n])))

    fields = W._warp_fields(geom, jnp.asarray(blurred))
    for n, t in enumerate(TS):
        sy, su, sv = W._warp_sample(
            geom, W.BLENDED_FRAME, scale_shift,
            jnp.uint16 if scale_shift else jnp.uint8, *jf1, *jf2, fields,
            jnp.float32(t), jnp.float32(black), jnp.float32(white))
        np.testing.assert_array_equal(got_y[n], np.asarray(sy))
        np.testing.assert_array_equal(
            got_uv[n], _interleave(np.asarray(su), np.asarray(sv)))


@pytest.mark.parametrize("window,nb,is_y,ds", [(1, True, 0, 8),
                                                (4, True, 1, 8),
                                                (16, False, 0, 8),
                                                (4, True, 1, 31)])
def test_flow_step_p010(window, nb, is_y, ds):
    """One step on random 16-bit planes with luma_shift 8 against the JAX
    step branch (gather form); ds 31 makes the uint32 partials wrap."""
    h, w = 48, 64
    geom = F.FlowGeometry.create(h, w, w, max_calc_res=24)
    lh, lw = geom.low_h, geom.low_w
    rng = np.random.default_rng(window * 7 + is_y + ds)
    f1 = _planar(rng, h, w, np.uint16, 1 << 16)
    f2 = _planar(rng, h, w, np.uint16, 1 << 16)
    vals = rng.integers(-20, 20, (2, 5))
    pick = rng.integers(0, 5, (lh, lw))
    off_x, off_y = (vals[0][pick].astype(np.int32),
                    vals[1][pick].astype(np.int32))

    probe = TF.subsampled_f2(geom, *(torch.from_numpy(p) for p in f2))
    assert all(p.dtype == torch.uint16 for p in probe)
    before = KS.counts.plain
    got = KS.flow_step(*(torch.from_numpy(p) for p in f1), *probe,
                       torch.from_numpy(off_x), torch.from_numpy(off_y),
                       is_y, 16, ds, 6, window, nb, geom.res_scalar,
                       geom.height, geom.stride, 8)
    assert KS.counts.plain == before + 1

    jf1 = [jnp.asarray(p) for p in f1]
    f2_probe = F._subsampled_f2(geom, *(jnp.asarray(p) for p in f2))
    branch = F._make_step_branch(geom, window, nb, 16, 8, *jf1, f2_probe,
                                 None)
    ref = jax.jit(branch)(jnp.asarray(off_x), jnp.asarray(off_y),
                          jnp.int32(is_y), jnp.int32(16), jnp.int32(ds),
                          jnp.int32(6))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def _clip_planes(frame):
    return (frame.y, np.ascontiguousarray(frame.uv[:, 0::2]),
            np.ascontiguousarray(frame.uv[:, 1::2]))


@pytest.mark.parametrize("clip,radius", [("gradient_pan", 16),
                                         ("noise", 8)])
def test_flow_p010(clip, radius):
    """The whole flow on P010 planes against make_flow_fn(luma_shift=8),
    and against the port's own flow on the 8-bit clip: content that is
    8-bit << 8 gives the identical field (the analog of
    tests/test_engine.py::test_p010_flow_matches_nv12)."""
    kw = dict(width=96, height=64, fps=24.0)
    fr8 = list(getattr(synthetic, clip)(synthetic.SyntheticConfig(**kw), 2))
    fr16 = list(getattr(synthetic, clip)(
        synthetic.SyntheticConfig(pixfmt="p010", **kw), 2))
    geom = F.FlowGeometry.create(64, 96, 96)
    port_geom = TF.FlowGeometry.create(64, 96, 96)

    def port(frames, luma_shift):
        t = [torch.from_numpy(p) for f in frames for p in _clip_planes(f)]
        return [x.numpy() for x in TF.flow(port_geom, *t, radius, 8, 6,
                                           luma_shift)]

    got = port(fr16, 8)
    fn = F.make_flow_fn(geom, radius, luma_shift=8)
    want = fn(*(jnp.asarray(p) for f in fr16 for p in _clip_planes(f)),
              jnp.int32(8), jnp.int32(6))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    got8 = port(fr8, 0)
    np.testing.assert_array_equal(got[0], got8[0])
    np.testing.assert_array_equal(got[1], got8[1])


@pytest.mark.parametrize("rs", [0, 1, 3])
def test_cut_score_bit_shift(rs):
    rng = np.random.default_rng(rs)
    h, w = 270, 480
    for lo, hi in ((0, 1 << 16), (30000, 42000)):
        y1 = rng.integers(lo, hi, (h, w)).astype(np.uint16)
        y2 = rng.integers(lo, hi, (h, w)).astype(np.uint16)
        a = np.float32(port_scene.cut_score(
            torch.from_numpy(y1), torch.from_numpy(y2), rs, 8))
        b = np.float32(jax_scene.cut_score(jnp.asarray(y1), jnp.asarray(y2),
                                           rs, 8))
        assert abs(a - b) <= np.spacing(max(abs(a), abs(b))), (a, b)
        for threshold in (28.0, float(b)):
            assert (a > np.float32(threshold)) == (b > np.float32(threshold))


def _engines(**kw):
    ref = jax_engine.InterpolationEngine(jax_engine.EngineConfig(
        background_precompile=False, auto_quality=False,
        measure_timing=False, **kw))
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", auto_quality=False, measure_timing=False, **kw))
    return ref, port


@pytest.mark.parametrize("sampling", ["pair", "fused"])
@pytest.mark.parametrize("clip", ["moving_box", "scene_cut"])
def test_engine_p010(clip, sampling):
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                    pixfmt="p010")
    ref, port = _engines(display_fps=60.0, initial_search_radius=16,
                         black_level=16.5, white_level=235.0,
                         warp_sampling=sampling)
    gen = (synthetic.scene_cut(cfg, 7, cut_at=4) if clip == "scene_cut"
           else synthetic.moving_box(cfg, 6))
    n = cuts = 0
    high = False
    for frame in gen:
        r_outs, p_outs = ref.push(frame), port.push(frame)
        assert len(r_outs) == len(p_outs)
        for r, p in zip(r_outs, p_outs):
            assert p.pts == r.pts
            rf, pf = r.to_video_frame(), p.to_video_frame()
            assert dataclasses.asdict(pf.fmt) == dataclasses.asdict(rf.fmt)
            assert pf.y.dtype == pf.uv.dtype == np.uint16
            np.testing.assert_array_equal(pf.y, rf.y)
            np.testing.assert_array_equal(pf.uv, rf.uv)
            high |= int(pf.y.max()) > 255
            n += 1
        if r_outs and r_outs[0]._index is not None:
            a = np.float32(ref.last_cut_score())
            b = np.float32(port.last_cut_score())
            assert abs(a - b) <= np.spacing(max(abs(a), abs(b))), (a, b)
            cuts += a > np.float32(ref.scene.threshold)
    assert high, "P010 outputs must use the 16-bit range"
    assert port.scene_cuts() == cuts
    assert (cuts > 0) == (clip == "scene_cut")
    assert n > 10


def test_cli_p010_levels_fused_y4m_bytes(tmp_path):
    argv = ["synthetic:moving_box", "--width", "64", "--height", "48",
            "--frames", "6", "--untimed", "--no-auto-quality", "--p010",
            "--black-level", "16", "--white-level", "235",
            "--warp-sampling", "fused"]
    jax_out, port_out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli.main(argv + ["-o", str(jax_out)]) == 0
    assert port_cli.main(argv + ["--device", "cpu", "-o",
                                 str(port_out)]) == 0
    data = port_out.read_bytes()
    assert data.startswith(b"YUV4MPEG2 W64 H48 ") and b"C420p10" in data[:60]
    assert data.count(b"FRAME\n") == 1 + 3 + 2 + 3 + 2 + 3
    assert data == jax_out.read_bytes()
