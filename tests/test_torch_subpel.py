"""The sub-pel option (``subpel_flow``) of the port on the CPU, against
the JAX package with the same seeded numpy inputs:

* S1's plain versions: ``subpel_frac_plain`` against the JAX
  ``ops/flow.subpel_refine`` on committed flows of 8-bit clips (res
  scalars 0 and 2) and P010 clips (the SAD shifted to the 8-bit scale),
  and on fields with wild offsets that send probes past every edge; and
  ``subpel_refine_plain`` = (offset << 6) + frac, the field S1 writes;
* ``flow_pyramid(..., subpel=True)`` (on the card one launch: the
  pyramid, S1's phases, the blur) against the JAX pyramid, its
  ``subpel_refine`` and its blur of the 1/64-pel field, 8-bit and P010;
* Q1's plain version with a sub-pel field against the JAX bilinear
  branch with its FX fields (``_warp_fields(..., frac)`` and
  ``_warp_sample(..., bilinear=True)``), NV12 and P010 with levels
  (16, 235), with and without occlusion, a stride wider than the picture;
  a zero field changes nothing; ``q1_model`` (the kernel's arithmetic in
  NumPy) agrees;
* the engine under ``subpel_flow=True`` against the JAX engine for
  hopperq and hopperxq in mode 2 (hopper and hopperx:
  ``tests/test_torch_subpel_engine.py``), with the launches on the CPU:
  the plain pyramid, S1 and the blur once a pair.

Bit-exact throughout (tolerance 0).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.frame import interleave_chroma, split_chroma
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops import flow as JF
from mpv_frame_interpolator_tpu.ops import warp as JW
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch.ops import flow as TF
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.ops.cuda import subpel as KP
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_bilinear as KQ
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine

from test_torch_cuda import q1_model

torch.set_num_threads(1)


def _clip(w, h, pixfmt, source):
    cfg = synthetic.SyntheticConfig(width=w, height=h, pixfmt=pixfmt)
    gen = getattr(synthetic, source)(cfg, 2)
    f1, f2 = next(gen), next(gen)
    return [np.ascontiguousarray(p) for p in
            (f1.y, *split_chroma(f1.uv), f2.y, *split_chroma(f2.uv))]


@pytest.mark.parametrize("w,h,pixfmt,source,field", [
    (64, 48, "nv12", "noise", "flow"), (64, 48, "nv12", "moving_box",
                                        "flow"),
    (96, 544, "nv12", "noise", "flow"),
    (64, 48, "p010", "noise", "flow"), (64, 48, "nv12", "noise", "wild"),
    (64, 48, "p010", "gradient_pan", "wild")])
def test_subpel_frac_equals_jax(w, h, pixfmt, source, field):
    planes = _clip(w, h, pixfmt, source)
    luma_shift = 8 if pixfmt == "p010" else 0
    tgeom = TF.FlowGeometry.create(h, w, w)
    t = [torch.from_numpy(p) for p in planes]
    if field == "flow":
        offset = TF.flow(tgeom, *t, 8, 8, 6, luma_shift, blur=False)
    else:
        rng = np.random.default_rng(w + h + luma_shift)
        offset = torch.from_numpy(rng.integers(
            -80, 81, (2, tgeom.low_h, tgeom.low_w)).astype(np.int32))
    probe = TF.subsampled_f2(tgeom, *t[3:])
    got = KP.subpel_frac_plain(offset, *t[:3], *probe, tgeom.res_scalar, h,
                               w, luma_shift)
    geom = JF.FlowGeometry.create(h, w, w)
    a = [jnp.asarray(p) for p in planes]
    want = np.asarray(JF.subpel_refine(
        geom, jnp.asarray(offset.numpy()), *a[:3],
        JF._subsampled_f2(geom, *a[3:]), luma_shift=luma_shift))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert np.count_nonzero(want) > 0, "the fit must refine some pixels"
    before = (KP.counts.plain, KP.counts.kernel)
    field64 = KP.subpel_refine(offset, *t[:3], *probe, tgeom.res_scalar, h,
                               w, luma_shift)
    assert (KP.counts.plain, KP.counts.kernel) == (before[0] + 1, before[1])
    np.testing.assert_array_equal(field64.numpy(),
                                  (offset.numpy() << 6) + want)


@pytest.mark.parametrize("pixfmt", ["nv12", "p010"])
def test_pyramid_with_subpel_equals_jax(pixfmt):
    w, h = 64, 48
    planes = _clip(w, h, pixfmt, "moving_box")
    luma_shift = 8 if pixfmt == "p010" else 0
    tgeom = TF.FlowGeometry.create(h, w, w)
    t = [torch.from_numpy(p) for p in planes]
    probe = TF.subsampled_f2(tgeom, *t[3:])
    counts = (KS.counts, KP.counts, KB.counts)
    before = [c.plain for c in counts]
    field, b64 = KS.flow_pyramid(*t[:3], *probe, 8, 8, 6,
                                 tgeom.window_schedule(),
                                 TF.FIRST_NEIGHBOR_ITERATION,
                                 tgeom.res_scalar, h, w, luma_shift,
                                 subpel=True)
    # the plain pyramid, S1 and the blur, once each
    assert [c.plain - b for c, b in zip(counts, before)] == [1, 1, 1]
    geom = JF.FlowGeometry.create(h, w, w)
    a = [jnp.asarray(p) for p in planes]
    offset, _ = JF.make_flow_fn(geom, 8, luma_shift)(
        *a, jnp.int32(8), jnp.int32(6))
    frac = JF.subpel_refine(geom, offset, *a[:3],
                            JF._subsampled_f2(geom, *a[3:]),
                            luma_shift=luma_shift)
    want = JF.blur_flow((offset << 6) + frac, geom.low_h, geom.low_w)
    np.testing.assert_array_equal(field.numpy(), np.asarray(offset))
    np.testing.assert_array_equal(b64.numpy(), np.asarray(want))
    assert np.count_nonzero(np.asarray(frac)) > 0


def test_subpel_refine_checks():
    planes = [torch.from_numpy(p) for p in _clip(64, 48, "nv12", "noise")]
    offset = torch.zeros((2, 48, 64), dtype=torch.int32)
    probe = planes[3:]
    with pytest.raises(ValueError, match=r"\(2, lh, lw\)"):
        KP.subpel_refine(offset[0], *planes[:3], *probe, 0, 48, 64)
    with pytest.raises(ValueError, match="luma_shift"):
        KP.subpel_refine(offset, *planes[:3], *probe, 0, 48, 64, 32)
    with pytest.raises(ValueError, match="fit"):
        KP.subpel_refine(offset, *planes[:3], *probe, 1, 48, 64)


def _frac_case(rng, h, w, stride, scale_shift):
    dt = np.uint16 if scale_shift else np.uint8
    top = np.iinfo(dt).max
    planes = [rng.integers(0, top + 1, (rows, stride)).astype(dt)
              for rows in (h, h // 2, h, h // 2)]
    geom = JF.FlowGeometry.create(h, stride, w)
    lh, lw = geom.low_h, geom.low_w
    blur = rng.integers(-12, 13, (2, lh, lw)).astype(np.int32)
    frac = rng.integers(0, 64, (2, lh, lw)).astype(np.int32)
    return geom, planes, blur, frac


@pytest.mark.parametrize("h,w,stride,scale_shift,levels,occlusion", [
    (48, 64, 64, 0, (0.0, 255.0), False), (48, 64, 80, 8, (16.0, 235.0),
                                           True),
    (36, 96, 96, 0, (16.5, 235.0), True)])
def test_bilinear_with_frac_equals_jax(h, w, stride, scale_shift, levels,
                                       occlusion):
    rng = np.random.default_rng(h + stride + scale_shift)
    geom, planes, blur, frac = _frac_case(rng, h, w, stride, scale_shift)
    f1y, f1uv, f2y, f2uv = planes
    a = [jnp.asarray(x) for x in (f1y, f1uv[:, 0::2], f1uv[:, 1::2], f2y,
                                  f2uv[:, 0::2], f2uv[:, 1::2])]
    fields = JW._warp_fields(geom, jnp.asarray(blur), jnp.asarray(frac),
                             full_res=True)
    k_w = TW.level_ints(*levels)
    for t in (0.0, 0.3, 0.77):
        y, u, v = JW._warp_sample(
            geom, JW.BLENDED_FRAME, scale_shift,
            jnp.uint16 if scale_shift else jnp.uint8, *a, fields,
            jnp.float32(t), jnp.float32(levels[0]), jnp.float32(levels[1]),
            occlusion_aware=occlusion, bilinear=True, sampling="gather")
        want = (np.asarray(y), interleave_chroma(np.asarray(u),
                                                 np.asarray(v)))
        args = (*(torch.from_numpy(p) for p in planes),
                torch.from_numpy(blur), torch.tensor(t), geom.res_scalar, w,
                scale_shift, k_w, occlusion)
        got = KQ.bilinear_blend(*args, torch.from_numpy(frac))
        model = q1_model(*planes, blur, t, geom.res_scalar, w, scale_shift,
                         k_w, occlusion, frac)
        for g, r, m in zip(got, want, model):
            np.testing.assert_array_equal(g.numpy(), r)
            np.testing.assert_array_equal(m, r)
        # a zero field is no field
        zero = KQ.bilinear_blend(*args, torch.zeros_like(
            torch.from_numpy(frac)))
        for g, r in zip(zero, KQ.bilinear_blend(*args)):
            assert torch.equal(g, r)


def _engine_pair(model, pixfmt, levels):
    kw = dict(auto_quality=False, measure_timing=False, display_fps=48.0,
              scene_detection=True, initial_search_radius=8, model=model,
              subpel_flow=True, black_level=levels[0], white_level=levels[1])
    return (jax_engine.InterpolationEngine(jax_engine.EngineConfig(
        background_precompile=False, **kw)),
        port_engine.InterpolationEngine(port_engine.EngineConfig(
            device="cpu", **kw)))


def check_subpel_engine(model, pixfmt, levels):
    """The port's engine under subpel_flow against the JAX engine on a
    moving box, a scene cut (which zeroes the flow and the sub-pel field)
    and a pan after it, 96 x 64, with the plain launches a pair (24 -> 48
    fps: t = 0 and 0.5, one JAX program an engine)."""
    cfg = dataclasses.replace(synthetic.SyntheticConfig(
        width=96, height=64, fps=24.0), pixfmt=pixfmt)
    ref, port = _engine_pair(model, pixfmt, levels)
    counts = (KS.counts, KP.counts, KB.counts)
    before = [c.plain for c in counts] + [KB.counts.fused]
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
    assert n == 1 + 2 * 4
    after = [c.plain for c in counts] + [KB.counts.fused]
    # four pairs: the plain pyramid, S1, the blur (on the card: one
    # launch, S1's phases and the blur inside it)
    assert [a - b for a, b in zip(after, before)] == [4, 4, 4, 0]


@pytest.mark.parametrize("model,pixfmt,levels", [
    ("hopperq", "nv12", (0.0, 255.0)), ("hopperxq", "p010", (16.0, 235.0))])
def test_engine_subpel_equals_jax(model, pixfmt, levels):
    check_subpel_engine(model, pixfmt, levels)
