"""Q1's plain version -- ``ops/warp.bilinear_sample`` and
``bilinear_blend``, the hopperq / hopperxq blended position -- against the
JAX package on the CPU with the same seeded numpy inputs:

* ``bilinear_sample`` against ``ops/warp._bilinear_sample`` at positions
  that reach past every edge, negative ones among them;
* ``bilinear_blend`` against ``_warp_sample(..., bilinear=True,
  occlusion_aware=...)`` under ``sampling="gather"`` (``_bilinear_sample``)
  and the shift path (``_bilinear_all_planes``), NV12 and P010 with
  levels (16, 235), t at 0, 0.5, 1 and two odd values, a stride wider
  than the picture and a field with wild displacements;
* ``q1_model`` (``tests/test_torch_cuda.py``: csrc/warp_bilinear.cu's
  arithmetic in NumPy, chroma addressed in the interleaved plane as the
  kernel addresses it) against both;
* why no single PyTorch call is Q1's library yardstick.

Bit-exact throughout (tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from mpv_frame_interpolator_tpu.frame import interleave_chroma
from mpv_frame_interpolator_tpu.ops import warp as JW
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_bilinear as KQ

from test_torch_cuda import q1_model

torch.set_num_threads(1)


def _planes(rng, h, stride, scale_shift):
    dt = np.uint16 if scale_shift else np.uint8
    top = np.iinfo(dt).max
    planes = [rng.integers(0, top + 1, (rows, stride)).astype(dt)
              for rows in (h, h // 2, h, h // 2)]
    planes[0][:2] = top           # rows of the top value (P010: > 2^24
    planes[2][-2:] = 0            # in 1/4096 units) and of 0
    return planes


def _field(rng, geom, lim):
    """Blocks of 4 x 4 cells within +-lim, 5% of the cells wild (4 lim)."""
    lh, lw = geom.low_h, geom.low_w
    f = rng.integers(-lim, lim + 1, (2, -(-lh // 4), -(-lw // 4)))
    f = f.repeat(4, 1).repeat(4, 2)[:, :lh, :lw]
    wild = rng.random((2, lh, lw)) < 0.05
    return np.where(wild, rng.integers(-4 * lim, 4 * lim + 1, (2, lh, lw)),
                    f).astype(np.int32)


def _jax_blend(geom, planes, blur, t, scale_shift, levels, occlusion,
               sampling):
    f1y, f1uv, f2y, f2uv = planes
    a = [jnp.asarray(x) for x in (f1y, f1uv[:, 0::2], f1uv[:, 1::2], f2y,
                                  f2uv[:, 0::2], f2uv[:, 1::2])]
    fields = JW._warp_fields(geom, jnp.asarray(blur),
                             full_res=sampling == "gather")
    y, u, v = JW._warp_sample(
        geom, JW.BLENDED_FRAME, scale_shift,
        jnp.uint16 if scale_shift else jnp.uint8, *a, fields,
        jnp.float32(t), jnp.float32(levels[0]), jnp.float32(levels[1]),
        occlusion_aware=occlusion, bilinear=True, sampling=sampling)
    return np.asarray(y), interleave_chroma(np.asarray(u), np.asarray(v))


def _port_blend(geom, planes, blur, t, scale_shift, levels, occlusion):
    y, uv = KQ.bilinear_blend(
        *(torch.from_numpy(p) for p in planes), torch.from_numpy(blur),
        torch.tensor(t), geom.res_scalar, geom.actual_width, scale_shift,
        TW.level_ints(*levels), occlusion)
    return y.numpy(), uv.numpy()


TS = [0.0, 0.5, 1.0, 0.3, 0.77]


_SHAPES = [(48, 64, 64, 0, (0.0, 255.0)), (48, 64, 80, 8, (16.0, 235.0)),
           (36, 96, 96, 0, (16.5, 235.0))]


# the shift sampler feeds the same blend as the gather path, so it runs
# on one shape with the occlusion correction, at three blend positions
@pytest.mark.parametrize("h,w,stride,scale_shift,levels,occlusion,sampling", [
    (*_SHAPES[0], False, "gather"), (*_SHAPES[1], True, "gather"),
    (*_SHAPES[2], False, "gather"), (*_SHAPES[2], True, "gather"),
    (*_SHAPES[1], True, "shift")])
def test_bilinear_blend_equals_jax(h, w, stride, scale_shift, levels,
                                   occlusion, sampling):
    rng = np.random.default_rng(h + stride + scale_shift)
    geom = FlowGeometry.create(h, stride, w)
    planes = _planes(rng, h, stride, scale_shift)
    blur = _field(rng, geom, 12)
    for t in (TS if sampling == "gather" else TS[1::2]):
        got = _port_blend(geom, planes, blur, t, scale_shift, levels,
                          occlusion)
        want = _jax_blend(geom, planes, blur, t, scale_shift, levels,
                          occlusion, sampling)
        for g, r in zip(got, want):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("occlusion", [True])
def test_bilinear_blend_pyramid_geometry(pyramid_cfg, occlusion):
    """res scalar 2 (a 96 x 544 frame): each flow cell covers 4 x 4 luma
    samples and 4 x 8 interleaved chroma samples."""
    geom = FlowGeometry.create(pyramid_cfg.height, pyramid_cfg.width,
                               pyramid_cfg.width)
    assert geom.res_scalar == 2
    rng = np.random.default_rng(544)
    planes = _planes(rng, geom.height, geom.stride, 0)
    blur = _field(rng, geom, 30)
    for t in ((0.6,) if occlusion else (0.25,)):
        got = _port_blend(geom, planes, blur, t, 0, (0.0, 255.0), occlusion)
        want = _jax_blend(geom, planes, blur, t, 0, (0.0, 255.0), occlusion,
                          "gather")
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("scale_shift", [0, 8])
def test_bilinear_sample_equals_jax(scale_shift):
    rng = np.random.default_rng(scale_shift + 1)
    dt = np.uint16 if scale_shift else np.uint8
    plane = rng.integers(0, np.iinfo(dt).max + 1, (20, 33)).astype(dt)
    # positions from 3 pels before the first sample to 3 past the last,
    # at every 1/64 fraction
    py = rng.integers(-3 * 64, 23 * 64, (40, 50)).astype(np.int32)
    px = rng.integers(-3 * 64, 36 * 64, (40, 50)).astype(np.int32)
    got = TW.bilinear_sample(torch.from_numpy(plane), torch.from_numpy(py),
                             torch.from_numpy(px), 20, 33)
    want = JW._bilinear_sample(jnp.asarray(plane), jnp.asarray(py),
                               jnp.asarray(px), 20, 33)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale_shift,levels,occlusion", [
    (0, (0, 255), False), (8, (16, 235), True)])
def test_kernel_model_equals_the_plain_version_and_jax(scale_shift, levels,
                                                       occlusion):
    """Q1's float order, modelled sample by sample in NumPy: int -> float
    rounded to nearest even (P010's q reaches 65535 * 4096 > 2^24), one
    rounding a product and a sum, floor(x + 0.5)."""
    rng = np.random.default_rng(7 + scale_shift)
    geom = FlowGeometry.create(48, 80, 64)
    planes = _planes(rng, 48, 80, scale_shift)
    blur = _field(rng, geom, 40)
    for t in TS:
        model = q1_model(*planes, blur, t, geom.res_scalar, 64, scale_shift,
                         levels, occlusion)
        plain = _port_blend(geom, planes, blur, t, scale_shift, levels,
                            occlusion)
        ref = _jax_blend(geom, planes, blur, t, scale_shift, levels,
                         occlusion, "gather")
        for m, p, r in zip(model, plain, ref):
            np.testing.assert_array_equal(m, p)
            np.testing.assert_array_equal(m, r)


def test_occlusion_adjust_equals_jax():
    rng = np.random.default_rng(3)
    for scale_shift, top in ((0, 255), (8, 65535)):
        s12 = rng.integers(0, top + 1, (6, 40)).astype(np.int32)
        s21 = rng.integers(0, top + 1, (6, 40)).astype(np.int32)
        blended = (s12 + s21) // 2
        for t in (0.2, 0.5, 0.8):
            got = TW.occlusion_adjust(torch.from_numpy(blended),
                                      torch.from_numpy(s12),
                                      torch.from_numpy(s21),
                                      torch.tensor(t), scale_shift)
            want = JW._occlusion_adjust(jnp.asarray(blended),
                                        jnp.asarray(s12), jnp.asarray(s21),
                                        jnp.float32(t), scale_shift)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grid_sample_is_not_this_function():
    """Why Q1's library column is "none": grid_sample's bilinear mode
    weighs the taps in float (Q1 rounds the position to 1/64 pel and sums
    in 1/4096 units) and reflects at the edge without mirror_edge2's
    clamp into [1, dim - 2]."""
    def bilinear(row, x_pix):
        src = torch.tensor(row, dtype=torch.float32).reshape(1, 1, 1, -1)
        g = torch.tensor([[[[2 * x_pix / (len(row) - 1) - 1, 0.0]]]])
        return F.grid_sample(src, g, mode="bilinear",
                             padding_mode="reflection",
                             align_corners=True).item()

    row = [0, 0, 0, 255, 0, 0, 0, 0]
    # a third of a pel past column 2: float weights give 85; Q1 samples
    # at 2 + 21/64 pel, 255 * 21 * 64 / 4096 = 83.67, which rounds to 84
    assert bilinear(row, 2 + 1 / 3) == pytest.approx(85.0)
    plane = torch.tensor([row] * 3, dtype=torch.uint8)
    q = TW.bilinear_sample(plane, torch.tensor([64]),
                           torch.tensor([2 * 64 + 21]), 3, 8)
    assert int(q) == 255 * 21 * 64
    assert int(np.floor(np.float32(int(q)) / 4096 + 0.5)) == 84
    # column -1: mirror_edge2 maps it to 2, reflection padding to 1
    assert int(TW.mirror_edge2(torch.tensor(-1), 8)) == 2
    assert bilinear(list(range(8)), -1.0) == pytest.approx(1.0)


def test_counts_and_checks_on_the_cpu():
    rng = np.random.default_rng(0)
    geom = FlowGeometry.create(48, 64, 64)
    planes = [torch.from_numpy(p) for p in _planes(rng, 48, 64, 0)]
    blur = torch.from_numpy(_field(rng, geom, 3))
    t = torch.tensor(0.4)
    before = (KQ.counts.kernel, KQ.counts.plain)
    KQ.bilinear_blend(*planes, blur, t, 0, 64)
    assert (KQ.counts.kernel, KQ.counts.plain) == (before[0], before[1] + 1)
    with pytest.raises(ValueError):          # uint8 planes under P010
        KQ.bilinear_blend(*planes, blur, t, 0, 64, 8)
    with pytest.raises(ValueError):          # an odd width
        KQ.bilinear_blend(*planes, blur, t, 0, 63)
    with pytest.raises(ValueError):          # a vector of positions
        KQ.bilinear_blend(*planes, blur, torch.tensor([0.2, 0.4]), 0, 64)
