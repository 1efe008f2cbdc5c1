"""G1, the blend and level maps of one blend position (plain PyTorch path),
against the JAX package's ``ops/warp._blend_fix`` followed by
``_levels_y_rt`` / ``_levels_uv_rt`` -- the XLA fusion G1 replaces --
and a NumPy model of the kernel's own arithmetic (the blend in wrapping
uint32, the level maps in int32).  Bit-exact (tolerance 0) at NV12 and
P010, the default levels, (16.5, 235) and a white level of 1, blend
positions 0, 0.4, 0.5, 1 and two whose t * 2^frac ties at .5, with
samples at 0 and at the top of the range.  The hopperx variant (the
occlusion correction between the blend and the levels) is held against
``_blend_fix`` + ``_occlusion_adjust`` + the level maps the same way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.ops import warp as JW
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.ops.cuda import blend_levels as KG

torch.set_num_threads(1)

LEVELS = [(0.0, 255.0), (16.5, 235.0), (0.0, 1.0), (16.0, 1.0)]


def _ties(scale_shift):
    """Two t whose product with 2^frac is exactly n + 0.5 in float32: one
    rounds down to even, the other up."""
    frac = TW.blend_fraction_bits(scale_shift)
    return [float(np.float32((2 ** (frac - 1) + odd) / 2 ** (frac + 1)))
            for odd in (1, 3)]


def _ts(scale_shift):
    return [0.0, 0.4, 0.5, 1.0] + _ties(scale_shift)


def _samples(seed, scale_shift, h=6, w=40):
    """(s12y, s12uv, s21y, s21uv) numpy planes: random samples with rows
    of 0 and of the top value, in every pairing of the two directions."""
    dt = np.uint16 if scale_shift else np.uint8
    top = np.iinfo(dt).max
    rng = np.random.default_rng(seed)
    planes = []
    for rows in (h, h // 2, h, h // 2):
        p = rng.integers(0, top + 1, (rows, w)).astype(dt)
        p[0, :w // 2] = 0
        p[0, w // 2:] = top
        planes.append(p)
    # the other direction's first row crosses both ends
    planes[2][0, :w // 4] = top
    planes[2][0, w // 4:w // 2] = 0
    planes[3][0] = planes[2][0]
    planes[0][1:3], planes[2][1:3] = top, top
    return planes


def _jax(planes, t, scale_shift, black, white, occlusion=False):
    s12y, s12uv, s21y, s21uv = (jnp.asarray(p) for p in planes)
    tt = jnp.float32(t)
    b_y = JW._blend_fix(s12y, s21y, tt, scale_shift)
    b_uv = JW._blend_fix(s12uv, s21uv, tt, scale_shift)
    if occlusion:
        b_y = JW._occlusion_adjust(b_y, s12y, s21y, tt, scale_shift)
        b_uv = JW._occlusion_adjust(b_uv, s12uv, s21uv, tt, scale_shift)
    return (np.asarray(JW._levels_y_rt(b_y, jnp.float32(black),
                                       jnp.float32(white), scale_shift)),
            np.asarray(JW._levels_uv_rt(b_uv, jnp.float32(white),
                                        scale_shift)))


def _port(planes, t, scale_shift, black, white, occlusion=False):
    tp = [torch.from_numpy(p) for p in planes]
    y, uv = KG.blend_levels(*tp, torch.tensor(t, dtype=torch.float32),
                            scale_shift, TW.level_ints(black, white),
                            occlusion)
    return y.numpy(), uv.numpy()


def _kernel_model(planes, t, scale_shift, black, white, occlusion=False):
    """csrc/blend_levels.cu's arithmetic in NumPy: T from one float32
    product rounded half to even; the blend in uint32, which wraps (it
    never does); for hopperx the occlusion correction in int32 on the raw
    samples, toward s12 where t < 0.5; the level maps in int32 with C's
    truncating division of positive numerators and the clip shortcut at
    the default levels."""
    frac = TW.blend_fraction_bits(scale_shift)
    one = np.float32(1 << frac)
    tw = np.uint32(np.clip(np.rint(np.float32(t) * one), 0, one))
    w1 = np.uint32(1 << frac) - tw
    k, w = TW.level_ints(black, white)
    cap = np.int32(255 << scale_shift)
    s12y, s12uv, s21y, s21uv = planes

    def blend(a, b):
        with np.errstate(over="ignore"):
            acc = a.astype(np.uint32) * w1 + b.astype(np.uint32) * tw
        return (acc >> np.uint32(frac)).astype(np.int32)

    def divide(n, d):
        return np.where(n <= 0, 0, np.minimum(np.maximum(n, 0) // d, cap))

    def occlude(b, a, c):
        a, c = a.astype(np.int32), c.astype(np.int32)
        near = a if np.float32(t) < np.float32(0.5) else c
        al = np.clip(((np.abs(a - c) >> scale_shift) - 32) * 4, 0, 256)
        return (b * (256 - al) + near * al) >> 8

    b_y, b_uv = blend(s12y, s21y), blend(s12uv, s21uv)
    if occlusion:
        b_y, b_uv = occlude(b_y, s12y, s21y), occlude(b_uv, s12uv, s21uv)
    if (k, w) == (0, 255):
        y = np.minimum(b_y, cap)
    else:
        y = divide((b_y - np.int32(k << scale_shift)) * np.int32(255),
                   np.int32(max(w - k, 1)))
    if w == 255:
        uv = np.minimum(b_uv, cap)
    else:
        d = np.int32(max(w, 1))
        m = np.int32(128 << scale_shift)
        uv = divide((b_uv - m) * np.int32(255) + m * d, d)
    dt = s12y.dtype
    return y.astype(dt), uv.astype(dt)


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("black,white", LEVELS)
def test_plain_equals_the_jax_blend_and_levels(scale_shift, black, white):
    planes = _samples(int(black + white) + scale_shift, scale_shift)
    for t in _ts(scale_shift):
        got = _port(planes, t, scale_shift, black, white)
        want = _jax(planes, t, scale_shift, black, white)
        for g, r in zip(got, want):
            assert g.dtype == planes[0].dtype and g.shape == r.shape
            np.testing.assert_array_equal(g.astype(np.int64),
                                          r.astype(np.int64))


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("black,white", LEVELS)
def test_kernel_arithmetic_equals_the_plain_version(scale_shift, black,
                                                    white):
    planes = _samples(int(black * 2 + white) + scale_shift, scale_shift)
    for t in _ts(scale_shift):
        got = _kernel_model(planes, t, scale_shift, black, white)
        want = _port(planes, t, scale_shift, black, white)
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("black,white", LEVELS[:2])
def test_occlusion_variant_equals_the_jax_ops(scale_shift, black, white):
    """G1 with the hopperx correction (plain path) against _blend_fix +
    _occlusion_adjust + the level maps, and the kernel's arithmetic
    against the plain path; the sample planes disagree by the whole range
    in rows 0-2, so the ramp reaches both ends."""
    planes = _samples(7 + int(black) + scale_shift, scale_shift)
    for t in _ts(scale_shift) + [0.4999, 0.6]:
        got = _port(planes, t, scale_shift, black, white, True)
        want = _jax(planes, t, scale_shift, black, white, True)
        model = _kernel_model(planes, t, scale_shift, black, white, True)
        for g, r, m in zip(got, want, model):
            np.testing.assert_array_equal(g.astype(np.int64),
                                          r.astype(np.int64))
            np.testing.assert_array_equal(g, m)


def test_occlusion_moves_the_blend_toward_the_nearer_source():
    s12 = torch.tensor([[0, 0, 100, 200]])
    s21 = torch.tensor([[255, 90, 100, 0]])
    blended = torch.tensor([[128, 45, 100, 100]])
    for t, near in ((0.3, s12), (0.7, s21)):
        got = TW.occlusion_adjust(blended, s12, s21, torch.tensor(t))
        # |d| = 255 and 200 snap to the nearer source; 90 is a ramp of
        # (90 - 32) * 4 = 232 / 256; equal samples keep the blend
        assert got[0, 0] == near[0, 0] and got[0, 3] == near[0, 3]
        assert got[0, 1] == (45 * 24 + int(near[0, 1]) * 232) >> 8
        assert got[0, 2] == 100


@pytest.mark.parametrize("scale_shift", [0, 8])
def test_ties_round_half_to_even(scale_shift):
    frac = TW.blend_fraction_bits(scale_shift)
    down, up = _ties(scale_shift)
    _, T = TW.blend_weights(torch.tensor([down, up]), scale_shift)
    assert T.tolist() == [2 ** (frac - 2), 2 ** (frac - 2) + 2]


def test_the_weighted_sum_fits_uint32():
    for scale_shift, top in ((0, 255), (8, 65535)):
        assert top << TW.blend_fraction_bits(scale_shift) < 2 ** 32


def test_counts_and_checks_on_the_cpu():
    planes = [torch.from_numpy(p) for p in _samples(1, 0)]
    t = torch.tensor(0.4)
    before = (KG.counts.kernel, KG.counts.plain)
    KG.blend_levels(*planes, t)
    assert (KG.counts.kernel, KG.counts.plain) == (before[0], before[1] + 1)
    with pytest.raises(ValueError):      # uint8 samples under P010
        KG.blend_levels(*planes, t, 8)
    with pytest.raises(ValueError):      # a vector of positions
        KG.blend_levels(*planes, torch.tensor([0.2, 0.4]))
    with pytest.raises(ValueError):      # chroma rows that do not halve
        KG.blend_levels(planes[0], planes[0], planes[2], planes[3], t)
