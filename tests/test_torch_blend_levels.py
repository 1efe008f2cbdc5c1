"""G1, the blend and level maps of one blend position (plain PyTorch path),
against the JAX package's ``ops/warp._blend_fix`` followed by
``_levels_y_rt`` / ``_levels_uv_rt`` -- the XLA fusion G1 replaces --
and a NumPy model of the kernel's own arithmetic (the blend in wrapping
uint32, the level maps in int32).  Bit-exact (tolerance 0) at NV12 and
P010, the default levels, (16.5, 235) and a white level of 1, blend
positions 0, 0.4, 0.5, 1 and two whose t * 2^frac ties at .5, with
samples at 0 and at the top of the range."""

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


def _jax(planes, t, scale_shift, black, white):
    s12y, s12uv, s21y, s21uv = (jnp.asarray(p) for p in planes)
    tt = jnp.float32(t)
    b_y = JW._blend_fix(s12y, s21y, tt, scale_shift)
    b_uv = JW._blend_fix(s12uv, s21uv, tt, scale_shift)
    return (np.asarray(JW._levels_y_rt(b_y, jnp.float32(black),
                                       jnp.float32(white), scale_shift)),
            np.asarray(JW._levels_uv_rt(b_uv, jnp.float32(white),
                                        scale_shift)))


def _port(planes, t, scale_shift, black, white):
    tp = [torch.from_numpy(p) for p in planes]
    y, uv = KG.blend_levels(*tp, torch.tensor(t, dtype=torch.float32),
                            scale_shift, TW.level_ints(black, white))
    return y.numpy(), uv.numpy()


def _kernel_model(planes, t, scale_shift, black, white):
    """csrc/blend_levels.cu's arithmetic in NumPy: T from one float32
    product rounded half to even; the blend in uint32, which wraps (it
    never does); the level maps in int32 with C's truncating division of
    positive numerators and the clip shortcut at the default levels."""
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

    b_y, b_uv = blend(s12y, s21y), blend(s12uv, s21uv)
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
