"""K3: the port's flow blur (plain PyTorch path) against the JAX package's
ops/flow.blur_flow and the Pallas kernel blur_flow_pallas in interpret
mode.  Bit-exact, including negative values (truncating division) and
planes smaller than the tap reach (symmetric padding reflects again)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpv_frame_interpolator_tpu.ops import flow as F
from mpv_frame_interpolator_tpu.ops import oracle
from mpv_frame_interpolator_tpu.ops.pallas.blur import blur_flow_pallas
from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as TB

torch.set_num_threads(1)


def _field(seed, lh, lw, lo=-300, hi=300):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (2, lh, lw)).astype(np.int32)


def _port(off):
    return TB.blur_flow(torch.from_numpy(off)).numpy()


@pytest.mark.parametrize("lh,lw", [(24, 32), (17, 45), (68, 24),
                                   (270 // 9, 480 // 9)])
def test_matches_xla_and_pallas(lh, lw):
    off = _field(lh * 1000 + lw, lh, lw)
    got = _port(off)
    np.testing.assert_array_equal(
        got, np.asarray(F.blur_flow(jnp.asarray(off), lh, lw)))
    np.testing.assert_array_equal(
        got, np.asarray(blur_flow_pallas(jnp.asarray(off), lh, lw,
                                         interpret=True)))


@pytest.mark.parametrize("lh,lw", [(1, 1), (2, 3), (3, 2), (1, 7), (5, 1)])
def test_dims_below_four(lh, lw):
    off = _field(lh * 10 + lw, lh, lw)
    np.testing.assert_array_equal(
        _port(off), np.asarray(F.blur_flow(jnp.asarray(off), lh, lw)))


def test_negative_values_truncate_toward_zero():
    # one -63 in a zero field: every window sum is -63 or 0, which
    # truncates to 0 (a floor division would give -1)
    off = np.zeros((2, 9, 9), np.int32)
    off[:, 4, 4] = -63
    assert (_port(off) == 0).all()
    off = _field(7, 9, 9, lo=-40, hi=5)
    np.testing.assert_array_equal(_port(off), oracle.blur_flow(off))


def test_symmetric_index_matches_numpy_pad():
    for n in range(1, 9):
        idx = TB.symmetric_index(n, 4, "cpu").numpy()
        ref = np.pad(np.arange(n), (4, 4), mode="symmetric")
        np.testing.assert_array_equal(idx, ref)


def _symmetric(i, n):
    """blur_tile.cuh's symmetric(): the periodic reflection, period 2n."""
    j = i % (2 * n)
    return np.where(j >= n, 2 * n - 1 - j, j)


def _tile_model(off):
    """csrc/blur_tile.cuh in NumPy, tile by tile: the 15 x 39 window of
    both planes (reflected only in a tile the kernel takes for an edge
    tile, and in range in every other), 8 taps along each window row in
    wrapping uint32, then 8 down each column, truncated division by 64."""
    _, lh, lw = off.shape
    out = np.zeros_like(off)
    for y0 in range(0, lh, 8):
        for x0 in range(0, lw, 32):
            edge = x0 < 4 or y0 < 4 or x0 + 35 > lw or y0 + 11 > lh
            gy, gx = np.arange(y0 - 4, y0 + 11), np.arange(x0 - 4, x0 + 35)
            if edge:
                gy, gx = _symmetric(gy, lh), _symmetric(gx, lw)
            assert 0 <= gy.min() and gy.max() < lh
            assert 0 <= gx.min() and gx.max() < lw
            win = off[:, gy][:, :, gx].astype(np.uint32)
            rows = sum(win[:, :, k:k + 32] for k in range(8))
            acc = sum(rows[:, k:k + 8] for k in range(8)).view(np.int32)
            q = (np.abs(acc.astype(np.int64)) // 64) * np.sign(acc)
            h, w = min(8, lh - y0), min(32, lw - x0)
            out[:, y0:y0 + h, x0:x0 + w] = q[:, :h, :w]
    return out


@pytest.mark.parametrize("lh,lw", [(1, 1), (2, 3), (3, 2), (1, 7), (5, 1),
                                   (17, 45), (19, 67), (18, 66), (68, 24),
                                   (270, 480)])
def test_tile_model_equals_the_plain_version(lh, lw):
    off = _field(lh + lw, lh, lw)
    np.testing.assert_array_equal(_tile_model(off), _port(off))


def test_tile_model_wraps_like_the_plain_version():
    rng = np.random.default_rng(3)
    off = rng.integers(-2 ** 31, 2 ** 31, (2, 19, 67)).astype(np.int32)
    np.testing.assert_array_equal(_tile_model(off), _port(off))
    np.testing.assert_array_equal(
        _port(off), np.asarray(F.blur_flow(jnp.asarray(off), 19, 67)))


def test_counts_on_the_cpu():
    before = (TB.counts.kernel, TB.counts.plain, TB.counts.fused)
    _port(_field(0, 9, 9))
    assert (TB.counts.kernel, TB.counts.plain, TB.counts.fused) == (
        before[0], before[1] + 1, before[2])
    with pytest.raises(ValueError):
        TB.blur_flow(torch.zeros((3, 9, 9), dtype=torch.int32))
