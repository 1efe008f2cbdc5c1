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
