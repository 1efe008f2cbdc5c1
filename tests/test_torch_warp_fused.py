"""K4: the port's fused blend (plain PyTorch path) against the JAX
package's fused Pallas kernel in interpret mode (warp_fused.
blended_from_prep, as tests/test_warp_fused.py runs it), on that file's
five cases: one flow value at res scalar 0, several at res scalar 2, the
blend-position endpoints 0 and 1, P010 (scale_shift 8) and fifteen flow
values.  The TPU kernel covers the default levels only (the JAX engine
hands other levels to XLA), so the port's kernel with levels is held
against the JAX package's XLA warp (_warp_sample), which is what the JAX
engine runs for them.  Bit-exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpv_frame_interpolator_tpu.ops import warp as W
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry
from mpv_frame_interpolator_tpu.ops.pallas import warp_fused as WF
from mpv_frame_interpolator_tpu_torch.ops import warp as TWO
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as TF

torch.set_num_threads(1)


def _case(h, w, values, seed, scale_shift):
    """Planar JAX planes, the port's interleaved planes and the flow, from
    a numpy seed (as tests/test_warp_fused.py draws them)."""
    geom = FlowGeometry.create(h, w, w)
    rng = np.random.default_rng(seed)
    dt = np.uint16 if scale_shift else np.uint8
    hi = 1 << 16 if scale_shift else 256

    def planes():
        return (rng.integers(0, hi, (h, w)).astype(dt),
                rng.integers(0, hi, (h // 2, w // 2)).astype(dt),
                rng.integers(0, hi, (h // 2, w // 2)).astype(dt))

    f1, f2 = planes(), planes()
    pick = rng.integers(0, len(values), (geom.low_h, geom.low_w))
    blurred = np.stack([np.array([v[0] for v in values], np.int32)[pick],
                        np.array([v[1] for v in values], np.int32)[pick]])
    return geom, f1, f2, blurred


def _interleave(u, v):
    uv = np.empty((u.shape[0], u.shape[1] * 2), u.dtype)
    uv[:, 0::2], uv[:, 1::2] = u, v
    return uv


def _port(geom, f1, f2, blurred, t, scale_shift, levels=(0, 255)):
    args = [torch.from_numpy(np.ascontiguousarray(p)) for p in (
        f1[0], _interleave(f1[1], f1[2]), f2[0], _interleave(f2[1], f2[2]))]
    before = TF.counts.plain
    y, uv = TF.fused_blend(*args, torch.from_numpy(blurred),
                           torch.tensor(t, dtype=torch.float32),
                           geom.res_scalar, geom.actual_width, scale_shift,
                           levels)
    assert TF.counts.plain == before + 1
    assert y.dtype == uv.dtype == (torch.uint16 if scale_shift
                                   else torch.uint8)
    return y.numpy(), uv.numpy()


def _jax_prep(geom, f1, f2, blurred):
    jf1 = [jnp.asarray(p) for p in f1]
    jf2 = [jnp.asarray(p) for p in f2]
    fields = W._warp_fields(geom, jnp.asarray(blurred))
    prep = W._sampler_prep(geom, fields, *jf1, *jf2, fused=True)
    assert bool(prep["ok"]), "test field must stay inside the shift gates"
    fields["SPREP"] = prep
    return jf1, jf2, fields, prep


def _run(h, w, values, t, seed=0, scale_shift=0):
    geom, f1, f2, blurred = _case(h, w, values, seed, scale_shift)
    got_y, got_uv = _port(geom, f1, f2, blurred, t, scale_shift)
    _, _, _, prep = _jax_prep(geom, f1, f2, blurred)
    y_f, uv_f = WF.blended_from_prep(geom, prep, jnp.float32(t), scale_shift)
    np.testing.assert_array_equal(got_y, np.asarray(y_f))
    np.testing.assert_array_equal(got_uv, np.asarray(uv_f))


def test_single_value_rs0():
    _run(256, 512, [(3, -2)], t=0.5)


def test_multi_value_rs2():
    _run(544, 1024, [(0, 0), (5, 2), (-7, 3), (12, -9)], t=0.25, seed=1)


@pytest.mark.parametrize("t,seed", [(0.0, 2), (1.0, 3)])
def test_endpoint_t(t, seed):
    # cadence cuts snap t to 0/1: weights 2^24/0 pass the sources through
    _run(544, 1024, [(2, 1), (-3, 4)], t=t, seed=seed)


def test_p010_scale_shift():
    _run(544, 1024, [(1, -1), (6, 6)], t=0.4, seed=4, scale_shift=8)


def test_many_values_rs2():
    vals = [(x, y) for x in (-9, -3, 0, 4, 11) for y in (-5, 0, 7)]
    _run(544, 1024, vals, t=0.6, seed=5)


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("black,white", [(16.0, 235.0), (16.5, 235.5)])
def test_levels_against_the_xla_warp(scale_shift, black, white):
    geom, f1, f2, blurred = _case(96, 128, [(1, -1), (6, 6), (-4, 2)], 6,
                                  scale_shift)
    levels = TWO.level_ints(black, white)
    got_y, got_uv = _port(geom, f1, f2, blurred, 0.4, scale_shift, levels)
    jf1, jf2, fields, _ = _jax_prep(geom, f1, f2, blurred)
    y_r, u_r, v_r = W._warp_sample(
        geom, W.BLENDED_FRAME, scale_shift,
        jnp.uint16 if scale_shift else jnp.uint8, *jf1, *jf2, fields,
        jnp.float32(0.4), jnp.float32(black), jnp.float32(white),
        sampling="shift")
    np.testing.assert_array_equal(got_y, np.asarray(y_r))
    np.testing.assert_array_equal(
        got_uv, _interleave(np.asarray(u_r), np.asarray(v_r)))


def test_rejects_a_vector_of_positions():
    geom, f1, f2, blurred = _case(48, 64, [(1, 1)], 0, 0)
    args = [torch.from_numpy(np.ascontiguousarray(p)) for p in (
        f1[0], _interleave(f1[1], f1[2]), f2[0], _interleave(f2[1], f2[2]))]
    with pytest.raises(ValueError, match="one blend position"):
        TF.fused_blend(*args, torch.from_numpy(blurred),
                       torch.tensor([0.2, 0.4]), geom.res_scalar, 64)
