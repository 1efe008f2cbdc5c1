"""K2: the port's pair blend (plain PyTorch path) against the JAX
package's Pallas pair kernel in interpret mode
(warp_pair.blended_pair_from_prep, as tests/test_warp_pair.py runs it) and
against make_warp_batch_fn(geom, BLENDED_FRAME) re-interleaved to NV12.
Bit-exact: zero flow, several flow values, large displacements, the
blend positions 0, .25, .5, .9999 and a stride wider than the picture."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpv_frame_interpolator_tpu.ops import oracle
from mpv_frame_interpolator_tpu.ops import warp as W
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry
from mpv_frame_interpolator_tpu.ops.pallas import warp_pair as WP
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as TW

torch.set_num_threads(1)

TS = [0.0, 0.25, 0.5, 0.9999]


def _frames(rng, h, stride):
    y = [rng.integers(0, 256, (h, stride)).astype(np.uint8)
         for _ in range(2)]
    uv = [rng.integers(0, 256, (h // 2, stride)).astype(np.uint8)
          for _ in range(2)]
    return y, uv


def _blurred(rng, geom, values):
    pick = rng.integers(0, len(values), (geom.low_h, geom.low_w))
    ox = np.array([v[0] for v in values], np.int32)[pick]
    oy = np.array([v[1] for v in values], np.int32)[pick]
    return np.stack([ox, oy])


def _port(geom, y, uv, blurred, ts):
    t = [torch.from_numpy(p) for p in (y[0], uv[0], y[1], uv[1])]
    out = TW.pair_blend(*t, torch.from_numpy(blurred),
                        torch.tensor(ts, dtype=torch.float32),
                        geom.res_scalar, geom.actual_width)
    return out[0].numpy(), out[1].numpy()


def _planar(y, uv):
    return (jnp.asarray(y), jnp.asarray(uv[:, 0::2]),
            jnp.asarray(uv[:, 1::2]))


def _batch_ref(geom, y, uv, blurred, ts):
    fn = W.make_warp_batch_fn(geom, W.BLENDED_FRAME)
    ry, ru, rv = fn(*_planar(y[0], uv[0]), *_planar(y[1], uv[1]),
                    jnp.asarray(blurred), jnp.asarray(ts, jnp.float32),
                    jnp.float32(0.0), jnp.float32(255.0))
    n, hc, wc = ru.shape
    ruv = np.stack([np.asarray(ru), np.asarray(rv)], axis=3)
    return np.asarray(ry), ruv.reshape(n, hc, wc * 2)


def _run(h, w, values, ts, seed=0, stride=None, pallas=True):
    stride = stride or w
    geom = FlowGeometry.create(h, stride, w)
    rng = np.random.default_rng(seed)
    y, uv = _frames(rng, h, stride)
    blurred = _blurred(rng, geom, values)
    got_y, got_uv = _port(geom, y, uv, blurred, ts)
    assert got_y.shape == (len(ts), h, w)
    assert got_uv.shape == (len(ts), h // 2, w)

    ref_y, ref_uv = _batch_ref(geom, y, uv, blurred, ts)
    np.testing.assert_array_equal(got_y, ref_y)
    np.testing.assert_array_equal(got_uv, ref_uv)

    if pallas:
        f1, f2 = _planar(y[0], uv[0]), _planar(y[1], uv[1])
        fields = W._warp_fields(geom, jnp.asarray(blurred))
        prep = W._sampler_prep(geom, fields, *f1, *f2, fused=True)
        assert bool(prep["ok"]), "field must stay inside the TPU gates"
        p_y, p_uv = WP.blended_pair_from_prep(
            geom, prep, jnp.asarray(ts, jnp.float32), 0)
        np.testing.assert_array_equal(got_y, np.asarray(p_y))
        np.testing.assert_array_equal(got_uv, np.asarray(p_uv))
    return geom, y, uv, blurred, got_y, got_uv


def test_zero_flow():
    _run(64, 96, [(0, 0)], TS)


def test_multi_value_flow():
    _run(64, 96, [(0, 0), (1, 0), (-1, 2), (3, -2), (-5, -7)], TS, seed=1)


def test_large_displacements():
    _run(96, 128, [(40, -60), (-80, 33), (127, 127)], TS, seed=2)


def test_many_positions():
    _run(64, 96, [(1, 1), (-2, 4)], list(np.linspace(0.1, 0.9, 7)),
         seed=3)


def test_stride_wider_than_width():
    _run(48, 64, [(3, -1), (-6, 2)], TS, seed=4, stride=80, pallas=False)


def test_res_scalar_pyramid_geometry():
    # 544 rows -> res_scalar 2: the flow is read at (y >> 2, x >> 2)
    _run(544, 96, [(8, -4), (-12, 16), (0, 0)], [0.2, 0.6], seed=5,
         pallas=False)


def test_matches_the_oracle():
    geom, y, uv, blurred, got_y, got_uv = _run(
        48, 64, [(5, -3), (-9, 7), (0, 2)], TS, seed=6, pallas=False)
    for n, t in enumerate(TS):
        ry, ruv = oracle.warp_frame(y[0], uv[0], y[1], uv[1], blurred, t,
                                    oracle.BLENDED_FRAME, geom.res_scalar,
                                    geom.actual_width)
        np.testing.assert_array_equal(got_y[n], ry)
        np.testing.assert_array_equal(got_uv[n], ruv)


def test_rejects_bad_width():
    geom = FlowGeometry.create(48, 64, 64)
    rng = np.random.default_rng(0)
    y, uv = _frames(rng, 48, 64)
    with pytest.raises(ValueError):
        t = [torch.from_numpy(p) for p in (y[0], uv[0], y[1], uv[1])]
        TW.pair_blend(*t, torch.zeros((2, geom.low_h, geom.low_w),
                                      dtype=torch.int32),
                      torch.zeros(1), 0, 65)
