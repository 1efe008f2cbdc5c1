"""The port's whole flow (pyramid + blur, plain PyTorch path) against the
JAX package's make_flow_fn and the NumPy oracle, offset and blurred field
both.  Bit-exact at 64x48 (res_scalar 0) and 96x544 (res_scalar 2),
radius 5 and 16, plus a noise clip, delta-scalar variants and a stride
wider than the picture."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.frame import split_chroma
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops import oracle
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry, make_flow_fn
from mpv_frame_interpolator_tpu_torch.ops import flow as TF
from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS

torch.set_num_threads(1)


def _pair(cfg, source):
    gen = getattr(synthetic, source)(cfg, 2)
    return next(gen), next(gen)


def _planes(frame):
    u, v = split_chroma(frame.uv)
    return frame.y, np.ascontiguousarray(u), np.ascontiguousarray(v)


def _port(geom, f1, f2, radius, ds, nbs):
    t = [torch.from_numpy(p) for p in (*_planes(f1), *_planes(f2))]
    off, blurred = TF.flow(geom, *t, radius, ds, nbs)
    assert off.dtype == blurred.dtype == torch.int32
    return off.numpy(), blurred.numpy()


def _jax(geom, f1, f2, radius, ds, nbs):
    fn = make_flow_fn(geom, radius)
    off, blurred = fn(*(jnp.asarray(p) for p in (*_planes(f1),
                                                  *_planes(f2))),
                      jnp.int32(ds), jnp.int32(nbs))
    return np.asarray(off), np.asarray(blurred)


def _check(cfg, source, radius, ds=8, nbs=6, oracle_too=False):
    f1, f2 = _pair(cfg, source)
    geom = FlowGeometry.create(f1.fmt.height, f1.fmt.stride, f1.fmt.width)
    port_geom = TF.FlowGeometry.create(f1.fmt.height, f1.fmt.stride,
                                       f1.fmt.width)
    got = _port(port_geom, f1, f2, radius, ds, nbs)
    want = _jax(geom, f1, f2, radius, ds, nbs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if oracle_too:
        off, blurred = oracle.calculate_optical_flow(
            f1.y, f1.uv, f2.y, f2.uv, radius, geom.res_scalar, geom.low_h,
            geom.low_w, ds, nbs)
        np.testing.assert_array_equal(got[0], off)
        np.testing.assert_array_equal(got[1], blurred)
    return geom, got


@pytest.mark.parametrize("radius", [5, 16])
def test_small_geometry(small_cfg, radius):
    geom, (off, _) = _check(small_cfg, "moving_box", radius,
                            oracle_too=True)
    assert geom.res_scalar == 0
    assert off.any(), "the moving box must produce some flow"


@pytest.mark.parametrize("radius", [5, 16])
def test_res_scalar_pyramid(pyramid_cfg, radius):
    geom, _ = _check(pyramid_cfg, "gradient_pan", radius)
    assert geom.res_scalar == 2


def test_noise(small_cfg):
    _check(small_cfg, "noise", 16)


@pytest.mark.parametrize("ds,nbs", [(0, 0), (31, 31)])
def test_delta_scalar_variants(small_cfg, ds, nbs):
    """ds=nbs=31 makes the uint32 partials wrap."""
    _check(small_cfg, "gradient_pan", 8, ds, nbs)


def test_stride_wider_than_width(small_cfg):
    cfg = dataclasses.replace(small_cfg, stride=80)
    _check(cfg, "moving_box", 16, oracle_too=True)


def test_rejects_radius_above_16(small_cfg):
    """The flow refused every radius above 16 until the kernel took
    16-layer chunks; now radius 17 equals the JAX package's flow and the
    oracle's, and what it refuses is what the JAX engine refuses: radii
    outside [2, 256]."""
    _check(small_cfg, "moving_box", 17, oracle_too=True)
    f1, f2 = _pair(small_cfg, "moving_box")
    geom = TF.FlowGeometry.create(48, 64, 64)
    for radius in (1, 257):
        with pytest.raises(ValueError, match="radius"):
            _port(geom, f1, f2, radius, 8, 6)


def test_cpu_flow_composes_the_plain_pyramid_and_blur(small_cfg):
    """On the CPU the flow is the plain pyramid, then the plain blur; the
    fused blur's counter (the blur phase of the card's pyramid launch)
    does not move."""
    before = (KS.counts.kernel, KS.counts.plain, KB.counts.kernel,
              KB.counts.plain, KB.counts.fused)
    _check(small_cfg, "moving_box", 16)
    assert (KS.counts.kernel, KS.counts.plain, KB.counts.kernel,
            KB.counts.plain, KB.counts.fused) == (
        before[0], before[1] + 1, before[2], before[3] + 1, before[4])
