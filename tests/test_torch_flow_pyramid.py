"""K1's pyramid entry point (plain PyTorch path) against the JAX package's
make_flow_fn: the whole scan of steps, bit-exact, on tests/test_torch_flow.py's
cases -- 64x48 (res_scalar 0) and 96x544 (res_scalar 2), radius 5 and 16,
noise, a stride wider than the picture -- and on 16-bit P010 planes with
luma_shift 8.  Also the step schedule, the launch counters and the
wrapper's checks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.frame import split_chroma
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry, make_flow_fn
from mpv_frame_interpolator_tpu_torch.ops import flow as TF
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS

torch.set_num_threads(1)


def _planes(frame):
    u, v = split_chroma(frame.uv)
    return frame.y, np.ascontiguousarray(u), np.ascontiguousarray(v)


def _pyramid_args(geom, f1, f2, radius, ds=8, nbs=6, luma_shift=0):
    t1 = [torch.from_numpy(p) for p in _planes(f1)]
    probe = TF.subsampled_f2(geom, *(torch.from_numpy(p)
                                     for p in _planes(f2)))
    return (*t1, *probe, radius, ds, nbs, geom.window_schedule(),
            TF.FIRST_NEIGHBOR_ITERATION, geom.res_scalar, geom.height,
            geom.stride, luma_shift)


def _check(cfg, source, radius, luma_shift=0, ds=8, nbs=6):
    f1, f2 = list(getattr(synthetic, source)(cfg, 2))
    fmt = f1.fmt
    geom = TF.FlowGeometry.create(fmt.height, fmt.stride, fmt.width)
    args = _pyramid_args(geom, f1, f2, radius, ds, nbs, luma_shift)
    before = (KS.counts.kernel, KS.counts.plain)
    got = KS.flow_pyramid(*args)
    assert (KS.counts.kernel, KS.counts.plain) == (before[0], before[1] + 1)
    assert got.dtype == torch.int32 and got.shape == (2, geom.low_h,
                                                      geom.low_w)
    np.testing.assert_array_equal(got.numpy(),
                                  KS.flow_pyramid_plain(*args).numpy())
    fn = make_flow_fn(FlowGeometry.create(fmt.height, fmt.stride, fmt.width),
                      radius, luma_shift=luma_shift)
    want, _ = fn(*(jnp.asarray(p) for f in (f1, f2) for p in _planes(f)),
                 jnp.int32(ds), jnp.int32(nbs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return geom, got


@pytest.mark.parametrize("radius", [5, 16])
def test_small_geometry(small_cfg, radius):
    geom, got = _check(small_cfg, "moving_box", radius)
    assert geom.res_scalar == 0 and got.any()


@pytest.mark.parametrize("radius", [5, 16])
def test_res_scalar_pyramid(pyramid_cfg, radius):
    geom, _ = _check(pyramid_cfg, "gradient_pan", radius)
    assert geom.res_scalar == 2


def test_noise(small_cfg):
    _check(small_cfg, "noise", 16)


def test_stride_wider_than_width(small_cfg):
    _check(dataclasses.replace(small_cfg, stride=80), "moving_box", 16)


@pytest.mark.parametrize("source,radius", [("gradient_pan", 16),
                                           ("noise", 5)])
def test_p010(source, radius):
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0,
                                    pixfmt="p010")
    geom, _ = _check(cfg, source, radius, luma_shift=8)
    assert geom.iterations > 1


def test_wrapping_partials(small_cfg):
    """ds = nbs = 31: the uint32 partials and window sums wrap."""
    _check(small_cfg, "gradient_pan", 8, ds=31, nbs=31)


def test_steps_alternate_axes_and_start_the_bias():
    assert KS.pyramid_steps((8, 4, 2), 1) == (
        (8, 0, False), (8, 1, False), (4, 0, True), (4, 1, True),
        (2, 0, True), (2, 1, True))
    assert KS.pyramid_steps((), 4) == ()


def test_flow_runs_the_pyramid_once(small_cfg):
    """ops/flow.flow makes one pyramid call a pair, not one call a step."""
    f1, f2 = list(synthetic.moving_box(small_cfg, 2))
    geom = TF.FlowGeometry.create(48, 64, 64)
    t = [torch.from_numpy(p) for f in (f1, f2) for p in _planes(f)]
    before = KS.counts.plain
    off, _ = TF.flow(geom, *t, 16)
    assert KS.counts.plain == before + 1
    np.testing.assert_array_equal(
        off.numpy(), KS.flow_pyramid_plain(*_pyramid_args(
            geom, f1, f2, 16)).numpy())


def test_empty_schedule_is_the_zero_field():
    z = torch.zeros((2, 4), dtype=torch.uint8)
    c = torch.zeros((1, 2), dtype=torch.uint8)
    got = KS.flow_pyramid(z, c, c, z, z, z, 5, 8, 6, (), 4, 0, 2, 4)
    assert got.shape == (2, 2, 4) and got.dtype == torch.int32
    assert not got.any()


@pytest.mark.parametrize("windows", [(3,), (0,), (1 << 31,),
                                     (2,) * (KS.MAX_STEPS // 2 + 1)])
def test_rejects_bad_schedules(small_cfg, windows):
    f1, f2 = list(synthetic.moving_box(small_cfg, 2))
    geom = TF.FlowGeometry.create(48, 64, 64)
    args = list(_pyramid_args(geom, f1, f2, 16))
    args[9] = windows
    with pytest.raises(ValueError):
        KS.flow_pyramid(*args)


def test_no_fallback_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version (a
    meta tensor here; a CUDA tensor goes on to the kernel)."""
    u8 = lambda *s: torch.empty(s, dtype=torch.uint8, device="meta")  # noqa
    before = (KS.counts.kernel, KS.counts.plain)
    with pytest.raises(ValueError, match="CUDA tensor"):
        KS.flow_pyramid(u8(48, 64), u8(24, 32), u8(24, 32), u8(6, 8),
                        u8(6, 8), u8(6, 8), 5, 8, 6, (4, 2), 1, 3, 48, 64)
    assert (KS.counts.kernel, KS.counts.plain) == before
