"""The port's sharded step over torch.distributed (gloo, ranks spawned on
the CPU) against the JAX package's single-device functions, which is what
the JAX package's own tests/test_parallel.py holds its sharded path to:
the layer-sharded offset and blur equal ``make_flow_fn`` at radius 16,
the row-sharded warp equals ``make_warp_fn`` in modes 2 and 0, at world
sizes 1, 2 and 4 (every rank also checks itself against the port's
single-device path).  Then the dry run on two ranks, and ``entry()``'s
shapes and dtypes (not run: 1080p on the CPU is slow)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpv_frame_interpolator_tpu.frame import split_chroma
from mpv_frame_interpolator_tpu.io import synthetic as jax_synthetic
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry, make_flow_fn
from mpv_frame_interpolator_tpu.ops.warp import make_warp_fn
from mpv_frame_interpolator_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

RADIUS, T, MODES = 16, 0.4, (2, 0)


@pytest.fixture(scope="module")
def case():
    cfg = jax_synthetic.SyntheticConfig(width=64, height=48, fps=24.0)
    gen = jax_synthetic.gradient_pan(cfg, 2)
    f1, f2 = next(gen), next(gen)
    planes = (f1.y, *split_chroma(f1.uv), f2.y, *split_chroma(f2.uv))
    planes = tuple(np.ascontiguousarray(p) for p in planes)
    geom = FlowGeometry.create(48, 64, 64)
    a = [jnp.asarray(p) for p in planes]
    off, blur = make_flow_fn(geom, RADIUS)(*a, jnp.int32(8), jnp.int32(6))
    warps = {mode: tuple(np.asarray(p) for p in make_warp_fn(geom, mode)(
        *a, blur, jnp.float32(T), jnp.float32(0.0), jnp.float32(255.0)))
        for mode in MODES}
    return planes, np.asarray(off), np.asarray(blur), warps


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_step_equals_the_jax_single_device_path(case, world):
    planes, off, blur, warps = case
    res = dryrun.run_sharded(world, planes, RADIUS, MODES, T, device="cpu",
                             backend="gloo")
    assert res["equal"]          # every rank against the port's own path
    np.testing.assert_array_equal(res["offset"], off)
    np.testing.assert_array_equal(res["blurred"], blur)
    for mode in MODES:
        for got, want in zip(res["outputs"][mode], warps[mode]):
            np.testing.assert_array_equal(got, want)


def test_radius_must_split_over_the_ranks(case):
    with pytest.raises(ValueError, match="does not split"):
        dryrun.run_sharded(3, case[0], RADIUS, (2,), T, device="cpu",
                           backend="gloo")


def test_nccl_needs_a_card_a_rank(case):
    with pytest.raises((ValueError, RuntimeError)):
        dryrun.run_sharded(2, case[0], RADIUS, (2,), T, device="cpu",
                           backend="nccl")


def test_dryrun_multichip_two_ranks(capsys):
    res = dryrun.dryrun_multichip(2, device="cpu")
    assert res["equal"]
    assert "dryrun_multichip: 2 ranks (gloo on cpu) OK" in \
        capsys.readouterr().out


def test_entry_shapes_and_dtypes():
    fn, args = dryrun.entry(device="cpu")
    assert callable(fn)
    shapes = [tuple(a.shape) for a in args]
    assert shapes == [(1080, 1920), (540, 960), (540, 960)] * 2 + [()]
    assert [a.dtype for a in args] == [torch.uint8] * 6 + [torch.float32]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.entry()
