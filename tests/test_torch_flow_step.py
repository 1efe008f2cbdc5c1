"""K1: the port's flow step (plain PyTorch path) against the JAX step
branch ops/flow._make_step_branch and the Pallas kernel flow_step_pallas
in interpret mode (+ flow_step_commit).  Bit-exact.

Inputs follow tests/test_flow_pallas_step.py: random planes made from a
numpy seed, max_calc_res=24 so that res_scalar > 0, committed fields with
a few distinct block-constant offsets, windows x neighbour bias, both
axes, radius below the layer count."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpv_frame_interpolator_tpu.ops import flow as F
from mpv_frame_interpolator_tpu.ops.pallas import flow_step as FS
from mpv_frame_interpolator_tpu_torch.ops import flow as TF
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as TS

torch.set_num_threads(1)


def _case(seed, H=48, W=64, max_calc_res=24):
    rng = np.random.default_rng(seed)
    geom = F.FlowGeometry.create(H, W, W, max_calc_res=max_calc_res)

    def plane(h, w):
        return rng.integers(0, 256, (h, w)).astype(np.uint8)

    f1 = [plane(H, W), plane(H // 2, W // 2), plane(H // 2, W // 2)]
    f2 = [plane(H, W), plane(H // 2, W // 2), plane(H // 2, W // 2)]
    return geom, f1, f2, rng


def _fields(rng, lh, lw, D, rep, lo=-20, hi=20):
    vy = rng.integers(lo, hi, D)
    vx = rng.integers(lo, hi, D)
    pick = rng.integers(0, D, (-(-lh // rep), -(-lw // rep)))
    fy = vy[pick].repeat(rep, 0).repeat(rep, 1)[:lh, :lw]
    fx = vx[pick].repeat(rep, 0).repeat(rep, 1)[:lh, :lw]
    return fx.astype(np.int32), fy.astype(np.int32)


def _port_step(geom, f1, f2, off_x, off_y, is_y, radius, window, nb):
    t1 = [torch.from_numpy(p) for p in f1]
    probe = TF.subsampled_f2(geom, *(torch.from_numpy(p) for p in f2))
    ox, oy = TS.flow_step(*t1, *probe, torch.from_numpy(off_x),
                          torch.from_numpy(off_y), is_y, radius, 8, 6,
                          window, nb, geom.res_scalar, geom.height,
                          geom.stride)
    return ox.numpy(), oy.numpy()


def _run(seed, window, nb, radius, layers, D, max_calc_res=24,
         pallas=True):
    geom, f1, f2, rng = _case(seed, max_calc_res=max_calc_res)
    lh, lw, rs = geom.low_h, geom.low_w, geom.res_scalar
    off_x, off_y = _fields(rng, lh, lw, D, max(window, 1))
    is_y = seed % 2
    jf1 = [jnp.asarray(p) for p in f1]
    f2_probe = F._subsampled_f2(geom, *(jnp.asarray(p) for p in f2))
    stacks = F._phase_stacks(geom, *jf1)
    args = (jnp.asarray(off_x), jnp.asarray(off_y), jnp.int32(is_y),
            jnp.int32(radius), jnp.int32(8), jnp.int32(6))

    got = _port_step(geom, f1, f2, off_x, off_y, is_y, radius, window, nb)

    # the XLA branch (shift sampling with its runtime gather fallback)
    branch = F._make_step_branch(geom, window, nb, layers, 0, *jf1,
                                 f2_probe, stacks)
    ref = jax.jit(branch)(*args)
    # the pure gather branch
    gather = F._make_step_branch(geom, window, nb, layers, 0, *jf1,
                                 f2_probe, None)
    ref_g = jax.jit(gather)(*args)
    for r in (ref, ref_g):
        np.testing.assert_array_equal(got[0], np.asarray(r[0]))
        np.testing.assert_array_equal(got[1], np.asarray(r[1]))

    if pallas:
        meta = jnp.stack([args[2], args[3], args[4],
                          args[5]]).astype(jnp.int32)
        stacks2 = FS.pad_stacks_for_pallas(stacks, lh, lw, F._FLOW_BLOW)
        probe_st = jnp.stack(f2_probe).astype(jnp.int16)
        adj2, valid = FS.flow_step_pallas(
            stacks2, probe_st, args[0], args[1], meta, lh=lh, lw=lw,
            s=1 << rs, rs=rs, Bl=F._FLOW_BLOW, window=window,
            nb_enabled=nb, layers=layers, luma_shift=0, K=F._FLOW_K,
            interpret=True)
        assert int(valid[0]) == 1
        ox_p, oy_p = FS.flow_step_commit(adj2, args[0], args[1], args[2],
                                         window, lh, lw)
        np.testing.assert_array_equal(got[0], np.asarray(ox_p))
        np.testing.assert_array_equal(got[1], np.asarray(oy_p))


@pytest.mark.parametrize("window,nb", [(1, True), (2, True), (4, False),
                                       (16, True)])
def test_windows(window, nb):
    _run(seed=window, window=window, nb=nb, radius=16, layers=16, D=5)


@pytest.mark.parametrize("seed", [0, 1])
def test_both_axes(seed):
    _run(seed=seed, window=2, nb=True, radius=16, layers=16, D=4)


@pytest.mark.parametrize("seed,window,radius,layers",
                         [(3, 2, 5, 16), (4, 4, 8, 8)])
def test_radius_below_layers(seed, window, radius, layers):
    _run(seed=seed, window=window, nb=True, radius=radius, layers=layers,
         D=5)


@pytest.mark.parametrize("D", [1, 11])
def test_distinct_value_counts(D):
    _run(seed=5 + D, window=2, nb=True, radius=16, layers=16, D=D)


def test_field_beyond_the_tpu_budget():
    """A field with more distinct offsets than the TPU kernel's budget:
    JAX takes its gather fallback, the port has no budget at all."""
    _run(seed=11, window=1, nb=True, radius=16, layers=16,
         D=F._FLOW_K + 8, pallas=False)


@pytest.mark.parametrize("max_calc_res", [270, 12])
def test_res_scalars(max_calc_res):
    """rs 0 (no subsampling) and rs 2 (the 4K geometry's scale)."""
    _run(seed=21, window=8, nb=True, radius=16, layers=16, D=3,
         max_calc_res=max_calc_res, pallas=False)


def test_wraparound_shift():
    """delta_scalar 31 makes the uint32 partials wrap: the sums and the
    unsigned argmin must still agree."""
    geom, f1, f2, rng = _case(31)
    lh, lw = geom.low_h, geom.low_w
    off_x, off_y = _fields(rng, lh, lw, 3, 4)
    jf1 = [jnp.asarray(p) for p in f1]
    f2_probe = F._subsampled_f2(geom, *(jnp.asarray(p) for p in f2))
    branch = F._make_step_branch(geom, 4, True, 16, 0, *jf1, f2_probe, None)
    ref = jax.jit(branch)(jnp.asarray(off_x), jnp.asarray(off_y),
                          jnp.int32(0), jnp.int32(16), jnp.int32(31),
                          jnp.int32(31))
    t1 = [torch.from_numpy(p) for p in f1]
    probe = TF.subsampled_f2(geom, *(torch.from_numpy(p) for p in f2))
    got = TS.flow_step(*t1, *probe, torch.from_numpy(off_x),
                       torch.from_numpy(off_y), 0, 16, 31, 31, 4, True,
                       geom.res_scalar, geom.height, geom.stride)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_cpu_tensors_take_the_plain_version():
    geom, f1, f2, rng = _case(2)
    off = np.zeros((geom.low_h, geom.low_w), np.int32)
    before = (TS.counts.kernel, TS.counts.plain)
    _port_step(geom, f1, f2, off, off, 0, 5, 4, False)
    assert (TS.counts.kernel, TS.counts.plain) == (before[0],
                                                   before[1] + 1)


@pytest.mark.parametrize("radius,window", [(257, 4), (0, 4), (5, 3),
                                           (5, 0)])
def test_rejects_bad_scalars(radius, window):
    geom, f1, f2, rng = _case(2)
    off = np.zeros((geom.low_h, geom.low_w), np.int32)
    with pytest.raises(ValueError):
        _port_step(geom, f1, f2, off, off, 0, radius, window, False)
