"""K5: the port's one-direction sampler (plain PyTorch path) against the
JAX package's shift sampler with its Pallas kernel in interpret mode
(``ops/warp._sample_all_planes(..., pallas=True)``, which runs
``shift_sample_pallas`` on the luma planes off the TPU), both directions,
luma and interleaved chroma: at res scalar 0 and 2, uint8 and uint16, the
blend positions 0, 0.4 and 1, a flow that drives samples past the mirror
edges, and a single flow value.  These are the analogs of
``tests/test_pallas_kernels.py::TestPallasWarpSampler``.  Bit-exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from mpv_frame_interpolator_tpu.ops import warp as W
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KS

torch.set_num_threads(1)

# flow values (x, y): a spread that reaches past every edge of a 64x48
# frame, and one value for the whole field
_WIDE = [(0, 0), (37, -21), (-45, 30), (12, 50), (-60, -7), (3, 2)]
_ONE = [(5, -3)]


def _case(cfg, values, seed, dtype):
    """Planar JAX planes, the port's interleaved planes and a flow field
    drawn from `values`, from a numpy seed."""
    h, w = cfg.height, cfg.width
    geom = FlowGeometry.create(h, w, w)
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max + 1

    def planes():
        return (rng.integers(0, hi, (h, w)).astype(dtype),
                rng.integers(0, hi, (h // 2, w // 2)).astype(dtype),
                rng.integers(0, hi, (h // 2, w // 2)).astype(dtype))

    f1, f2 = planes(), planes()
    pick = rng.integers(0, len(values), (geom.low_h, geom.low_w))
    blurred = np.stack([np.array([v[0] for v in values], np.int32)[pick],
                        np.array([v[1] for v in values], np.int32)[pick]])
    return geom, f1, f2, blurred


def _interleave(u, v):
    uv = np.empty((u.shape[0], u.shape[1] * 2), u.dtype)
    uv[:, 0::2], uv[:, 1::2] = u, v
    return uv


def _port(geom, f1, f2, blurred, t, direction):
    args = [torch.from_numpy(np.ascontiguousarray(p)) for p in (
        f1[0], _interleave(f1[1], f1[2]), f2[0], _interleave(f2[1], f2[2]))]
    before = KS.counts.plain
    y, uv = KS.sample_dir(*args, torch.from_numpy(blurred),
                          torch.tensor(t, dtype=torch.float32), direction,
                          geom.res_scalar, geom.actual_width)
    assert KS.counts.plain == before + 1
    assert y.dtype == uv.dtype == torch.from_numpy(f1[0]).dtype
    return y.numpy(), uv.numpy()


def _jax_samples(geom, f1, f2, blurred, t):
    jf1 = [jnp.asarray(p) for p in f1]
    jf2 = [jnp.asarray(p) for p in f2]
    fields = W._warp_fields(geom, jnp.asarray(blurred), full_res=False)
    prep = W._sampler_prep(geom, fields, *jf1, *jf2)
    assert bool(prep["ok"]), "test field must stay inside the shift gates"
    fields["SPREP"] = prep
    fs12 = jnp.float32(t)
    fs21 = jnp.float32(1.0) - fs12
    sp = W._sample_all_planes(geom, fields, *jf1, *jf2, fs12, fs21,
                              pallas=True)
    return [np.asarray(p) for p in sp]


def _check(cfg, values, t, seed, dtype):
    geom, f1, f2, blurred = _case(cfg, values, seed, dtype)
    sp = _jax_samples(geom, f1, f2, blurred, t)
    for direction, y_ref, u_ref, v_ref in ((12, sp[0], sp[2], sp[4]),
                                           (21, sp[1], sp[3], sp[5])):
        y, uv = _port(geom, f1, f2, blurred, t, direction)
        np.testing.assert_array_equal(y, y_ref)
        np.testing.assert_array_equal(uv, _interleave(u_ref, v_ref))


@pytest.mark.parametrize("t", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_rs0_past_the_edges(small_cfg, dtype, t):
    _check(small_cfg, _WIDE, t, 1, dtype)


@pytest.mark.parametrize("t", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_rs2(pyramid_cfg, dtype, t):
    _check(pyramid_cfg, _WIDE[:4], t, 2, dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_single_flow_value(small_cfg, dtype):
    _check(small_cfg, _ONE, 0.4, 3, dtype)


def test_uint16_passes_through_uncapped(small_cfg):
    """Raw samples: a P010 sample of 65535 comes out as it went in (no
    cap at 255 << 8, no level map)."""
    geom, f1, f2, blurred = _case(small_cfg, [(0, 0)], 4, np.uint16)
    f1[0][:] = 65535
    y, _ = _port(geom, f1, f2, blurred, 0.4, 12)
    assert (y == 65535).all()


def test_rejects_a_bad_direction_and_a_vector_of_positions(small_cfg):
    geom, f1, f2, blurred = _case(small_cfg, _ONE, 5, np.uint8)
    args = [torch.from_numpy(np.ascontiguousarray(p)) for p in (
        f1[0], _interleave(f1[1], f1[2]), f2[0], _interleave(f2[1], f2[2]))]
    with pytest.raises(ValueError, match="direction"):
        KS.sample_dir(*args, torch.from_numpy(blurred), torch.tensor(0.5),
                      13, geom.res_scalar, geom.actual_width)
    with pytest.raises(ValueError, match="one blend position"):
        KS.sample_dir(*args, torch.from_numpy(blurred),
                      torch.tensor([0.2, 0.4]), 12, geom.res_scalar,
                      geom.actual_width)


def test_grid_sample_is_not_this_function():
    """Why no single PyTorch call computes K5: grid_sample's nearest mode
    rounds a half-way coordinate to even (K5 rounds the displacement half
    away from zero) and reflects at the edge without K5's mirror_edge2
    (which maps -1 to 2 and clamps into [1, dim - 2])."""
    src = torch.arange(8, dtype=torch.float32).reshape(1, 1, 1, 8)

    def nearest(x_pix):
        # pixel x in align_corners=True normalized coordinates
        g = torch.tensor([[[[2 * x_pix / 7 - 1, 0.0]]]])
        return F.grid_sample(src, g, mode="nearest",
                             padding_mode="reflection",
                             align_corners=True).item()

    # displacement 2.5: K5 samples column iround(2.5) = 3
    assert int(TW.iround(torch.tensor(2.5))) == 3
    assert nearest(2.5) == 2.0
    # column -1: mirror_edge2 gives 2, reflection padding gives 1
    assert int(TW.mirror_edge2(torch.tensor(-1), 8)) == 2
    assert nearest(-1.0) == 1.0
