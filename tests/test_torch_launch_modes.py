"""The two launch modes the sharded step adds to existing kernels, through
their plain versions on the CPU (the kernels themselves run on the card:
tests/test_torch_cuda.py and chip_smoke.py phase 18).

* K1's layer slice: over every split of the radius into slices, each
  slice's (first unsigned minimum, global layer) per window, the first
  slice holding the least minimum, committed, equal ``flow_step_plain``'s
  step (the single-device step); at a delta scalar where the window sums
  pass 2^31, so that a signed order would pick other layers.
* K2's row band: the bands of a split stacked equal ``pair_blend_plain``
  (NV12 at the default levels, P010 at 16/235)."""

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu_torch.ops import flow as TF
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as TS
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as TP
from mpv_frame_interpolator_tpu_torch.parallel.sharding import (
    first_unsigned_min)

torch.set_num_threads(1)


def _flow_case(seed, H=48, W=64, max_calc_res=24):
    rng = np.random.default_rng(seed)
    geom = TF.FlowGeometry.create(H, W, W, max_calc_res=max_calc_res)

    def plane(h, w):
        return torch.from_numpy(rng.integers(0, 256, (h, w)).astype(
            np.uint8))

    f1 = [plane(H, W), plane(H // 2, W // 2), plane(H // 2, W // 2)]
    probe = TF.subsampled_f2(geom, plane(H, W), plane(H // 2, W // 2),
                             plane(H // 2, W // 2))
    lh, lw = geom.low_h, geom.low_w
    off = [torch.from_numpy(rng.integers(-6, 7, (lh, lw)).astype(np.int32))
           for _ in range(2)]
    return geom, f1, probe, off


@pytest.mark.parametrize("window,is_y,nb,ds", [
    (8, 0, False, 8), (4, 1, True, 8), (1, 0, True, 8), (2, 1, False, 23),
    (1, 1, False, 23)])
@pytest.mark.parametrize("split", [(16,), (8, 8), (4, 4, 4, 4), (3, 5, 8)])
def test_layer_slices_give_the_single_step(window, is_y, nb, ds, split):
    geom, f1, probe, (off_x, off_y) = _flow_case(window * 10 + is_y)
    radius = sum(split)
    args = (geom.res_scalar, geom.height, geom.stride)
    pairs, z0 = [], 0
    for n in split:
        best, arg = TS.flow_layer_slice(*f1, *probe, off_x, off_y, is_y, z0,
                                        n, radius, ds, 6, window, nb, *args)
        pairs.append(torch.stack((best, arg)))
        z0 += n
    winner = first_unsigned_min(torch.stack(pairs))
    got = TS.commit_plain(off_x, off_y, is_y, winner, radius, window)
    want = TS.flow_step_plain(*f1, *probe, off_x, off_y, is_y, radius, ds, 6,
                              window, nb, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_a_signed_order_would_pick_other_layers():
    """The ds = 23 cases above carry weight: there the window sums pass
    2^31, and a signed minimum over the layers picks other winners."""
    geom, f1, probe, (off_x, off_y) = _flow_case(21)
    pairs = torch.stack([torch.stack(TS.flow_layer_slice(
        *f1, *probe, off_x, off_y, 1, z, 1, 16, 23, 6, 2, False,
        geom.res_scalar, geom.height, geom.stride)) for z in range(16)])
    signed = pairs[:, 1].gather(0, torch.argmin(pairs[:, 0], 0)[None])[0]
    assert not torch.equal(first_unsigned_min(pairs), signed)


def test_layer_slice_refuses_a_slice_outside_the_radius():
    geom, f1, probe, (off_x, off_y) = _flow_case(3)
    with pytest.raises(ValueError, match="not a slice"):
        TS.flow_layer_slice(*f1, *probe, off_x, off_y, 0, 12, 8, 16, 8, 6,
                            4, False, geom.res_scalar, geom.height,
                            geom.stride)


def _warp_case(seed, dt, H=48, W=64):
    rng = np.random.default_rng(seed)
    hi = 256 if dt == np.uint8 else 65536

    def plane(h, w):
        return torch.from_numpy(rng.integers(0, hi, (h, w)).astype(dt))

    geom = TF.FlowGeometry.create(H, W, W, max_calc_res=24)
    blurred = torch.from_numpy(rng.integers(-20, 21, (2, geom.low_h,
                                                      geom.low_w))
                               .astype(np.int32))
    return geom, (plane(H, W), plane(H // 2, W), plane(H, W),
                  plane(H // 2, W)), blurred


@pytest.mark.parametrize("dt,ss,levels", [
    (np.uint8, 0, (0, 255)), (np.uint16, 8, TW.level_ints(16, 235))])
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_row_bands_stack_to_the_pair_blend(dt, ss, levels, parts):
    geom, planes, blurred = _warp_case(parts, dt)
    ts = torch.tensor([0.0, 0.3, 0.75], dtype=torch.float32)
    args = (*planes, blurred, ts, geom.res_scalar, geom.actual_width)
    want_y, want_uv = TP.pair_blend_plain(*args, ss, levels)
    bands = TP.band_rows(geom.height, parts)
    assert bands[0][0] == 0 and bands[-1][1] == geom.height
    assert all(a % 2 == 0 and b % 2 == 0 for a, b in bands)
    got = [TP.pair_blend_rows(*args, r0, r1, ss, levels) for r0, r1 in bands]
    assert torch.equal(torch.cat([y for y, _ in got], 1), want_y)
    assert torch.equal(torch.cat([uv for _, uv in got], 1), want_uv)


def test_row_band_refuses_odd_edges():
    geom, planes, blurred = _warp_case(0, np.uint8)
    ts = torch.tensor([0.5], dtype=torch.float32)
    with pytest.raises(ValueError, match="even band"):
        TP.pair_blend_rows(*planes, blurred, ts, geom.res_scalar,
                           geom.actual_width, 1, 9)
