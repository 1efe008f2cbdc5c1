"""The port's oracle copy, its device metrics, its parity check and its
chip-time harness, on the CPU against the JAX package.

The oracle copy (``ops/oracle.py``) equals the JAX oracle bit for bit on
the parity smoke cases and on a case with res_scalar >= 1 in modes 0, 2
and 4, and its constants equal ``ops/flow.py``'s.  ``psnr_device`` agrees
with the host PSNR and the JAX package's within 1e-5 relative (float32
reductions in another order), ``mean_abs_diff`` exactly.  ``run_parity``
gives the JAX function's rows, all True."""

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.io import synthetic as jax_synthetic
from mpv_frame_interpolator_tpu.ops import metrics as jax_metrics
from mpv_frame_interpolator_tpu.ops import oracle as jax_oracle
from mpv_frame_interpolator_tpu.utils import parity as jax_parity
from mpv_frame_interpolator_tpu_torch import frame as port_frame
from mpv_frame_interpolator_tpu_torch.ops import flow as port_flow
from mpv_frame_interpolator_tpu_torch.ops import metrics as port_metrics
from mpv_frame_interpolator_tpu_torch.ops import oracle as port_oracle
from mpv_frame_interpolator_tpu_torch.utils import parity as port_parity
from mpv_frame_interpolator_tpu_torch.utils.chiptime import chip_pair_seconds

torch.set_num_threads(1)

ORACLE_CASES = port_parity.SMOKE_CASES + [port_parity.FULL_CASES[2]]


def _pair(case):
    w, h, src, _, _ = case
    cfg = jax_synthetic.SyntheticConfig(width=w, height=h, fps=24.0)
    gen = getattr(jax_synthetic, src)(cfg, 2)
    return next(gen), next(gen)


@pytest.mark.parametrize("case", ORACLE_CASES, ids=lambda c: f"{c[0]}x{c[1]}"
                         f"_{c[2]}_r{c[3]}")
def test_oracle_copy_equals_the_original(case):
    f1, f2 = _pair(case)
    _, h, _, radius, t = case
    geom = port_flow.FlowGeometry.create(h, case[0], case[0])
    flows = []
    for oracle in (jax_oracle, port_oracle):
        off, blur = oracle.calculate_optical_flow(
            f1.y, f1.uv, f2.y, f2.uv, search_radius=radius,
            res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
        np.testing.assert_array_equal(oracle.blur_flow(off), blur)
        flows.append((off, blur))
    np.testing.assert_array_equal(flows[0][0], flows[1][0])
    np.testing.assert_array_equal(flows[0][1], flows[1][1])
    blur = flows[0][1]
    for mode in (0, 2, 4):
        ref = jax_oracle.warp_frame(f1.y, f1.uv, f2.y, f2.uv, blur, t, mode,
                                    geom.res_scalar, geom.actual_width)
        got = port_oracle.warp_frame(f1.y, f1.uv, f2.y, f2.uv, blur, t,
                                     mode, geom.res_scalar,
                                     geom.actual_width)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)


def test_oracle_constants_equal_the_flow_modules():
    assert port_oracle.MAX_CALC_RES == port_flow.MAX_CALC_RES
    assert port_oracle.MAX_SEARCH_RADIUS == port_flow.MAX_SEARCH_RADIUS
    assert port_oracle.FIRST_NEIGHBOR_ITERATION == \
        port_flow.FIRST_NEIGHBOR_ITERATION
    assert port_oracle.BLUR_KERNEL_RADIUS == port_flow.BLUR_KERNEL_RADIUS
    for h in (48, 180, 544, 2160):
        assert port_oracle.res_scalar_for(h) == port_flow.res_scalar_for(h)
        rs = port_flow.res_scalar_for(h)
        assert port_oracle.low_dims_for(h, 3840, rs) == \
            port_flow.low_dims_for(h, 3840, rs)


@pytest.mark.parametrize("dtype,peak", [(np.uint8, 255), (np.uint16, 65535)])
def test_metrics_match_the_host_and_jax(dtype, peak):
    rng = np.random.default_rng(12)
    a = rng.integers(0, peak + 1, (48, 64)).astype(dtype)
    b = np.clip(a.astype(np.int64) + rng.integers(-9, 10, a.shape), 0,
                peak).astype(dtype)
    got = port_metrics.psnr_device(torch.from_numpy(a), torch.from_numpy(b),
                                   peak)
    assert got.dtype == torch.float32 and got.dim() == 0
    host = port_frame.psnr_arrays(a, b, peak)
    ref = float(jax_metrics.psnr_device(a, b, peak=peak))
    assert float(got) == pytest.approx(host, rel=1e-5)
    assert float(got) == pytest.approx(ref, rel=1e-5)
    same = port_metrics.psnr_device(a, a, peak, device="cpu")
    assert float(same) == 999.0
    mad = port_metrics.mean_abs_diff(a, b, device="cpu")
    assert np.float32(mad) == np.float32(jax_metrics.mean_abs_diff(a, b))


def test_metrics_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    a = np.zeros((4, 4), np.uint8)
    with pytest.raises((RuntimeError, AssertionError)):
        port_metrics.psnr_device(a, a)


def test_parity_rows_are_the_jax_rows_and_all_pass():
    rows = port_parity.run_parity(port_parity.SMOKE_CASES, (0, 2),
                                  device="cpu")
    ref = jax_parity.run_parity(jax_parity.SMOKE_CASES, (0, 2))
    assert rows == ref
    assert all(ok for _, ok in rows)
    assert port_parity.FULL_CASES == jax_parity.FULL_CASES
    assert port_parity.MODE_NAMES == jax_parity.MODE_NAMES


def test_parity_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_parity.run_parity(port_parity.SMOKE_CASES[:1], (2,))


def test_chip_pair_seconds_on_the_cpu():
    sec = chip_pair_seconds(64, 48, 2, 5, k1=1, k2=3, repeats=1,
                            device="cpu")
    assert isinstance(sec, float) and sec > 0
