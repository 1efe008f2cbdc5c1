"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small and odd shapes the 4K smoke test does not reach (widths
that are not a multiple of a warp, planes smaller than the blur's reach,
stride wider than the picture, res_scalar 0 and 2), for 8-bit NV12 and
10-bit P010 with black/white levels; the port's flow, blend and
one-direction samples (modes 0 and 1) on the card against the NumPy
oracle (``ops/oracle``, 8-bit; P010 content that is 8-bit << 8 gives the
oracle's flow, and its blend >> 8 the oracle's blend at blend positions
whose 16-bit weight is exact); Q1 (the 1/64-pel bilinear blend) against
its plain version and ``q1_model``, a NumPy model of its arithmetic
sample by sample (which ``tests/test_torch_bilinear.py`` holds against
the JAX package on the CPU), and G1's occlusion variant; the toolchain
probes; C1 (the pair's prologue: score, cut, folded positions, probe)
eagerly, under graph capture and replay and on two streams at once, and
V3 (the grey view); and the whole engine on the card against the engine
on the CPU, output modes 0-6 and every model family, with the main path's
three kernel launches a pair.  Bit-exact, except mode 3's
float colours (the JAX package's tolerance).

These tests need an NVIDIA card (marker ``gpu``) and skip without one.
They import no jax, so on a machine without it they run as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops import oracle
from mpv_frame_interpolator_tpu_torch.convert import frame_to_device
from mpv_frame_interpolator_tpu_torch.ops import flow as F
from mpv_frame_interpolator_tpu_torch.ops.cuda import blend_levels as KG
from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.ops.cuda import prologue as KC
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_bilinear as KQ
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KD
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_views as KV
from mpv_frame_interpolator_tpu_torch.pipeline import engine as E
from mpv_frame_interpolator_tpu_torch.tools import dma_probe as DP
from mpv_frame_interpolator_tpu_torch.tools import pack_probe as PP

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.uint16:     # few ops take uint16: compare bits
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y)


def _frames(rng, h, stride, dev, dt=np.uint8):
    hi = 1 << (8 * np.dtype(dt).itemsize)
    y = torch.from_numpy(rng.integers(0, hi, (h, stride)).astype(dt))
    uv = torch.from_numpy(rng.integers(0, hi, (h // 2, stride)).astype(dt))
    return y.to(dev), uv.to(dev)


@pytest.mark.parametrize("h,w,stride,mcr", [(118, 202, 202, 270),
                                            (544, 96, 96, 270),
                                            (48, 64, 80, 270),
                                            (48, 64, 64, 24)])
def test_flow_step(cuda, h, w, stride, mcr):
    rng = np.random.default_rng(h * w)
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    lh, lw = geom.low_h, geom.low_w
    y1, uv1 = _frames(rng, h, stride, cuda)
    y2, uv2 = _frames(rng, h, stride, cuda)
    u1, v1 = uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    for window in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        for is_y in (0, 1):
            for radius, nb in ((5, True), (16, False), (16, True)):
                ox = torch.from_numpy(rng.integers(
                    -40, 41, (lh, lw)).astype(np.int32)).to(cuda)
                oy = torch.from_numpy(rng.integers(
                    -40, 41, (lh, lw)).astype(np.int32)).to(cuda)
                args = (y1, u1, v1, *probe, ox, oy, is_y, radius, 8, 6,
                        window, nb, geom.res_scalar, geom.height,
                        geom.stride)
                _equal(KS.flow_step(*args), KS.flow_step_plain(*args))


@pytest.mark.parametrize("lh,lw", [(1, 1), (3, 2), (2, 7), (17, 45),
                                   (19, 67), (18, 66), (136, 24),
                                   (270, 480)])
def test_blur(cuda, lh, lw):
    rng = np.random.default_rng(lh * 1000 + lw)
    off = torch.from_numpy(rng.integers(-500, 500, (2, lh, lw)).astype(
        np.int32)).to(cuda)
    before = KB.counts.kernel
    _equal([KB.blur_flow(off)], [KB.blur_flow_plain(off)])
    assert KB.counts.kernel == before + 1
    # sums that wrap mod 2^32
    off = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (2, lh, lw))
                           .astype(np.int32)).to(cuda)
    _equal([KB.blur_flow(off)], [KB.blur_flow_plain(off)])


@pytest.mark.parametrize("h,w,stride,n", [(48, 64, 80, 1), (544, 96, 96, 3),
                                          (118, 202, 202, 7)])
def test_pair_blend(cuda, h, w, stride, n):
    rng = np.random.default_rng(h + w + n)
    geom = F.FlowGeometry.create(h, stride, w)
    f1 = _frames(rng, h, stride, cuda)
    f2 = _frames(rng, h, stride, cuda)
    blurred = torch.from_numpy(rng.integers(
        -70, 71, (2, geom.low_h, geom.low_w)).astype(np.int32)).to(cuda)
    ts = torch.from_numpy(np.concatenate([[0.0, 0.9999], rng.random(n)])
                          .astype(np.float32)).to(cuda)
    args = (f1[0], f1[1], f2[0], f2[1], blurred, ts, geom.res_scalar, w)
    _equal(KW.pair_blend(*args), KW.pair_blend_plain(*args))


@pytest.mark.parametrize("h,w,stride,mcr", [(118, 202, 202, 270),
                                            (544, 96, 96, 270),
                                            (48, 64, 80, 24)])
def test_flow_step_p010(cuda, h, w, stride, mcr):
    rng = np.random.default_rng(h * w + 1)
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    lh, lw = geom.low_h, geom.low_w
    y1, uv1 = _frames(rng, h, stride, cuda, np.uint16)
    y2, uv2 = _frames(rng, h, stride, cuda, np.uint16)
    u1, v1 = uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    for window in (1, 2, 8, 32, 128):
        for is_y in (0, 1):
            for radius, nb, ds in ((5, True, 8), (16, True, 8),
                                   (16, False, 31)):
                ox = torch.from_numpy(rng.integers(
                    -40, 41, (lh, lw)).astype(np.int32)).to(cuda)
                oy = torch.from_numpy(rng.integers(
                    -40, 41, (lh, lw)).astype(np.int32)).to(cuda)
                args = (y1, u1, v1, *probe, ox, oy, is_y, radius, ds, 6,
                        window, nb, geom.res_scalar, geom.height,
                        geom.stride, 8)
                _equal(KS.flow_step(*args), KS.flow_step_plain(*args))


@pytest.mark.parametrize("dt,luma_shift", [(np.uint8, 0), (np.uint16, 8)])
@pytest.mark.parametrize("h,w,stride,mcr", [(118, 202, 202, 270),
                                            (544, 96, 96, 270),
                                            (48, 64, 80, 270),
                                            (48, 64, 64, 24)])
def test_flow_pyramid(cuda, dt, luma_shift, h, w, stride, mcr):
    """The whole pyramid in one launch against the loop of plain steps,
    radius 5 and 16, the neighbour bias from iteration 0, 1 and 4."""
    rng = np.random.default_rng(h * w + luma_shift)
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    y1, uv1 = _frames(rng, h, stride, cuda, dt)
    y2, uv2 = _frames(rng, h, stride, cuda, dt)
    u1, v1 = uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    windows = geom.window_schedule()
    for radius, first_nb in ((5, 4), (16, 1), (16, 0)):
        args = (y1, u1, v1, *probe, radius, 8, 6, windows, first_nb,
                geom.res_scalar, geom.height, geom.stride, luma_shift)
        before = KS.counts.kernel
        got = KS.flow_pyramid(*args)
        assert KS.counts.kernel == before + 1
        _equal([got], [KS.flow_pyramid_plain(*args)])


@pytest.mark.parametrize("dt,luma_shift", [(np.uint8, 0), (np.uint16, 8)])
@pytest.mark.parametrize("h,w,stride,mcr", [(118, 202, 202, 270),
                                            (544, 96, 96, 270),
                                            (48, 64, 80, 270),
                                            (48, 64, 64, 24),
                                            (48, 64, 64, 2),
                                            (48, 256, 256, 3),
                                            (256, 12, 12, 64)])
def test_flow_pyramid_blur(cuda, dt, luma_shift, h, w, stride, mcr):
    """The pyramid with the blur as its last phase, one launch, against
    blur_flow_plain(flow_pyramid_plain(...)), and the standalone K3 on the
    same field; the last three shapes give a low-res field of 2 x 2, 3 x 16
    and 64 x 3, below the blur's reach (the 2 x 2 field, whose own
    schedule has no step, takes windows 2 and 1)."""
    rng = np.random.default_rng(h * w + luma_shift + 7)
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    windows = geom.window_schedule() or (2, 1)
    y1, uv1 = _frames(rng, h, stride, cuda, dt)
    y2, uv2 = _frames(rng, h, stride, cuda, dt)
    u1, v1 = uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    for radius, first_nb in ((5, 4), (16, 0)):
        args = (y1, u1, v1, *probe, radius, 8, 6, windows, first_nb,
                geom.res_scalar, geom.height, geom.stride, luma_shift)
        before = (KS.counts.kernel, KB.counts.kernel, KB.counts.fused)
        field, blurred = KS.flow_pyramid(*args, blur=True)
        assert (KS.counts.kernel, KB.counts.kernel, KB.counts.fused) == (
            before[0] + 1, before[1], before[2] + 1)
        want = KS.flow_pyramid_plain(*args)
        _equal([field, blurred], [want, KB.blur_flow_plain(want)])
        _equal([KB.blur_flow(field)], [blurred])
    # the timeline gains one stamp, after the blur phase
    stamps = torch.zeros(3 + 4 * len(windows), dtype=torch.int64,
                         device=cuda)
    KS.flow_pyramid(*args, timeline=stamps, blur=True)
    assert bool((stamps.diff() >= 0).all()) and int(stamps[0]) > 0


@pytest.mark.parametrize("window", [64, 512])
def test_flow_step_window_larger_than_the_field(cuda, window):
    """One window covers the whole 24 x 32 field and more (the plain
    version pads the field to whole windows, so the window stays small
    enough for that)."""
    rng = np.random.default_rng(window)
    geom = F.FlowGeometry.create(48, 64, 64, 24)
    y1, uv1 = _frames(rng, 48, 64, cuda)
    y2, uv2 = _frames(rng, 48, 64, cuda)
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    for is_y in (0, 1):
        ox = torch.from_numpy(rng.integers(-9, 10, (geom.low_h, geom.low_w))
                              .astype(np.int32)).to(cuda)
        oy = torch.from_numpy(rng.integers(-9, 10, (geom.low_h, geom.low_w))
                              .astype(np.int32)).to(cuda)
        args = (y1, uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous(),
                *probe, ox, oy, is_y, 16, 8, 6, window, True,
                geom.res_scalar, geom.height, geom.stride)
        _equal(KS.flow_step(*args), KS.flow_step_plain(*args))


# (height, width, stride, vector path at 8 bits, at P010): rs 0, 2 and 3;
# 16-byte rows (the vector path) and rows that are not (per sample);
# planes whose luma and chroma end in part of a block row (70: 35 chroma
# rows) or fit in one (30)
_RUN_SHAPES = [(64, 128, 144, True, True), (544, 96, 96, True, True),
               (1088, 64, 80, True, True), (48, 120, 136, False, True),
               (64, 100, 112, False, False), (544, 90, 96, False, False),
               (70, 128, 128, True, True), (30, 48, 48, True, True)]


@pytest.mark.parametrize("scale_shift,levels", [(0, (0.0, 255.0)),
                                                (8, (16.0, 235.0))])
@pytest.mark.parametrize("h,w,stride,vec8,vec16", _RUN_SHAPES)
def test_pair_blend_runs(cuda, scale_shift, levels, h, w, stride, vec8,
                         vec16):
    """K2's 16-byte runs and its per-sample path, each bit-exact: flows
    that push cells past every edge, odd chroma displacements (odd flows
    at t = 0.4), t in {0, 0.4, 0.9999, 1}; then N = 1 and 5 positions,
    one launch each."""
    rng = np.random.default_rng(h + w + stride + scale_shift)
    dt = np.uint16 if scale_shift else np.uint8
    geom = F.FlowGeometry.create(h, stride, w)
    f1 = _frames(rng, h, stride, cuda, dt)
    f2 = _frames(rng, h, stride, cuda, dt)
    lh, lw = geom.low_h, geom.low_w
    far = max(h, w) // 2
    blurred = np.where(rng.random((2, lh, lw)) < 0.2,
                       rng.integers(-far, far + 1, (2, lh, lw)),
                       2 * rng.integers(-20, 21, (2, lh, lw)) + 1)
    blurred = torch.from_numpy(blurred.astype(np.int32)).to(cuda)
    ts = torch.tensor([0.0, 0.4, 0.9999, 1.0], dtype=torch.float32,
                      device=cuda)
    args = (f1[0], f1[1], f2[0], f2[1], blurred, ts, geom.res_scalar, w,
            scale_shift, W.level_ints(*levels))
    got = KW.pair_blend(*args)
    assert KW.vector_path((*f1, *f2, *got), w) == (vec16 if scale_shift
                                                   else vec8)
    _equal(got, KW.pair_blend_plain(*args))
    for ts in ([0.4], [0.0, 0.2, 0.4, 0.6, 0.8]):
        args = (*args[:5], torch.tensor(ts, device=cuda), *args[6:])
        before = KW.counts.kernel
        got = KW.pair_blend(*args)
        assert KW.counts.kernel == before + 1
        _equal(got, KW.pair_blend_plain(*args))


def _run_case(cuda, h, w, stride, scale_shift):
    """Planes and a flow for the run tests: flows that push cells past
    every edge and odd flows (odd chroma displacements at t = 0.4)."""
    rng = np.random.default_rng(h + w + stride + scale_shift)
    dt = np.uint16 if scale_shift else np.uint8
    geom = F.FlowGeometry.create(h, stride, w)
    f1 = _frames(rng, h, stride, cuda, dt)
    f2 = _frames(rng, h, stride, cuda, dt)
    lh, lw = geom.low_h, geom.low_w
    far = max(h, w) // 2
    blurred = np.where(rng.random((2, lh, lw)) < 0.2,
                       rng.integers(-far, far + 1, (2, lh, lw)),
                       2 * rng.integers(-20, 21, (2, lh, lw)) + 1)
    return geom, f1, f2, torch.from_numpy(blurred.astype(np.int32)).to(cuda)


@pytest.mark.parametrize("scale_shift,levels", [(0, (0.0, 255.0)),
                                                (8, (16.0, 235.0))])
@pytest.mark.parametrize("h,w,stride,vec8,vec16", _RUN_SHAPES)
def test_fused_blend_runs(cuda, scale_shift, levels, h, w, stride, vec8,
                          vec16):
    """K4's 16-byte runs and its per-sample path, one launch a position,
    each bit-exact: the flows of test_pair_blend_runs, t in {0, 0.4,
    0.9999, 1}."""
    geom, f1, f2, blurred = _run_case(cuda, h, w, stride, scale_shift)
    levels = W.level_ints(*levels)
    for t in (0.0, 0.4, 0.9999, 1.0):
        args = (f1[0], f1[1], f2[0], f2[1], blurred,
                torch.tensor(t, device=cuda), geom.res_scalar, w,
                scale_shift, levels)
        before = KF.counts.kernel
        got = KF.fused_blend(*args)
        assert KF.counts.kernel == before + 1
        assert KW.vector_path((*f1, *f2, *got), w) == (vec16 if scale_shift
                                                       else vec8)
        _equal(got, KF.fused_blend_plain(*args))


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("h,w,stride,vec8,vec16", _RUN_SHAPES)
def test_sample_dir_runs(cuda, scale_shift, h, w, stride, vec8, vec16):
    """K5's 16-byte runs and its per-sample path, both directions, each
    bit-exact: the flows of test_pair_blend_runs, t in {0, 0.4, 0.9999,
    1}."""
    geom, f1, f2, blurred = _run_case(cuda, h, w, stride, scale_shift)
    for direction in (12, 21):
        for t in (0.0, 0.4, 0.9999, 1.0):
            args = (f1[0], f1[1], f2[0], f2[1], blurred,
                    torch.tensor(t, device=cuda), direction,
                    geom.res_scalar, w)
            before = KD.counts.kernel
            got = KD.sample_dir(*args)
            assert KD.counts.kernel == before + 1
            src = f1 if direction == 12 else f2
            assert KW.vector_path((*src, *got), w) == (vec16 if scale_shift
                                                       else vec8)
            _equal(got, KD.sample_dir_plain(*args))


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("levels", [(0.0, 255.0), (16.0, 235.0),
                                    (16.5, 235.5), (0.0, 1.0)])
@pytest.mark.parametrize("h,w,stride,vec8,vec16", _RUN_SHAPES)
def test_blend_levels_runs(cuda, scale_shift, levels, h, w, stride, vec8,
                           vec16):
    """G1's 16-byte runs and its per-sample path, each bit-exact, on K5's
    two directions of the flows of test_pair_blend_runs (and planes of 0
    and of the top value), t in {0, 0.4, 0.5, 0.9999, 1}."""
    geom, f1, f2, blurred = _run_case(cuda, h, w, stride, scale_shift)
    levels = W.level_ints(*levels)
    top = 65535 if scale_shift else 255
    for t in (0.0, 0.4, 0.5, 0.9999, 1.0):
        tt = torch.tensor(t, device=cuda)
        s12 = KD.sample_dir(*f1, *f2, blurred, tt, 12, geom.res_scalar, w)
        s21 = KD.sample_dir(*f1, *f2, blurred, tt, 21, geom.res_scalar, w)
        for p, v in ((s12[0][:2], 0), (s21[0][:1], top), (s21[0][1:2], 0),
                     (s12[1][:1], top)):
            p.copy_(torch.full(p.shape, v, dtype=torch.int32))
        args = (s12[0], s12[1], s21[0], s21[1], tt, scale_shift, levels)
        before = KG.counts.kernel
        got = KG.blend_levels(*args)
        assert KG.counts.kernel == before + 1
        assert KW.vector_path((*s12, *s21, *got), w) == (
            vec16 if scale_shift else vec8)
        _equal(got, KG.blend_levels_plain(*args))


_LEVELS = [(0.0, 255.0), (16.0, 235.0), (16.5, 235.5), (128.0, 128.0),
           (0.0, 1.0)]


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("black,white", _LEVELS)
def test_pair_blend_levels(cuda, scale_shift, black, white):
    h, w, stride = 118, 202, 208
    rng = np.random.default_rng(int(black + white) + scale_shift)
    dt = np.uint16 if scale_shift else np.uint8
    geom = F.FlowGeometry.create(h, stride, w)
    f1 = _frames(rng, h, stride, cuda, dt)
    f2 = _frames(rng, h, stride, cuda, dt)
    blurred = torch.from_numpy(rng.integers(
        -70, 71, (2, geom.low_h, geom.low_w)).astype(np.int32)).to(cuda)
    ts = torch.tensor([0.0, 0.4, 0.9999, 1.0], dtype=torch.float32,
                      device=cuda)
    args = (f1[0], f1[1], f2[0], f2[1], blurred, ts, geom.res_scalar, w,
            scale_shift, W.level_ints(black, white))
    _equal(KW.pair_blend(*args), KW.pair_blend_plain(*args))


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("black,white", _LEVELS[:3])
@pytest.mark.parametrize("h,w,stride", [(48, 64, 80), (544, 96, 96),
                                        (118, 202, 202)])
def test_fused_blend(cuda, scale_shift, black, white, h, w, stride):
    rng = np.random.default_rng(h + w + scale_shift)
    dt = np.uint16 if scale_shift else np.uint8
    geom = F.FlowGeometry.create(h, stride, w)
    f1 = _frames(rng, h, stride, cuda, dt)
    f2 = _frames(rng, h, stride, cuda, dt)
    blurred = torch.from_numpy(rng.integers(
        -70, 71, (2, geom.low_h, geom.low_w)).astype(np.int32)).to(cuda)
    levels = W.level_ints(black, white)
    ts = torch.tensor([0.0, 0.4, 1.0], dtype=torch.float32, device=cuda)
    pair = KW.pair_blend(f1[0], f1[1], f2[0], f2[1], blurred, ts,
                         geom.res_scalar, w, scale_shift, levels)
    for n in range(3):
        args = (f1[0], f1[1], f2[0], f2[1], blurred, ts[n],
                geom.res_scalar, w, scale_shift, levels)
        before = KF.counts.kernel
        got = KF.fused_blend(*args)
        assert KF.counts.kernel == before + 1
        _equal(got, KF.fused_blend_plain(*args))
        _equal(got, (pair[0][n], pair[1][n]))


# (width, height, stride, radius): res scalars 0 and 1, stride > width, a
# width that is not a multiple of a warp
@pytest.mark.parametrize("w,h,stride,radius", [(320, 180, None, 5),
                                               (320, 180, None, 16),
                                               (640, 360, None, 16),
                                               (320, 180, 352, 16),
                                               (202, 118, None, 16)])
def test_port_equals_the_oracle(cuda, w, h, stride, radius):
    ts = [0.0, 0.25, 0.5, 0.75]
    cfg = synthetic.SyntheticConfig(width=w, height=h, stride=stride)
    a, b = list(synthetic.gradient_pan(cfg, 2, vx=3, vy=1))
    geom = F.FlowGeometry.create(h, a.fmt.stride, w)
    off_o, blur_o = oracle.calculate_optical_flow(
        a.y, a.uv, b.y, b.uv, radius, geom.res_scalar, geom.low_h,
        geom.low_w)
    da, db = frame_to_device(a, cuda), frame_to_device(b, cuda)
    off, blurred = F.flow(geom, da.y, da.u, da.v, db.y, db.u, db.v, radius)
    np.testing.assert_array_equal(off.cpu().numpy(), off_o)
    np.testing.assert_array_equal(blurred.cpu().numpy(), blur_o)
    y, uv = KW.pair_blend(da.y, da.uv, db.y, db.uv, blurred,
                          torch.tensor(ts, dtype=torch.float32, device=cuda),
                          geom.res_scalar, w)
    for n, t in enumerate(ts):
        ry, ruv = oracle.warp_frame(a.y, a.uv, b.y, b.uv, blur_o, t,
                                    oracle.BLENDED_FRAME, geom.res_scalar, w)
        np.testing.assert_array_equal(y[n].cpu().numpy(), ry[:, :w])
        np.testing.assert_array_equal(uv[n].cpu().numpy(), ruv[:, :w])


@pytest.mark.parametrize("w,h,stride,radius", [(320, 180, None, 16),
                                               (202, 118, None, 5),
                                               (320, 180, 352, 16)])
def test_port_equals_the_oracle_p010(cuda, w, h, stride, radius):
    """P010 content that is 8-bit << 8: the flow is the oracle's 8-bit
    flow, and at the default levels each blended output >> 8 is the
    oracle's 8-bit output (t * 2^16 is exact at these positions, so the
    16- and 24-bit blend weights agree)."""
    ts = [0.0, 0.25, 0.5, 0.75]
    kw = dict(width=w, height=h, stride=stride)
    a, b = list(synthetic.gradient_pan(synthetic.SyntheticConfig(**kw), 2,
                                       vx=3, vy=1))
    a16, b16 = list(synthetic.gradient_pan(synthetic.SyntheticConfig(
        pixfmt="p010", **kw), 2, vx=3, vy=1))
    geom = F.FlowGeometry.create(h, a.fmt.stride, w)
    off_o, blur_o = oracle.calculate_optical_flow(
        a.y, a.uv, b.y, b.uv, radius, geom.res_scalar, geom.low_h,
        geom.low_w)
    da, db = frame_to_device(a16, cuda), frame_to_device(b16, cuda)
    assert da.y.dtype == torch.uint16
    off, blurred = F.flow(geom, da.y, da.u, da.v, db.y, db.u, db.v, radius,
                          luma_shift=8)
    np.testing.assert_array_equal(off.cpu().numpy(), off_o)
    np.testing.assert_array_equal(blurred.cpu().numpy(), blur_o)
    ys, uvs = KW.pair_blend(da.y, da.uv, db.y, db.uv, blurred,
                            torch.tensor(ts, dtype=torch.float32,
                                         device=cuda),
                            geom.res_scalar, w, 8)
    for n, t in enumerate(ts):
        ry, ruv = oracle.warp_frame(a.y, a.uv, b.y, b.uv, blur_o, t,
                                    oracle.BLENDED_FRAME, geom.res_scalar, w)
        y16 = KF.fused_blend(da.y, da.uv, db.y, db.uv, blurred,
                             torch.tensor(t, device=cuda), geom.res_scalar,
                             w, 8)
        for got in ((ys[n], uvs[n]), y16):
            np.testing.assert_array_equal(got[0].cpu().numpy() >> 8,
                                          ry[:, :w])
            np.testing.assert_array_equal(got[1].cpu().numpy() >> 8,
                                          ruv[:, :w])


@pytest.mark.parametrize("source,scene,pixfmt,sampling,levels", [
    ("moving_box", False, "nv12", "pair", (0.0, 255.0)),
    ("scene_cut", True, "nv12", "pair", (0.0, 255.0)),
    ("moving_box", True, "p010", "fused", (16.5, 235.0)),
    ("scene_cut", True, "p010", "pair", (16.5, 235.0)),
    ("scene_cut", True, "p010", "fused", (16.0, 235.0))])
def test_engine_on_the_card_equals_the_cpu(cuda, source, scene, pixfmt,
                                           sampling, levels):
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                    pixfmt=pixfmt)
    engines = [E.InterpolationEngine(E.EngineConfig(
        device=d, display_fps=60.0, auto_quality=False,
        scene_detection=scene, initial_search_radius=16,
        warp_sampling=sampling, black_level=levels[0],
        white_level=levels[1]))
        for d in ("cpu", str(cuda))]
    for frame in getattr(synthetic, source)(cfg, 8):
        outs = [e.push(frame) for e in engines]
        assert len(outs[0]) == len(outs[1])
        for a, b in zip(*outs):
            assert a.pts == b.pts
            fa, fb = a.to_video_frame(), b.to_video_frame()
            np.testing.assert_array_equal(fa.y, fb.y)
            np.testing.assert_array_equal(fa.uv, fb.uv)
    assert engines[0].scene_cuts() == engines[1].scene_cuts()


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("h,w,stride", [(48, 64, 80), (544, 96, 96),
                                        (118, 202, 202)])
def test_sample_dir(cuda, scale_shift, h, w, stride):
    rng = np.random.default_rng(h + w + scale_shift + 1)
    dt = np.uint16 if scale_shift else np.uint8
    geom = F.FlowGeometry.create(h, stride, w)
    f1 = _frames(rng, h, stride, cuda, dt)
    f2 = _frames(rng, h, stride, cuda, dt)
    blurred = torch.from_numpy(rng.integers(
        -70, 71, (2, geom.low_h, geom.low_w)).astype(np.int32)).to(cuda)
    for direction in (12, 21):
        for t in (0.0, 0.4, 1.0):
            args = (f1[0], f1[1], f2[0], f2[1], blurred,
                    torch.tensor(t, device=cuda), direction,
                    geom.res_scalar, w)
            before = KD.counts.kernel
            got = KD.sample_dir(*args)
            assert KD.counts.kernel == before + 1
            _equal(got, KD.sample_dir_plain(*args))


@pytest.mark.parametrize("w,h,stride,radius", [(320, 180, None, 16),
                                               (202, 118, None, 5),
                                               (320, 180, 352, 16)])
def test_sample_dir_equals_the_oracle(cuda, w, h, stride, radius):
    """Modes 0 and 1 are K5's raw samples: the oracle's warp12 / warp21."""
    cfg = synthetic.SyntheticConfig(width=w, height=h, stride=stride)
    a, b = list(synthetic.gradient_pan(cfg, 2, vx=3, vy=1))
    geom = F.FlowGeometry.create(h, a.fmt.stride, w)
    _, blur_o = oracle.calculate_optical_flow(
        a.y, a.uv, b.y, b.uv, radius, geom.res_scalar, geom.low_h,
        geom.low_w)
    da, db = frame_to_device(a, cuda), frame_to_device(b, cuda)
    blurred = torch.from_numpy(blur_o.astype(np.int32)).to(cuda)
    for mode, direction in ((oracle.WARPED_FRAME_12, 12),
                            (oracle.WARPED_FRAME_21, 21)):
        for t in (0.0, 0.25, 0.5, 0.75):
            y, uv = KD.sample_dir(da.y, da.uv, db.y, db.uv, blurred,
                                  torch.tensor(t, device=cuda), direction,
                                  geom.res_scalar, w)
            ry, ruv = oracle.warp_frame(a.y, a.uv, b.y, b.uv, blur_o, t,
                                        mode, geom.res_scalar, w)
            np.testing.assert_array_equal(y.cpu().numpy(), ry[:, :w])
            np.testing.assert_array_equal(uv.cpu().numpy(), ruv[:, :w])


def test_pack_probe(cuda):
    PP.counts.reset()
    assert PP.main([]) == 0
    # every probe in one launch of one kernel
    assert PP.counts.kernel == 1 and PP.counts.plain == 0


def test_pack_probe_each_probe_alone_and_through_a_mask(cuda):
    """Each probe alone (a mask of one) equals its plain version and its
    slice of the all-probe launch, at shifts that wrap, sit on the 16-byte
    grid and leave it; a mask whose probes are not contiguous in the grid
    gives the same; the C entry refuses a bad mask, a shift out of range
    and a misaligned pointer."""
    x = PP.make_inputs(2, cuda)
    for shifts in ((5, 7), (0, 0), (16, 4), (17, 1), (PP.C - 1, PP.R - 1)):
        every = PP.run_all(x, *shifts)
        for i, key in enumerate(PP.PROBES):
            alone = PP.run(*key, x, *shifts)
            _equal([alone, every[i]], [PP.plain_at(i, x, *shifts), alone])
        picked = (9, 0, 4, 7)
        _equal(PP.run_many([PP.PROBES[i] for i in picked], x, *shifts),
               [every[i] for i in picked])
    from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
    lib = _build.load()
    out = torch.empty((PP.R // 4, PP.C), dtype=torch.int32, device=cuda)
    table = (ctypes.c_void_p * len(PP.PROBES))(out.data_ptr())
    ins = [x[k].data_ptr() for k in PP.INPUTS]
    stream = _build.stream_of(out)
    for args in ((ins, 0, 5, 7), (ins, 1 << len(PP.PROBES), 5, 7),
                 (ins, 1, PP.C, 7), (ins, 1, -1, 7), (ins, 1, 5, PP.R),
                 ([ins[0] + 1] + ins[1:], 1, 5, 7)):
        assert lib.mfi_probe_run(*args[0], table, *args[1:], stream) == 1
    torch.cuda.synchronize()


def test_dma_probe(cuda):
    rows = DP.matrix(cuda)
    assert DP.passed(rows)
    assert DP.verdicts(rows) == DP.H100_VERDICTS
    # what the host's rule lets through runs on the card, and is right
    for (dtype, _, dx, _, cols), res in rows:
        item = torch.empty((), dtype=dtype).element_size()
        legal = DP.cp_async_width(dx * item, cols * item, DP.W * item)
        assert (res["cp.async"] == "OK") == (legal is not None)


def test_dma_stall_by_construction_traps(cuda):
    """A TMA load that never starts leaves its barrier waiting: the
    bounded wait traps and the child's context dies."""
    res = DP._finish_child(DP._start_child("TMA", 0, 1 << 16, False))
    assert res.startswith("REJECTED by the card"), res


@pytest.mark.parametrize("source,pixfmt,sampling,levels,mode", [
    ("moving_box", "nv12", "pair", (0.0, 255.0), 0),
    ("scene_cut", "p010", "pallas", (16.5, 235.0), 0),
    ("scene_cut", "nv12", "pallas", (0.0, 255.0), 1),
    ("moving_box", "p010", "pair", (0.0, 255.0), 1),
    ("scene_cut", "nv12", "pallas", (16.5, 235.0), 2),
    ("moving_box", "p010", "pallas", (16.0, 235.0), 2),
    ("moving_box", "nv12", "pallas", (0.0, 255.0), 2),
    ("scene_cut", "p010", "pair", (16.5, 235.0), 3),
    ("moving_box", "nv12", "pallas", (0.0, 255.0), 3),
    ("scene_cut", "p010", "pallas", (0.0, 255.0), 3),
    ("moving_box", "nv12", "pair", (0.0, 255.0), 4),
    ("scene_cut", "p010", "pallas", (0.0, 255.0), 4)])
def test_engine_modes_on_the_card_equal_the_cpu(cuda, source, pixfmt,
                                                sampling, levels, mode):
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                    pixfmt=pixfmt)
    engines = [E.InterpolationEngine(E.EngineConfig(
        device=d, display_fps=60.0, frame_output_mode=mode,
        auto_quality=False, initial_search_radius=16,
        warp_sampling=sampling, black_level=levels[0],
        white_level=levels[1]))
        for d in ("cpu", str(cuda))]
    before = (KG.counts.kernel, KB.counts.kernel, KB.counts.fused,
              KV.hsv_counts.kernel, KD.counts.kernel)
    outputs = 0
    for frame in getattr(synthetic, source)(cfg, 8):
        outs = [e.push(frame) for e in engines]
        assert len(outs[0]) == len(outs[1])
        outputs += len(outs[1])
        for a, b in zip(*outs):
            assert a.pts == b.pts
            fa, fb = a.to_video_frame(), b.to_video_frame()
            for p, q in ((fa.y, fb.y), (fa.uv, fb.uv)):
                if mode == 3:     # float colours: the JAX tolerance
                    assert np.mean(np.abs(p.astype(int) - q.astype(int))
                                   > 2) < 0.005
                else:
                    np.testing.assert_array_equal(p, q)
    # the blur ran inside every pair's pyramid launch, never on its own;
    # G1 once an output in mode 2 under "pallas" (the first frame passes
    # through), never elsewhere; mode 3 V2 once an output and no K5
    blends = mode == 2 and sampling == "pallas"
    assert KB.counts.kernel == before[1]
    assert KB.counts.fused - before[2] == 7
    assert KG.counts.kernel - before[0] == (outputs - 1 if blends else 0)
    assert KV.hsv_counts.kernel - before[3] == (outputs - 1 if mode == 3
                                                else 0)
    if mode == 3:
        assert KD.counts.kernel == before[4]


def test_frame_to_device_keeps_the_chroma_split(cuda):
    cfg = synthetic.SyntheticConfig(width=64, height=48, stride=80)
    frame = next(synthetic.gradient_pan(cfg, 1))
    dev = frame_to_device(frame, cuda)
    assert dev.y.is_cuda and dev.u.is_contiguous()
    np.testing.assert_array_equal(dev.v.cpu().numpy(), frame.uv[:, 1::2])
    assert dev.fmt == frame.fmt


# --- Q1 (hopperq / hopperxq) and G1's occlusion variant ---------------------

def _mirror(pos, dim):
    res = np.where(pos >= dim - 1, pos - (pos - (dim - 2)) * 2, pos)
    res = np.where(pos < 1, -pos + 1, res)
    return np.clip(res, 1, dim - 2)


def _iround(x):
    return (np.sign(x) * np.floor(np.abs(x) + np.float32(0.5))).astype(
        np.int32)


def q1_model(f1y, f1uv, f2y, f2uv, blurred, t, rs, wa, scale_shift=0,
             levels=(0, 255), occlusion=False, frac=None):
    """csrc/warp_bilinear.cu's arithmetic in NumPy, addressed as the kernel's
    per-sample step addresses each output sample: the flow and
    back-projected reverse flow at the sample's cell (the kernel reads them
    once a flow-cell segment of its 16-byte run, the same cell; the runs
    themselves are modelled in tests/test_torch_bilinear_runs.py),
    1/64-pel positions from one float32 product each, chroma read from the
    interleaved plane at column 2x + parity of the half-width position x,
    the taps mirrored, the float32 blend in the JAX order, the occlusion
    correction and the level maps.  With `frac`
    (the sub-pel field) each flow is (flow << 6) + frac, the reverse frac
    read at the back-projected cell, scaled by t (chroma t * 0.5).
    Returns (y, uv) of the planes' dtype."""
    t = np.float32(t)
    fs21 = np.float32(1.0) - t
    inv = np.float32(1.0 / 4096.0)
    k, w = levels
    cap = 255 << scale_shift
    _, lh, lw = blurred.shape
    outs = []
    for chroma, p1, p2 in ((False, f1y, f2y), (True, f1uv, f2uv)):
        rows = p1.shape[0]
        cy, cx = np.mgrid[0:rows, 0:wa]
        if chroma:
            scx = np.minimum((cx >> rs) & ~1, lw - 1)
            scy = np.minimum((cy >> rs) << 1, lh - 1)
        else:
            scx, scy = np.minimum(cx >> rs, lw - 1), np.minimum(cy >> rs,
                                                                 lh - 1)
        ox, oy = blurred[0][scy, scx], blurred[1][scy, scx]
        bscy = np.clip(scy - (oy >> rs), 0, lh - 1)
        bscx = np.clip(scx - (ox >> rs), 0, lw - 1)
        ox21, oy21 = blurred[0][bscy, bscx], blurred[1][bscy, bscx]
        unit = np.float32(32.0 if chroma else 64.0)
        if frac is not None:
            ox, oy = (ox << 6) + frac[0][scy, scx], (oy << 6) + frac[1][
                scy, scx]
            ox21 = (ox21 << 6) + frac[0][bscy, bscx]
            oy21 = (oy21 << 6) + frac[1][bscy, bscx]
            unit = np.float32(0.5 if chroma else 1.0)
        s12, s21 = t * unit, fs21 * unit
        bx, by = ((cx >> 1) if chroma else cx) << 6, cy << 6
        dim_x = wa >> 1 if chroma else wa
        cstep, cpar = (2, cx & 1) if chroma else (1, 0)

        def tap(src, py, px):
            y0, x0, fy, fx = py >> 6, px >> 6, py & 63, px & 63
            r0, r1 = _mirror(y0, rows), _mirror(y0 + 1, rows)
            c0 = _mirror(x0, dim_x) * cstep + cpar
            c1 = _mirror(x0 + 1, dim_x) * cstep + cpar
            s = src.astype(np.int32)
            top = s[r0, c0] * (64 - fx) + s[r0, c1] * fx
            bot = s[r1, c0] * (64 - fx) + s[r1, c1] * fx
            return top * (64 - fy) + bot * fy

        f32 = np.float32
        q12 = tap(p1, by + _iround(oy.astype(f32) * s12),
                  bx + _iround(ox.astype(f32) * s12))
        q21 = tap(p2, by - _iround(oy21.astype(f32) * s21),
                  bx - _iround(ox21.astype(f32) * s21))
        a, b = q12.astype(f32), q21.astype(f32)
        val = (a * fs21 + b * t) * inv
        bl = np.floor(val + f32(0.5)).astype(np.int64)
        if occlusion:
            s12i = np.floor(a * inv + f32(0.5)).astype(np.int64)
            s21i = np.floor(b * inv + f32(0.5)).astype(np.int64)
            near = s12i if t < 0.5 else s21i
            al = np.clip(((np.abs(s12i - s21i) >> scale_shift) - 32) * 4, 0,
                         256)
            bl = (bl * (256 - al) + near * al) >> 8
        if chroma:
            m = 128 << scale_shift
            n = (bl - m) * 255 + m * max(w, 1)
            d = max(w, 1)
        else:
            n, d = (bl - (k << scale_shift)) * 255, max(w - k, 1)
        if (chroma and w == 255) or (not chroma and (k, w) == (0, 255)):
            out = np.minimum(bl, cap)
        else:
            out = np.where(n <= 0, 0, np.minimum(np.maximum(n, 0) // d, cap))
        outs.append(out.astype(p1.dtype))
    return outs[0], outs[1]


def _q1_flow(rng, geom, lim):
    """Blocks of 4 x 4 low-res cells within +-lim, plus single cells that
    reach 4 * lim (wild displacements past every edge)."""
    lh, lw = geom.low_h, geom.low_w
    base = rng.integers(-lim, lim + 1, (2, -(-lh // 4), -(-lw // 4)))
    f = base.repeat(4, 1).repeat(4, 2)[:, :lh, :lw]
    wild = rng.random((2, lh, lw)) < 0.05
    f = np.where(wild, rng.integers(-4 * lim, 4 * lim + 1, (2, lh, lw)), f)
    return f.astype(np.int32)


@pytest.mark.parametrize("scale_shift,levels", [(0, (0.0, 255.0)),
                                                (8, (16.0, 235.0)),
                                                (0, (16.5, 235.0))])
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("h,w,stride", [(48, 64, 80), (118, 202, 202),
                                        (544, 96, 96), (64, 34, 48)])
def test_bilinear_blend(cuda, scale_shift, levels, occlusion, h, w, stride):
    """Q1 against its plain version and q1_model: res scalars 0 and 2,
    stride wider than the picture, flows within +-3, +-40 and +-400 with
    wild cells, t in {0, 0.2, 0.5, 0.8, 1} (and one odd value)."""
    rng = np.random.default_rng(h * w + stride + scale_shift)
    dt = np.uint16 if scale_shift else np.uint8
    geom = F.FlowGeometry.create(h, stride, w)
    f1 = _frames(rng, h, stride, cuda, dt)
    f2 = _frames(rng, h, stride, cuda, dt)
    levels = W.level_ints(*levels)
    host = [p.cpu().numpy() for p in (*f1, *f2)]
    for lim in (3, 40, 400):
        flow = _q1_flow(rng, geom, lim)
        blurred = torch.from_numpy(flow).to(cuda)
        for t in (0.0, 0.2, 0.5, 0.8, 1.0, 0.37):
            args = (f1[0], f1[1], f2[0], f2[1], blurred,
                    torch.tensor(t, device=cuda), geom.res_scalar, w,
                    scale_shift, levels, occlusion)
            before = KQ.counts.kernel
            got = KQ.bilinear_blend(*args)
            assert KQ.counts.kernel == before + 1
            _equal(got, KQ.bilinear_blend_plain(*args))
            _equal(got, KQ.bilinear_blend(*args, vector=False))
            model = q1_model(*host, flow, t, geom.res_scalar, w,
                             scale_shift, levels, occlusion)
            for g, m in zip(got, model):
                np.testing.assert_array_equal(g.cpu().numpy(), m)


@pytest.mark.parametrize("scale_shift,levels", [(0, (0.0, 255.0)),
                                                (8, (16.0, 235.0))])
@pytest.mark.parametrize("h,w,stride,vec8,vec16", _RUN_SHAPES)
def test_bilinear_blend_runs(cuda, scale_shift, levels, h, w, stride, vec8,
                             vec16):
    """Q1's 16-byte runs and its per-sample launch (vector=False), each
    bit-exact with the plain version, hopperq and hopperxq with the sub-pel
    field: flows within +-3 (most runs interior) and +-40 with wild cells,
    t in {0, 0.4, 0.9999, 1}, res scalars 0-3."""
    rng = np.random.default_rng(h + w + stride + scale_shift + 5)
    dt = np.uint16 if scale_shift else np.uint8
    geom = F.FlowGeometry.create(h, stride, w)
    f1 = _frames(rng, h, stride, cuda, dt)
    f2 = _frames(rng, h, stride, cuda, dt)
    levels = W.level_ints(*levels)
    for lim in (3, 40):
        blurred = torch.from_numpy(_q1_flow(rng, geom, lim)).to(cuda)
        frac = torch.from_numpy(rng.integers(-32, 33, tuple(blurred.shape))
                                .astype(np.int32)).to(cuda)
        for fr, occlusion in ((None, False), (frac, True)):
            for t in (0.0, 0.4, 0.9999, 1.0):
                args = (f1[0], f1[1], f2[0], f2[1], blurred,
                        torch.tensor(t, device=cuda), geom.res_scalar, w,
                        scale_shift, levels, occlusion, fr)
                before = KQ.counts.kernel
                got = KQ.bilinear_blend(*args)
                assert KQ.counts.kernel == before + 1
                assert KW.vector_path((*f1, *f2, *got), w) == (
                    vec16 if scale_shift else vec8)
                _equal(got, KQ.bilinear_blend_plain(*args))
                _equal(got, KQ.bilinear_blend(*args, vector=False))


@pytest.mark.parametrize("scale_shift", [0, 8])
@pytest.mark.parametrize("levels", [(0.0, 255.0), (16.0, 235.0)])
@pytest.mark.parametrize("h,w,stride,vec8,vec16", _RUN_SHAPES)
def test_blend_levels_occlusion_runs(cuda, scale_shift, levels, h, w,
                                     stride, vec8, vec16):
    """G1's occlusion variant (hopperx), 16-byte runs and per sample, on
    K5's two directions with rows that disagree by the whole range, t in
    {0, 0.4, 0.5, 0.6, 1}: bit-exact with the plain version."""
    geom, f1, f2, blurred = _run_case(cuda, h, w, stride, scale_shift)
    levels = W.level_ints(*levels)
    top = 65535 if scale_shift else 255
    for t in (0.0, 0.4, 0.5, 0.6, 1.0):
        tt = torch.tensor(t, device=cuda)
        s12 = KD.sample_dir(*f1, *f2, blurred, tt, 12, geom.res_scalar, w)
        s21 = KD.sample_dir(*f1, *f2, blurred, tt, 21, geom.res_scalar, w)
        for p, v in ((s12[0][:2], 0), (s21[0][:1], top), (s21[0][1:2], 0),
                     (s12[1][:1], top)):
            p.copy_(torch.full(p.shape, v, dtype=torch.int32))
        args = (s12[0], s12[1], s21[0], s21[1], tt, scale_shift, levels,
                True)
        before = KG.counts.kernel
        got = KG.blend_levels(*args)
        assert KG.counts.kernel == before + 1
        _equal(got, KG.blend_levels_plain(*args))


@pytest.mark.parametrize("model,mode,sampling,pixfmt,levels", [
    ("hopperx", 2, "pair", "nv12", (0.0, 255.0)),
    ("hopperx", 2, "fused", "p010", (16.0, 235.0)),
    ("hopperq", 2, "pallas", "nv12", (16.5, 235.0)),
    ("hopperq", 2, "pair", "p010", (0.0, 255.0)),
    ("hopperxq", 2, "pair", "nv12", (0.0, 255.0)),
    ("hopperxq", 2, "fused", "p010", (16.0, 235.0)),
    ("blend", 2, "pair", "nv12", (0.0, 255.0)),
    ("repeat", 2, "fused", "p010", (16.0, 235.0)),
    ("hopper", 5, "pair", "nv12", (0.0, 255.0)),
    ("blend", 6, "pair", "p010", (16.0, 235.0)),
    ("hopperq", 6, "pair", "nv12", (0.0, 255.0)),
    ("hopperx", 3, "pair", "nv12", (0.0, 255.0))])
def test_engine_models_on_the_card_equal_the_cpu(cuda, model, mode,
                                                 sampling, pixfmt, levels):
    """Every model family and the side-by-side modes: the engine on the
    card equals the engine on the CPU (mode 3 within the JAX tolerance);
    blend and repeat launch no flow kernel, hopperx two one-direction
    samples and one occlusion blend a position, hopperq/xq one Q1."""
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                    pixfmt=pixfmt, stride=80)
    engines = [E.InterpolationEngine(E.EngineConfig(
        device=d, display_fps=60.0, frame_output_mode=mode, model=model,
        auto_quality=False, initial_search_radius=16,
        warp_sampling=sampling, black_level=levels[0],
        white_level=levels[1]))
        for d in ("cpu", str(cuda))]
    counts = (KS.counts, KD.counts, KG.counts, KQ.counts, KV.sbs_counts,
              KV.hsv_counts)
    before = [c.kernel for c in counts]
    outputs = 0
    for frame in synthetic.scene_cut(cfg, 6):
        outs = [e.push(frame) for e in engines]
        assert len(outs[0]) == len(outs[1])
        outputs += len(outs[1])
        for a, b in zip(*outs):
            assert a.pts == b.pts
            fa, fb = a.to_video_frame(), b.to_video_frame()
            for p, q in ((fa.y, fb.y), (fa.uv, fb.uv)):
                if mode == 3:
                    assert np.mean(np.abs(p.astype(int) - q.astype(int))
                                   > 2) < 0.005
                else:
                    np.testing.assert_array_equal(p, q)
    k1, k5, g1, q1, v1, v2 = (c.kernel - b for c, b in zip(counts, before))
    pairs = 6 if mode == 6 else 5
    warped = outputs if mode == 6 else outputs - 1
    assert k1 == (0 if model in ("blend", "repeat") else pairs)
    if mode == 2:
        assert (k5, g1) == ((2 * warped, warped) if model == "hopperx"
                            else (0, 0))
        assert q1 == (warped if model in ("hopperq", "hopperxq") else 0)
    else:
        # modes 3, 5 and 6: their own kernel once an output, under any
        # model, and no other warp kernel
        assert (k5, g1, q1) == (0, 0, 0)
        assert (v1, v2) == ((0, warped) if mode == 3 else (warped, 0))


@pytest.mark.parametrize("dt,luma_shift", [(np.uint8, 0), (np.uint16, 8)])
@pytest.mark.parametrize("h,w,stride,mcr", [(118, 202, 202, 270),
                                            (544, 96, 96, 270),
                                            (48, 64, 80, 270),
                                            (48, 64, 64, 2)])
def test_flow_pyramid_layer_counts(cuda, dt, luma_shift, h, w, stride, mcr):
    """Every instantiation of the pyramid kernel (5, 8 and 16 layers, and
    16-layer chunks above radius 16) against the plain pyramid: each
    radius under each layer count that serves it, radii up to 256 (whose
    candidates reach past every edge), with the blur phase on some."""
    rng = np.random.default_rng(h * w + luma_shift + 11)
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    windows = geom.window_schedule() or (2, 1)
    y1, uv1 = _frames(rng, h, stride, cuda, dt)
    y2, uv2 = _frames(rng, h, stride, cuda, dt)
    u1, v1 = uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    for radius, layer_counts in ((2, (5, 8, 16)), (5, (5, 16)), (6, (8,)),
                                 (8, (8, 16)), (11, (16,)), (17, (17,)),
                                 (24, (24, 32)), (33, (64,)), (64, (64,)),
                                 (256, (256,))):
        args = (y1, u1, v1, *probe, radius, 8, 6, windows, 1,
                geom.res_scalar, geom.height, geom.stride, luma_shift)
        want = KS.flow_pyramid_plain(*args)
        for layers in layer_counts:
            blur = layers == layer_counts[-1]
            before = (KS.counts.kernel, KB.counts.fused)
            got = KS.flow_pyramid(*args, blur=blur, layers=layers)
            assert (KS.counts.kernel, KB.counts.fused) == (
                before[0] + 1, before[1] + int(blur))
            if blur:
                _equal(got, [want, KB.blur_flow_plain(want)])
            else:
                _equal([got], [want])


def test_flow_pyramid_occupancy(cuda):
    """Each instantiation keeps K1's cooperative grid: 4 blocks an SM (the
    launch bounds), so every tile of a 4K field is resident."""
    for sample in (1, 2):
        for layers, radius in ((5, 5), (8, 8), (16, 16), (64, 64)):
            for subpel in (False, True):
                assert KS.blocks_per_sm(sample, layers, radius,
                                        subpel) >= 4


@pytest.mark.parametrize("dt,luma_shift", [(np.uint8, 0), (np.uint16, 8)])
@pytest.mark.parametrize("h,w,stride,mcr", [(118, 202, 202, 270),
                                            (544, 96, 96, 270),
                                            (48, 64, 80, 270),
                                            (48, 64, 64, 2),
                                            (256, 12, 12, 64),
                                            (2160, 3840, 3840, 270)])
def test_subpel_refine(cuda, dt, luma_shift, h, w, stride, mcr):
    """S1 against its plain version: fields from the pyramid, fields of
    wild offsets (probes past every edge), low-res fields below the
    window's reach (2 x 2, 64 x 3) and the 4K field; uint8 and uint16."""
    from mpv_frame_interpolator_tpu_torch.ops.cuda import subpel as KP
    rng = np.random.default_rng(h * w + luma_shift + 13)
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    lh, lw = geom.low_h, geom.low_w
    y1, uv1 = _frames(rng, h, stride, cuda, dt)
    y2, uv2 = _frames(rng, h, stride, cuda, dt)
    u1, v1 = uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    pyramid = KS.flow_pyramid_plain(
        y1, u1, v1, *probe, 8, 8, 6, geom.window_schedule() or (2, 1), 4,
        geom.res_scalar, geom.height, geom.stride, luma_shift)
    wild = torch.from_numpy(rng.integers(-300, 301, (2, lh, lw)).astype(
        np.int32)).to(cuda)
    small = torch.from_numpy(rng.integers(-2, 3, (2, lh, lw)).astype(
        np.int32)).to(cuda)
    for offset in (pyramid, wild, small):
        args = (offset, y1, u1, v1, *probe, geom.res_scalar, geom.height,
                geom.stride, luma_shift)
        before = KP.counts.kernel
        got = KP.subpel_refine(*args)
        assert KP.counts.kernel == before + 1
        _equal([got], [KP.subpel_refine_plain(*args)])


@pytest.mark.parametrize("scale_shift,levels", [(0, (0.0, 255.0)),
                                                (8, (16.0, 235.0))])
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("h,w,stride", [(48, 64, 80), (544, 96, 96),
                                        (64, 34, 48)])
def test_bilinear_blend_frac(cuda, scale_shift, levels, occlusion, h, w,
                             stride):
    """Q1 with a sub-pel field (its kFrac instantiation) against its plain
    version and q1_model; a zero field gives Q1 without one."""
    rng = np.random.default_rng(h * w + stride + scale_shift + 17)
    dt = np.uint16 if scale_shift else np.uint8
    geom = F.FlowGeometry.create(h, stride, w)
    f1 = _frames(rng, h, stride, cuda, dt)
    f2 = _frames(rng, h, stride, cuda, dt)
    levels = W.level_ints(*levels)
    host = [p.cpu().numpy() for p in (*f1, *f2)]
    for lim in (3, 400):
        flow = _q1_flow(rng, geom, lim)
        frac = rng.integers(0, 64, flow.shape).astype(np.int32)
        blurred = torch.from_numpy(flow).to(cuda)
        frac_d = torch.from_numpy(frac).to(cuda)
        for t in (0.0, 0.2, 0.5, 0.8, 1.0, 0.37):
            args = (f1[0], f1[1], f2[0], f2[1], blurred,
                    torch.tensor(t, device=cuda), geom.res_scalar, w,
                    scale_shift, levels, occlusion)
            before = KQ.counts.kernel
            got = KQ.bilinear_blend(*args, frac_d)
            assert KQ.counts.kernel == before + 1
            _equal(got, KQ.bilinear_blend_plain(*args, frac_d))
            model = q1_model(*host, flow, t, geom.res_scalar, w,
                             scale_shift, levels, occlusion, frac)
            for g, m in zip(got, model):
                np.testing.assert_array_equal(g.cpu().numpy(), m)
            _equal(KQ.bilinear_blend(*args, torch.zeros_like(frac_d)),
                   KQ.bilinear_blend(*args))


@pytest.mark.parametrize("model,pixfmt,levels,subpel,level,radius", [
    ("hopperq", "nv12", (0.0, 255.0), True, 0, 8),
    ("hopperxq", "p010", (16.0, 235.0), True, 0, 5),
    ("hopper", "nv12", (0.0, 255.0), True, 0, 24),
    ("hopperx", "p010", (16.0, 235.0), True, 0, 16),
    ("hopper", "nv12", (0.0, 255.0), False, 1, 5),
    ("hopper", "p010", (16.0, 235.0), False, 2, 5),
    ("hopperq", "nv12", (0.0, 255.0), True, 3, 5),
    ("hopper", "nv12", (0.0, 255.0), False, 0, 64)])
def test_engine_auto_quality_path_on_the_card_equals_the_cpu(
        cuda, model, pixfmt, levels, subpel, level, radius):
    """The sub-pel path, the ladder's rungs (level 3: the blend family)
    and radii above 16: the engine on the card equals the engine on the
    CPU, with its launches: K1 once a pair (none on the blend rung) with
    the blur as its last phase, under subpel_flow S1's phases too (no
    standalone S1 or blur launch)."""
    from mpv_frame_interpolator_tpu_torch.ops.cuda import subpel as KP
    cfg = synthetic.SyntheticConfig(width=64, height=544, fps=24.0,
                                    pixfmt=pixfmt)
    engines = [E.InterpolationEngine(E.EngineConfig(
        device=d, display_fps=60.0, model=model, auto_quality=True,
        initial_search_radius=radius, subpel_flow=subpel,
        black_level=levels[0], white_level=levels[1]))
        for d in ("cpu", str(cuda))]
    for e in engines:
        e.quality.enabled = False       # the level stays where it is set
        e.quality.level = level
    counts = (KS.counts, KP.counts, KB.counts)
    before = [c.kernel for c in counts] + [KB.counts.fused, KP.counts.fused]
    for frame in synthetic.scene_cut(cfg, 6):
        outs = [e.push(frame) for e in engines]
        assert len(outs[0]) == len(outs[1])
        for a, b in zip(*outs):
            assert a.pts == b.pts
            fa, fb = a.to_video_frame(), b.to_video_frame()
            np.testing.assert_array_equal(fa.y, fb.y)
            np.testing.assert_array_equal(fa.uv, fb.uv)
    after = [c.kernel for c in counts] + [KB.counts.fused, KP.counts.fused]
    k1, s1, k3, fused, s1_fused = (a - b for a, b in zip(after, before))
    flows = 0 if level == 3 else 5
    assert k1 == flows
    assert (s1, k3, fused, s1_fused) == (0, 0, flows,
                                         flows if subpel else 0)


# --- the grouped path (CUDA graphs) and staged uploads ----------------------

def test_k1_is_captured_in_a_cuda_graph(cuda):
    """K1's cooperative launch inside a CUDA graph: a replay equals the
    eager launch, and a replay on new inputs follows them."""
    rng = np.random.default_rng(7)
    geom = F.FlowGeometry.create(48, 80, 64)
    ins = [_frames(rng, 48, 80, cuda) for _ in range(2)]
    planes = [(y, uv[:, 0::2].contiguous(), uv[:, 1::2].contiguous())
              for y, uv in ins]
    static = [p.clone() for f in planes for p in f]

    def run():
        return F.flow(geom, *static, 8, layers=8)

    eager = run()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(cuda).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = run()
    g.replay()
    _equal(captured, eager)
    other = [_frames(rng, 48, 80, cuda) for _ in range(2)]
    for dst, src in zip(static, [p for y, uv in other
                                 for p in (y, uv[:, 0::2], uv[:, 1::2])]):
        dst.copy_(src)
    g.replay()
    _equal(captured, run())


GROUP_CASES = [
    *[(m, 2, "pair", "nv12") for m in ("hopper", "hopperx", "hopperq",
                                       "hopperxq", "blend", "repeat")],
    *[("hopper", m, "pair", "nv12") for m in (0, 1, 3, 4, 5, 6)],
    ("hopper", 2, "fused", "p010"), ("hopper", 2, "pallas", "nv12"),
    ("hopperxq", 6, "pair", "p010")]


@pytest.mark.parametrize("model,mode,sampling,pixfmt", GROUP_CASES)
def test_push_many_replays_equal_push(cuda, model, mode, sampling, pixfmt):
    """push_many on the card (captured CUDA graphs, replayed) equals push
    on the card bit for bit, for every family and mode: 24 -> 60 with a
    cut, groups of 4 and 2 pairs (two keys), each key replayed more than
    once, every output checked only after the last replay (a graph's own
    outputs would have been overwritten).  The counters count each
    graph's captured launches once a replay."""
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                    pixfmt=pixfmt, stride=80)
    frames = list(synthetic.scene_cut(cfg, 15, cut_at=9))
    engines = [E.InterpolationEngine(E.EngineConfig(
        device=str(cuda), display_fps=60.0, frame_output_mode=mode,
        model=model, auto_quality=False, initial_search_radius=8,
        warp_sampling=sampling, black_level=16.0, white_level=235.0))
        for _ in range(2)]
    ref = [o for f in frames for o in engines[0].push(f)]
    before = [(c.kernel, getattr(c, "fused", 0)) for c in E._KERNEL_COUNTS]
    got = engines[1].push_many(frames, group_size=4)
    torch.cuda.synchronize()
    _same_frames(ref, got)
    assert engines[0].scene_cuts() == engines[1].scene_cuts() > 0
    stats = engines[1].group_stats
    graphs = engines[1].graph_stats()
    assert stats["captures"] == len(graphs) and stats["replays"] > len(graphs)
    assert all(g["replays"] >= 1 and g["bytes"] > 0 for g in graphs)
    # each replay adds its graph's captured launches; the warm-up before
    # each capture launched the same kernels once eagerly
    after = [(c.kernel, getattr(c, "fused", 0)) for c in E._KERNEL_COUNTS]
    launched = sum(a[0] - b[0] for a, b in zip(after, before))
    assert launched == sum((g["replays"] + 1) * g["kernel_launches"]
                           for g in graphs)


def _same_frames(ref, got):
    """The same pts and host bytes (a passed-through frame's planes stay
    on the host)."""
    assert len(got) == len(ref) > 0
    for a, b in zip(ref, got):
        assert a.pts == b.pts
        fa, fb = a.to_video_frame(), b.to_video_frame()
        np.testing.assert_array_equal(fa.y, fb.y)
        np.testing.assert_array_equal(fa.uv, fb.uv)


# properties set through api.Player just before the frame of that index:
# each lands between two push_many calls, so between two groups
GROUP_SCRIPT = {5: [("black-level", 16), ("white-level", 235)],
                9: [("delta-scalar", 4), ("neighbor-bias-scalar", 2)],
                13: [("scene-threshold", 3.0), ("search-radius", 5)],
                17: [("frame-output-mode", 0), ("scene-detection", False)],
                21: [("frame-output-mode", 2), ("model", "hopperx")],
                25: [("model", "hopper"), ("max-calc-res", 64),
                     ("scene-detection", True)]}


def property_script_groups(device: str, group: int = 4):
    """(push's outputs, push_many's outputs, push_many's engine) of one
    clip under GROUP_SCRIPT, the same properties set on both engines at
    the same frames (on the CPU push_many runs its body eagerly; on a card
    it replays captured graphs, whose key must take every property)."""
    from mpv_frame_interpolator_tpu_torch.api import Player
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                    stride=80)
    frames = list(synthetic.moving_box(cfg, 29))
    players = [Player(E.EngineConfig(
        device=device, display_fps=120.0, auto_quality=False,
        initial_search_radius=16)) for _ in range(2)]
    ref, got = [], []
    cuts = [0, *sorted(GROUP_SCRIPT), len(frames)]
    for a, b in zip(cuts, cuts[1:]):
        for p in players:
            for name, value in GROUP_SCRIPT.get(a, []):
                p.set_property(name, value)
        for f in frames[a:b]:
            ref += players[0].engine.push(f)
        got += players[1].engine.push_many(frames[a:b], group_size=group)
    return ref, got, players[1].engine


def test_property_changes_between_groups_equal_push(cuda):
    """Property changes between push_many groups on the card (levels, both
    scalars, the scene switch and threshold, radius, mode, model,
    max-calc-res) give push's outputs: no graph captured under other
    values is replayed."""
    ref, got, e = property_script_groups(str(cuda))
    torch.cuda.synchronize()
    _same_frames(ref, got)
    assert e.group_stats["captures"] >= len(GROUP_SCRIPT)


def test_no_collection_lands_inside_a_capture(cuda, monkeypatch):
    """A garbage collection during a capture that frees another engine's
    graphs (a reference cycle: a Player and its engine) would destroy a
    graph, which invalidates the capture.  Automatic collection is off
    while a group graph captures; with a collection due at almost every
    allocation and such garbage about, a new engine's captures succeed and
    equal push."""
    import gc
    from mpv_frame_interpolator_tpu_torch.api import Player
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 9))
    begin = torch.cuda.CUDAGraph.capture_begin
    enabled = []

    def capture_begin(self, *args, **kwargs):
        enabled.append(gc.isenabled())
        return begin(self, *args, **kwargs)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                        capture_begin)

    def player():
        return Player(E.EngineConfig(device=str(cuda), display_fps=120.0,
                                     auto_quality=False,
                                     initial_search_radius=8))
    old = player()
    old.engine.push_many(frames, group_size=4)
    assert old.engine.group_stats["captures"] > 0
    del old                     # garbage in a cycle, graphs and all
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        got = player().engine.push_many(frames, group_size=8)
    finally:
        gc.set_threshold(*threshold)
    assert enabled and not any(enabled)
    assert gc.isenabled()
    pushed = player().engine
    ref = [o for f in frames for o in pushed.push(f)]
    torch.cuda.synchronize()
    _same_frames(ref, got)


def test_graph_outputs_survive_the_next_replay(cuda):
    """Outputs of one group are copied out of the graph: replaying the
    same graph for the next group leaves them as they were."""
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 9))
    e = E.InterpolationEngine(E.EngineConfig(
        device=str(cuda), display_fps=120.0, auto_quality=False,
        initial_search_radius=8))
    first = e.push_many(frames[:5], group_size=4)[1:]  # past the first
    snap = [tuple(p.clone() for p in o.device_planes()) for o in first]
    second = e.push_many(frames[5:], group_size=4)    # the same key
    assert e.group_stats["captures"] == 1
    assert e.group_stats["replays"] == 2
    torch.cuda.synchronize()
    for o, s in zip(first, snap):
        _equal(o.device_planes(), s)
    assert not torch.equal(first[-1].device_planes()[0],
                           second[-1].device_planes()[0])


def test_staged_upload_equals_synchronous_upload(cuda):
    """engine.stage from another thread (pinned pool, copy stream, event)
    gives the planes a synchronous upload gives, and push orders the
    compute stream after the copies."""
    import io as _io
    import threading
    from mpv_frame_interpolator_tpu_torch.io import synthetic as PS
    from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool
    from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    cfg = PS.SyntheticConfig(width=640, height=368, fps=24.0)
    buf = _io.BytesIO()
    w = Y4MWriter(buf, 640, 368, 24.0)
    src = list(PS.moving_box(cfg, 6))
    for f in src:
        w.write(f)
    buf.seek(0)
    pool = PinnedPool(4, device=str(cuda))
    assert pool.pinned
    e = E.InterpolationEngine(E.EngineConfig(
        device=str(cuda), display_fps=60.0, auto_quality=False))
    staged = []
    t = threading.Thread(target=lambda: staged.extend(
        e.stage(f) for f in Y4MReader(buf, pool=pool)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and len(staged) == 6
    assert pool.stats()["hits"] > 0 and pool.stats()["lent"] == 0
    for s, f in zip(staged, src):
        ref = frame_to_device(f, cuda)
        torch.cuda.synchronize()
        s.wait_on(torch.cuda.current_stream(cuda))
        _equal((s.y, s.uv, s.u, s.v), (ref.y, ref.uv, ref.u, ref.v))
    assert e.stats.count("upload_time") == 6
    ref_e = E.InterpolationEngine(E.EngineConfig(
        device=str(cuda), display_fps=60.0, auto_quality=False))
    for s, f in zip(staged, src):
        _same_frames(ref_e.push(f), e.push(s))


def test_buffers_are_recycled_only_after_their_copy(cuda):
    """The recycle hook runs only once the frame's copies on the engine's
    copy stream have completed (4K planes: a copy long enough to be
    caught in flight)."""
    from mpv_frame_interpolator_tpu_torch.frame import FrameFormat
    from mpv_frame_interpolator_tpu_torch.frame import VideoFrame
    from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool
    e = E.InterpolationEngine(E.EngineConfig(device=str(cuda)))
    pool = PinnedPool(4, device=str(cuda))
    fmt = FrameFormat(3840, 2160)
    seen = []
    for i in range(4):
        y = pool.get((2160, 3840), np.uint8)
        uv = pool.get((1080, 3840), np.uint8)
        y.fill(i)
        uv.fill(255 - i)

        def recycle(y=y, uv=uv):
            seen.append(e._copy_stream.query())
            pool.give_back(y)
            pool.give_back(uv)

        # a long kernel ahead of the copies on the copy stream
        with torch.cuda.stream(e._copy_stream):
            torch.cuda._sleep(10_000_000)
        staged = e.stage(VideoFrame(y, uv, fmt, recycle=recycle))
        torch.cuda.synchronize()
        assert int(staged.y[0, 0]) == i and int(staged.uv[-1, -1]) == 255 - i
    assert seen == [True] * 4


# --- the native ingest rings (page-locked buffers) -------------------------

@pytest.mark.parametrize("container", ["y4m", "mkv"])
def test_native_ring_fills_page_locked_buffers(cuda, tmp_path, container):
    """The C++ reader rings (y4m, and the indexed ring over a raw MKV)
    read into page-locked buffers when the frames go to the card; the
    engine's upload hands each frame back only once its copies have
    completed (a long kernel ahead of them on the copy stream), and the
    uploaded planes are the Python reader's."""
    from mpv_frame_interpolator_tpu_torch.io import ingest
    from mpv_frame_interpolator_tpu_torch.io import synthetic as PS
    from mpv_frame_interpolator_tpu_torch.io.mkv import MKVWriter
    from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    w, h, n = 1920, 1080, 6
    src = list(PS.moving_box(PS.SyntheticConfig(width=w, height=h), n))
    path = str(tmp_path / f"in.{container}")
    with open(path, "wb") as fh:
        if container == "y4m":
            wr = Y4MWriter(fh, w, h, 24.0)
            for f in src:
                wr.write(f)
        else:
            wr = MKVWriter(fh, w, h, 24.0, codec_id="V_UNCOMPRESSED")
            for f in src:       # no colour space: I420 payloads
                wr.add(f.y.tobytes()
                       + np.ascontiguousarray(f.uv[:, 0::2]).tobytes()
                       + np.ascontiguousarray(f.uv[:, 1::2]).tobytes())
            wr.close()
    if container == "y4m":
        ring = ingest.NativeY4MSource(path, device=str(cuda))
    else:
        ring = ingest.open_container(path, device=str(cuda))
        assert isinstance(ring, ingest.NativeIndexedSource)
    assert ring.stats()["pinned"]
    e = E.InterpolationEngine(E.EngineConfig(device=str(cuda)))
    seen = []
    staged = []
    for f in ring:
        assert torch.from_numpy(f.y).is_pinned()
        assert torch.from_numpy(f.uv).is_pinned()
        hook = f.recycle

        def recycle(hook=hook):
            seen.append(e._copy_stream.query())
            hook()

        f.recycle = recycle
        with torch.cuda.stream(e._copy_stream):
            torch.cuda._sleep(10_000_000)
        staged.append(e.stage(f))
    ring.close()
    torch.cuda.synchronize()
    assert seen == [True] * n
    assert ring.stats()["recycled"] == n
    for s, f in zip(staged, src):
        ref = frame_to_device(f, cuda)
        torch.cuda.synchronize()
        _equal((s.y, s.uv), (ref.y, ref.uv))


# --- outputs across streams, the two launch modes, the parallel paths ---

def test_an_output_read_at_once_from_another_thread_is_finished(cuda):
    """A worker thread pushes under a side stream, behind a long kernel
    on that stream, and hands the outputs over at once; the main thread
    reads them straight away.  ``to_video_frame`` waits for the event of
    the stream that made them (not the reader's current stream), so they
    equal the outputs of an engine on the default stream, synchronised."""
    import threading
    from mpv_frame_interpolator_tpu_torch.io import synthetic as PS
    cfg = PS.SyntheticConfig(width=1920, height=1088)
    frames = list(PS.moving_box(cfg, 3))
    config = E.EngineConfig(device=str(cuda), auto_quality=False,
                            initial_search_radius=16)
    ref = E.InterpolationEngine(config)
    want = [o for f in frames for o in ref.push(f)]
    torch.cuda.synchronize()
    want = [o.to_video_frame() for o in want]
    got = []
    eng = E.InterpolationEngine(config)
    side = torch.cuda.Stream(cuda)

    def work():
        with torch.cuda.stream(side):
            for f in frames:
                torch.cuda._sleep(20_000_000)
                got.extend(eng.push(f))

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    read = [o.to_video_frame() for o in got]
    assert len(read) == len(want)
    for a, b in zip(read, want):
        assert a.pts == b.pts
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.uv, b.uv)


@pytest.mark.parametrize("dt,luma_shift", [(np.uint8, 0), (np.uint16, 8)])
@pytest.mark.parametrize("h,w,stride,mcr", [(118, 202, 202, 270),
                                            (48, 64, 80, 270),
                                            (48, 64, 64, 24)])
def test_flow_layer_slice(cuda, dt, luma_shift, h, w, stride, mcr):
    """K1's layer slice against its plain version: every window of the
    pyramid, both axes, with and without the neighbour bias, slices of a
    radius-16 step, and a delta scalar whose sums wrap past 2^31; each
    launch first commits the previous case's pairs of two ranks."""
    rng = np.random.default_rng(h + w)
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    lh, lw = geom.low_h, geom.low_w
    y1, uv1 = _frames(rng, h, stride, cuda, dt)
    y2, uv2 = _frames(rng, h, stride, cuda, dt)
    u1, v1 = uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    field = torch.from_numpy(rng.integers(-9, 10, (2, lh, lw)).astype(
        np.int32)).to(cuda)
    plain = field.cpu()
    host = [t.cpu() for t in (y1, u1, v1, *probe)]
    windows = geom.window_schedule() + (1,)
    sums = torch.zeros((2, KS.slice_sums_words(lh, lw, 16, windows)),
                       dtype=torch.int32, device=cuda)
    gathered = prev = None
    k = 0
    for window in windows:
        for is_y, nb, ds, (z0, n) in ((0, False, 8, (0, 16)),
                                      (1, True, 8, (4, 4)),
                                      (0, True, 23, (8, 8)),
                                      (1, False, 23, (15, 1))):
            step = (window, is_y, nb)
            args = (z0, n, 16, ds, 6, geom.res_scalar, geom.height,
                    geom.stride, luma_shift)
            before = KS.slice_counts.kernel
            got = KS.flow_layer_slice(y1, u1, v1, *probe, field, gathered,
                                      prev, step, *args,
                                      sums=(sums[k & 1], sums[~k & 1]))
            k += 1
            assert KS.slice_counts.kernel == before + 1
            want = KS.flow_layer_slice(
                *host, plain, None if gathered is None else gathered.cpu(),
                prev, step, *args)
            _equal([got, field.cpu()], [want.to(cuda), plain])
            # two ranks' pairs for the next launch's commit: this slice's
            # and the same pairs with other minima
            other = got.clone()
            other[0] = torch.from_numpy(rng.integers(
                -2 ** 31, 2 ** 31, tuple(got[0].shape)).astype(
                    np.int32)).to(cuda)
            gathered, prev = torch.stack((got, other)), (window, is_y)


@pytest.mark.parametrize("dt,luma_shift", [(np.uint8, 0), (np.uint16, 8)])
@pytest.mark.parametrize("h,w,stride,mcr,radius,split", [
    (118, 202, 202, 64, 16, (3, 5, 8)),      # lh, lw odd: 59 x 101
    (118, 202, 202, 64, 16, (12, 4)),
    (48, 64, 64, 24, 24, (12, 12)),          # two ranks at radius 24
    (68, 94, 94, 270, 64, (64,)),            # one rank: 16-layer chunks
    (68, 94, 94, 270, 64, (32, 32)),
    (2160, 3840, 3840, 270, 16, (16,)),
    (2160, 3840, 3840, 270, 16, (5, 5, 6))])
def test_layer_slices_give_the_pyramid_on_the_card(cuda, dt, luma_shift, h,
                                                   w, stride, mcr, radius,
                                                   split):
    """Each rank's launches over a whole pyramid with window 1 at its end
    (a launch a step: the previous step's commit, the slice, on two
    ping-pong sums buffers; the pairs of every rank stacked between steps;
    one commit-only launch), slices of
    3, 4, 5, 6, 8, 12, 16, 32 and 64 layers (the 5-, 8- and 16-layer
    instantiations and the chunk loop): every rank's field equals the
    pyramid kernel's and the plain pyramid's."""
    rng = np.random.default_rng(h + radius + len(split))
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    windows = geom.window_schedule() + (1,)
    y1, uv1 = _frames(rng, h, stride, cuda, dt)
    y2, uv2 = _frames(rng, h, stride, cuda, dt)
    u1, v1 = uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    args = (radius, 8, 6, geom.res_scalar, geom.height, geom.stride,
            luma_shift)
    steps = KS.pyramid_steps(windows, F.FIRST_NEIGHBOR_ITERATION)
    starts = np.cumsum((0,) + split[:-1])
    fields = [torch.zeros((2, geom.low_h, geom.low_w), dtype=torch.int32,
                          device=cuda) for _ in split]
    # each rank's ping-pong sums, as the sharded flow passes them
    sums = [torch.zeros((2, KS.slice_sums_words(geom.low_h, geom.low_w, n,
                                                windows)),
                        dtype=torch.int32, device=cuda) for n in split]
    gathered = prev = None
    before = KS.slice_counts.kernel
    for k, step in enumerate(steps):
        gathered = torch.stack([KS.flow_layer_slice(
            y1, u1, v1, *probe, field, gathered, prev, step, int(z0), n,
            *args, sums=(b[k & 1], b[~k & 1]))
            for field, b, z0, n in zip(fields, sums, starts, split)])
        prev = step[:2]
    for field in fields:
        KS.flow_layer_slice(y1, u1, v1, *probe, field, gathered, prev, None,
                            0, 1, *args)
    assert KS.slice_counts.kernel == before + len(split) * (len(steps) + 1)
    pyr = (y1, u1, v1, *probe, radius, 8, 6, windows,
           F.FIRST_NEIGHBOR_ITERATION, geom.res_scalar, geom.height,
           geom.stride, luma_shift)
    want = KS.flow_pyramid(*pyr)
    if h < 1000:
        _equal([want], [KS.flow_pyramid_plain(*pyr)])
    for field in fields:
        _equal([field], [want])


@pytest.mark.parametrize("dt,luma_shift", [(np.uint8, 0), (np.uint16, 8)])
@pytest.mark.parametrize("h,w,stride,mcr,radius", [
    (118, 202, 202, 270, 5), (48, 64, 80, 270, 16), (544, 96, 96, 270, 24),
    (48, 64, 64, 2, 16), (2160, 3840, 3840, 270, 16)])
def test_flow_pyramid_subpel(cuda, dt, luma_shift, h, w, stride, mcr,
                             radius):
    """The pyramid with S1's phases and the blur in one launch against the
    plain pyramid, subpel_refine_plain and the plain blur, at radius 5, 16
    (the 5- and 16-layer instantiations) and 24 (the chunk loop), one
    launch and no standalone S1 or blur; its timeline has the two
    stamps."""
    from mpv_frame_interpolator_tpu_torch.ops.cuda import subpel as KP
    rng = np.random.default_rng(h * radius + luma_shift)
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    windows = geom.window_schedule() or (2, 1)
    y1, uv1 = _frames(rng, h, stride, cuda, dt)
    y2, uv2 = _frames(rng, h, stride, cuda, dt)
    u1, v1 = uv1[:, 0::2].contiguous(), uv1[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, y2, uv2[:, 0::2].contiguous(),
                            uv2[:, 1::2].contiguous())
    args = (y1, u1, v1, *probe, radius, 8, 6, windows, 4, geom.res_scalar,
            geom.height, geom.stride, luma_shift)
    counts = (KS.counts, KP.counts, KB.counts)
    before = [c.kernel for c in counts] + [KP.counts.fused, KB.counts.fused]
    field, b64 = KS.flow_pyramid(*args, subpel=True)
    after = [c.kernel for c in counts] + [KP.counts.fused, KB.counts.fused]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 1, 1]
    want = KS.flow_pyramid_plain(*args)
    fine = KP.subpel_refine_plain(want, y1, u1, v1, *probe,
                                  geom.res_scalar, geom.height, geom.stride,
                                  luma_shift)
    _equal([field, b64], [want, KB.blur_flow_plain(fine)])
    timeline = torch.zeros(5 + 2 * len(KS.pyramid_steps(windows, 4)),
                           dtype=torch.int64, device=cuda)
    KS.flow_pyramid(*args, timeline=timeline, subpel=True)
    assert bool((timeline.diff() >= 0).all()) and int(timeline[0]) > 0


@pytest.mark.parametrize("scale_shift,levels", [(0, (0.0, 255.0)),
                                                (8, (16.0, 235.0))])
@pytest.mark.parametrize("h,w,stride,parts", [(48, 64, 80, 2),
                                              (544, 96, 96, 4),
                                              (118, 202, 202, 3)])
def test_pair_blend_rows(cuda, scale_shift, levels, h, w, stride, parts):
    """K2's row band against its plain version, and the bands stacked
    against K2's whole planes."""
    rng = np.random.default_rng(h * parts)
    dt = np.uint16 if scale_shift else np.uint8
    geom = F.FlowGeometry.create(h, stride, w)
    y1, uv1 = _frames(rng, h, stride, cuda, dt)
    y2, uv2 = _frames(rng, h, stride, cuda, dt)
    blurred = torch.from_numpy(rng.integers(-30, 31, (2, geom.low_h,
                                                      geom.low_w))
                               .astype(np.int32)).to(cuda)
    ts = torch.tensor([0.0, 0.4, 1.0], dtype=torch.float32, device=cuda)
    lv = W.level_ints(*levels)
    args = (y1, uv1, y2, uv2, blurred, ts, geom.res_scalar, w)
    bands = [KW.pair_blend_rows(*args, r0, r1, scale_shift, lv)
             for r0, r1 in KW.band_rows(h, parts)]
    for (r0, r1), band in zip(KW.band_rows(h, parts), bands):
        _equal(band, KW.pair_blend_rows_plain(*args, r0, r1, scale_shift,
                                              lv))
    whole = KW.pair_blend(*args, scale_shift, lv)
    _equal((torch.cat([b[0] for b in bands], 1),
            torch.cat([b[1] for b in bands], 1)), whole)


@pytest.mark.parametrize("scale_shift,levels", [(0, (0.0, 255.0)),
                                                (8, (16.0, 235.0))])
@pytest.mark.parametrize("h,w,stride,vec8,vec16", _RUN_SHAPES)
def test_pair_blend_rows_runs(cuda, scale_shift, levels, h, w, stride, vec8,
                              vec16):
    """The row band on the run shapes (16-byte and per-sample rows,
    planes ending in part of a block row), the flows of the run tests,
    N = 1, 3 and 5: every split into 1-4 bands and an uneven band, one
    launch each, equal to the plain version's rows, and each split
    stacked equal to K2's whole planes."""
    geom, f1, f2, blurred = _run_case(cuda, h, w, stride, scale_shift)
    lv = W.level_ints(*levels)
    for ts in ([0.4], [0.0, 0.4, 1.0], [0.0, 0.2, 0.4, 0.6, 0.8]):
        args = (f1[0], f1[1], f2[0], f2[1], blurred,
                torch.tensor(ts, device=cuda), geom.res_scalar, w)
        whole = KW.pair_blend(*args, scale_shift, lv)
        splits = [KW.band_rows(h, parts) for parts in (1, 2, 3, 4)]
        for split in splits + [[(2, h - h % 2 - 2)]]:
            bands = []
            for r0, r1 in split:
                before = KW.rows_counts.kernel
                bands.append(KW.pair_blend_rows(*args, r0, r1, scale_shift,
                                                lv))
                assert KW.rows_counts.kernel == before + 1
                _equal(bands[-1], KW.pair_blend_rows_plain(
                    *args, r0, r1, scale_shift, lv))
            if split[0][0] == 0 and split[-1][1] == h:
                _equal((torch.cat([b[0] for b in bands], 1),
                        torch.cat([b[1] for b in bands], 1)), whole)


def test_parity_report_on_the_card(cuda):
    from mpv_frame_interpolator_tpu_torch.utils import parity
    rows = parity.run_parity(parity.FULL_CASES, tuple(parity.MODE_NAMES),
                             device=str(cuda))
    assert len(rows) == 28
    assert [name for name, ok in rows if not ok] == []


def test_parallel_paths_on_the_card_equal_one_engine(cuda):
    """The pair pool on two slots of one card, the multi-stream engine
    (batched dispatch) and the farm, each equal to single engines."""
    from mpv_frame_interpolator_tpu_torch.io import synthetic as PS
    from mpv_frame_interpolator_tpu_torch.parallel.batch import (
        PairParallelPool)
    from mpv_frame_interpolator_tpu_torch.parallel.farm import StreamFarm
    from mpv_frame_interpolator_tpu_torch.parallel.streams import (
        MultiStreamEngine)
    srcs = [list(PS.gradient_pan(PS.SyntheticConfig(width=320, height=180,
                                                    seed=k), 5))
            for k in range(3)]
    config = E.EngineConfig(device=str(cuda), auto_quality=False,
                            measure_timing=False, initial_search_radius=8)

    def single(frames):
        e = E.InterpolationEngine(config)
        return [o.to_video_frame() for f in frames for o in e.push(f)]

    def same(got, want):
        got = [o.to_video_frame() for o in got]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.pts == b.pts
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.uv, b.uv)

    want = [single(s) for s in srcs]
    pool = PairParallelPool(config, devices=(cuda, cuda))
    same(list(pool.run(srcs[0])), want[0])
    ms = MultiStreamEngine(config, n_streams=3, batch_dispatch=True)
    got = [[] for _ in srcs]
    for step in range(5):
        for k, outs in ms.push_batch([s[step] for s in srcs]).items():
            got[k].extend(outs)
    for g, w in zip(got, want):
        same(g, w)
    with StreamFarm(config, n_streams=3) as farm:
        for step in range(5):
            for k, s in enumerate(srcs):
                farm.submit(k, s[step])
        res = farm.drain_all(timeout=120)
    for k, w in enumerate(want):
        same([o for batch in res[k] for o in batch], w)


def test_sharded_step_on_nccl_world_one(cuda):
    from mpv_frame_interpolator_tpu_torch.parallel import dryrun
    res = dryrun.dryrun_multichip(1, device=str(cuda), backend="nccl")
    assert res["equal"]


def test_entry_runs_on_the_card(cuda):
    from mpv_frame_interpolator_tpu_torch.parallel import dryrun
    fn, args = dryrun.entry(device=str(cuda))
    y, u, v = fn(*args)
    torch.cuda.synchronize()
    assert [tuple(p.shape) for p in (y, u, v)] == [(1080, 1920),
                                                   (540, 960), (540, 960)]
    assert all(p.dtype == torch.uint8 and p.is_cuda for p in (y, u, v))


@pytest.mark.parametrize("scale_shift,levels", [(0, (0.0, 255.0)),
                                                (8, (16.0, 235.0))])
@pytest.mark.parametrize("h,w,stride", [(48, 64, 80), (118, 202, 202),
                                        (544, 96, 96), (48, 63, 65)])
def test_warp_views(cuda, scale_shift, levels, h, w, stride):
    """V1 (modes 5 and 6) bit-exact and V2 (mode 3) within the HSV
    tolerance against their plain versions, on random planes (a row of the
    top value) and flows that push cells past every edge, t in {0, 0.4,
    1}: res scalars 0 and 2, a stride wider than the picture and an odd
    one; V2 on a zero flow (no colour, only its integer parts) bit-exact."""
    geom, f1, f2, blurred = _run_case(cuda, h, w, stride, scale_shift)
    top = (1 << (8 << (scale_shift > 0))) - 1
    f1[0][:1].copy_(torch.full((1, stride), top, dtype=torch.int32))
    lv = W.level_ints(*levels)
    zero = torch.zeros_like(blurred)
    for t in (0.0, 0.4, 1.0):
        tt = torch.tensor(t, device=cuda)
        args = (f1[0], f1[1], f2[0], f2[1], blurred, tt, geom.res_scalar, w,
                scale_shift, lv)
        for mode in (5, 6):
            before = KV.sbs_counts.kernel
            got = KV.warp_sbs(mode, *args)
            assert KV.sbs_counts.kernel == before + 1
            _equal(got, KV.warp_sbs_plain(mode, *args))
        before = KV.hsv_counts.kernel
        got = KV.warp_hsv(*args)
        assert KV.hsv_counts.kernel == before + 1
        for g, p in zip(got, KV.warp_hsv_plain(*args)):
            assert g.dtype == p.dtype and g.shape == p.shape
            d = (g.to(torch.int32) - p.to(torch.int32)).abs()
            assert float((d > 2).float().mean()) < 0.005
        args = (*args[:4], zero, *args[5:])
        _equal(KV.warp_hsv(*args), KV.warp_hsv_plain(*args))


def _prologue_case(cuda, h, stride, w, mcr, p010, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint16 if p010 else np.uint8
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    y1, _ = _frames(rng, h, stride, cuda, dt)
    y2, uv2 = _frames(rng, h, stride, cuda, dt)
    return geom, y1, y2, uv2[:, 0::2].contiguous(), uv2[:, 1::2].contiguous()


def _same_prologue(got, want):
    """Score bits, flag, positions and probe bytes equal."""
    assert (got.score is None) == (want.score is None)
    if got.score is not None:
        assert got.score.view(torch.int32).item() == \
            want.score.view(torch.int32).item()
    assert got.cut.dtype == torch.int32 and got.cut.item() == \
        int(want.cut.item())
    assert torch.equal(got.ts.view(torch.int32), want.ts.view(torch.int32))
    assert (got.probe is None) == (want.probe is None)
    if got.probe is not None:
        _equal(got.probe, want.probe)


@pytest.mark.parametrize("h,stride,w,mcr,p010", [
    (48, 80, 64, 270, False), (50, 80, 66, 16, True),
    (60, 88, 70, 8, False), (544, 96, 96, 270, True)])
@pytest.mark.parametrize("scene,policy,repeat", [
    (True, "nearest", False), (True, "hold", False), (True, "hold", True),
    (False, "nearest", True), (False, "nearest", False)])
def test_pair_prologue(cuda, h, stride, w, mcr, p010, scene, policy, repeat):
    """C1 against its plain version on the card: score bits, the flag, the
    count, the folded positions and the probe bytes, at res scalars 0-3,
    strides wider than the picture and heights off the grid, with a cut
    (threshold 0), without one (threshold 300) and at a threshold float32
    cannot hold (28.1), scene detection on and off, each policy and
    repeat; the cached positions never written."""
    geom, y1, y2, u2, v2 = _prologue_case(cuda, h, stride, w, mcr, p010,
                                          h + stride)
    ts = torch.tensor([0.0, 0.2, 0.5, 0.7, 1.0], device=cuda)
    keep = ts.clone()
    for threshold in (0.0, 300.0, 28.1):
        cuts = [torch.zeros((), dtype=torch.int32, device=cuda)
                for _ in range(2)]
        kw = dict(bit_shift=8 if p010 else 0, scene_enabled=scene,
                  threshold=threshold, cut_policy=policy, repeat=repeat)
        before = (KC.counts.kernel, KC.counts.plain)
        got = KC.pair_prologue(geom, y1, y2, u2, v2, ts, cuts[0], **kw)
        assert (KC.counts.kernel, KC.counts.plain) == (before[0] + 1,
                                                       before[1])
        want = KC.pair_prologue_plain(geom, y1, y2, u2, v2, ts, cuts[1],
                                      probe=True, **kw)
        torch.cuda.synchronize()
        _same_prologue(got, want)
        assert cuts[0].item() == cuts[1].item()
        if threshold != 28.1:
            assert cuts[0].item() == int(scene and threshold == 0.0)
        assert torch.equal(ts, keep)


def test_pair_prologue_score_at_28_1(cuda):
    """A score equal to float32(28.1), above its float64 value: no cut
    against a threshold of 28.1, a cut against 28.09."""
    y1 = torch.zeros((40, 64), dtype=torch.uint8, device=cuda)
    y2 = torch.full((40, 64), 28, dtype=torch.uint8, device=cuda)
    y2.view(-1)[:256] = 29
    geom = F.FlowGeometry.create(40, 64, 64)
    uv = torch.zeros((20, 32), dtype=torch.uint8, device=cuda)
    ts = torch.tensor([0.3, 0.6], device=cuda)
    for threshold, cut in ((28.1, 0), (28.09, 1)):
        cuts = torch.zeros((), dtype=torch.int32, device=cuda)
        got = KC.pair_prologue(geom, y1, y2, uv, uv, ts, cuts,
                               threshold=threshold)
        assert got.score.item() == float(np.float32(28.1))
        assert (got.cut.item(), cuts.item()) == (cut, cut)


@pytest.mark.parametrize("shared", [False, True])
def test_pair_prologue_graph_replay(cuda, shared):
    """C1 captured in a CUDA graph and replayed three times on a cut pair:
    each replay equals the eager launch and adds one to the count.  With
    `shared`, every launch takes one scratch, as an engine's pairs do."""
    geom, y1, y2, u2, v2 = _prologue_case(cuda, 60, 88, 70, 8, False, 3)
    ts = torch.tensor([0.25, 0.5, 0.75], device=cuda)
    cuts = torch.zeros((), dtype=torch.int32, device=cuda)
    kw = dict(threshold=1.0,
              partials=KC.scratch(cuda) if shared else None)
    eager = KC.pair_prologue(geom, y1, y2, u2, v2, ts, cuts, **kw)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        KC.pair_prologue(geom, y1, y2, u2, v2, ts, cuts, **kw)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    assert cuts.item() == 2
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = KC.pair_prologue(geom, y1, y2, u2, v2, ts, cuts, **kw)
    for n in range(3):
        g.replay()
        torch.cuda.synchronize()
        _same_prologue(captured, eager)
        assert cuts.item() == 3 + n


@pytest.mark.parametrize("own_scratch", [False, True])
def test_pair_prologue_on_two_streams(cuda, own_scratch):
    """Two engines' prologues at once on two streams, each against its
    plain version: no state is shared between launches.  With
    `own_scratch`, each stream's eight launches share that stream's
    scratch, as an engine's pairs do."""
    cases = [_prologue_case(cuda, 544, 96, 96, 270, p010, 9 + p010)
             for p010 in (False, True)]
    ts = torch.tensor([0.2, 0.4, 0.6, 0.8], device=cuda)
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    cuts = [torch.zeros((), dtype=torch.int32, device=cuda) for _ in cases]
    scratch = [KC.scratch(cuda) if own_scratch else None for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(8):
        for i, (case, stream) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(stream):
                outs[i].append(KC.pair_prologue(
                    *case, ts, cuts[i], bit_shift=8 * i, threshold=1.0,
                    cut_policy=("nearest", "hold")[i],
                    partials=scratch[i]))
    torch.cuda.synchronize()
    for i, case in enumerate(cases):
        want = KC.pair_prologue_plain(
            *case, ts, torch.zeros((), dtype=torch.int32, device=cuda),
            8 * i, True, 1.0, ("nearest", "hold")[i], False, True)
        for got in outs[i]:
            _same_prologue(got, want)
        assert cuts[i].item() == 8


def test_pair_prologue_nothing_to_compute(cuda):
    """No scene detection, no probe and no "repeat": no launch, the
    positions as given; a scratch of the wrong shape is refused."""
    geom, y1, y2, u2, v2 = _prologue_case(cuda, 48, 80, 64, 270, False, 4)
    ts = torch.tensor([0.25, 0.75], device=cuda)
    cuts = torch.zeros((), dtype=torch.int32, device=cuda)
    before = (KC.counts.kernel, KC.counts.plain)
    got = KC.pair_prologue(geom, y1, y2, u2, v2, ts, cuts,
                           scene_enabled=False, probe=False)
    assert (KC.counts.kernel, KC.counts.plain) == before
    assert got.score is None and got.cut is None and got.probe is None
    assert got.ts is ts
    with pytest.raises(ValueError):
        KC.pair_prologue(geom, y1, y2, u2, v2, ts, cuts,
                         partials=KC.scratch(cuda)[1:])


@pytest.mark.parametrize("h,w,stride,mcr,p010", [
    (48, 64, 80, 270, False), (118, 202, 202, 270, True),
    (544, 96, 96, 270, False), (48, 63, 65, 24, True)])
def test_warp_grey(cuda, h, w, stride, mcr, p010):
    """V3 bit-exact against ``ops/warp.grey_planes`` on flows with wide
    and wrapping magnitudes, at widths whose planes end off the 16-byte
    grid."""
    rng = np.random.default_rng(h + w)
    geom = F.FlowGeometry.create(h, stride, w, mcr)
    blurred = rng.integers(-90, 91, (2, geom.low_h, geom.low_w))
    blurred[0, 0, 0] = (1 << 30) + (1 << 29)
    blurred = torch.from_numpy(blurred.astype(np.int32)).to(cuda)
    ss = 8 if p010 else 0
    dt = torch.uint16 if p010 else torch.uint8
    before = KV.grey_counts.kernel
    got = KV.warp_grey(blurred, geom.res_scalar, h, w, ss, dt)
    assert KV.grey_counts.kernel == before + 1
    _equal(got, KV.warp_grey_plain(blurred, geom.res_scalar, h, w, ss, dt))


@pytest.mark.parametrize("pixfmt,sampling,per_pair", [
    ("nv12", "pair", 3), ("p010", "fused", 2)])
def test_main_path_kernel_launches_a_pair(cuda, pixfmt, sampling, per_pair):
    """The engine's pair is C1, K1 and the warp's launches and nothing
    else that a kernel wrapper counts: 3 a pair on the 8-bit main path
    (K2 once a pair), C1 + K1 + one K4 a position under P010 "fused"."""
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0,
                                    pixfmt=pixfmt)
    e, cpu = (E.InterpolationEngine(E.EngineConfig(
        device=dev, display_fps=60.0, auto_quality=False,
        initial_search_radius=8, warp_sampling=sampling))
        for dev in (str(cuda), "cpu"))
    frames = list(synthetic.scene_cut(cfg, 7, cut_at=4))
    for f in frames:
        cpu.push(f)
    e.push(frames[0])
    before = [c.kernel for c in E._KERNEL_COUNTS]
    outputs = sum(len(e.push(f)) for f in frames[1:])
    torch.cuda.synchronize()
    launched = sum(c.kernel for c in E._KERNEL_COUNTS) - sum(before)
    # the card folds the cuts the CPU engine folds on the same clip
    assert e.scene_cuts() == cpu.scene_cuts() >= 1
    pairs = len(frames) - 1
    assert launched == (3 * pairs if sampling == "pair"
                        else per_pair * pairs + outputs)


def _host_spans(prof):
    """(name, start, end) of the main thread's ``mfi.`` host spans, and
    the names of device rows that carry such a name."""
    from torch.autograd import DeviceType
    events = prof.events()
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.name.startswith("mfi.") and e.device_type == DeviceType.CPU]
    device = {e.name for e in events
              if e.name.startswith("mfi.") and e.device_type != DeviceType.CPU}
    return host, device


def _parent(span, spans):
    """The innermost other span that holds `span` (None: none does)."""
    holders = [s for s in spans if s is not span and s[1] <= span[1]
               and span[2] <= s[2]]
    return max(holders, key=lambda s: s[1])[0] if holders else None


@pytest.mark.parametrize("api,pixfmt,sampling", [
    ("push", "nv12", "pair"), ("push", "p010", "fused"),
    ("push_many", "nv12", "pair")])
def test_engine_spans_on_the_card(cuda, api, pixfmt, sampling):
    """One 4K ``push`` (C1, K1, K2 or K4 x5) or ``push_many`` call of 8
    pairs under the profiler opens every documented span of its path,
    each inside its parent: 7 a push pair on the launch plan (C1's and
    K1's intermediates allocated once per key, so no ``mfi.c1.alloc`` or
    ``mfi.k1.alloc``), 17 through the wrappers with 5 positions of K4, 5
    a group; no span leaves a copy of itself among the device rows."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from mpv_frame_interpolator_tpu_torch.utils import trace
    cfg = synthetic.SyntheticConfig(width=3840, height=2160, fps=24.0,
                                    pixfmt=pixfmt)
    ring = [frame_to_device(f, cuda)
            for f in synthetic.moving_box(cfg, 3)]
    frames = [dataclasses.replace(ring[i % 3], pts=i / 24.0)
              for i in range(26)]
    e = E.InterpolationEngine(E.EngineConfig(
        device=str(cuda), display_fps=120.0, auto_quality=False,
        warp_sampling=sampling))
    if api == "push":
        for f in frames[:3]:        # the anchor, an untimed and a timed pair
            e.push(f)
    else:                           # the capture, then a timed replay
        e.push_many(frames[:9], group_size=8)
        e.push_many(frames[9:17], group_size=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if api == "push":
            assert len(e.push(frames[3])) == 5
        else:
            assert len(e.push_many(frames[17:25], group_size=8)) == 40
        torch.cuda.synchronize()
    spans, on_device = _host_spans(prof)
    assert not on_device
    got = sorted((name, _parent(s, spans)) for s in spans
                 for name in [s[0]])
    assert {name for name, _ in got} <= set(trace.SPANS)
    if api == "push_many":
        assert got == sorted([("mfi.push_many", None)] + [
            (n, "mfi.push_many") for n in (
                "mfi.engine.wait", "mfi.group.fill", "mfi.group.replay",
                "mfi.group.copy_out")])
        return
    warp = "mfi.k2" if sampling == "pair" else "mfi.k4"
    launches = 1 if sampling == "pair" else 5
    allocated = () if sampling == "pair" else ("mfi.c1", "mfi.k1")
    assert e.plan_stats["pairs"] == (3 if sampling == "pair" else 0)
    assert got == sorted(
        [("mfi.push", None), ("mfi.engine.wait", "mfi.push"),
         ("mfi.pair", "mfi.push")]
        + [(k, "mfi.pair") for k in ("mfi.c1", "mfi.k1")]
        + [(k + ".alloc", k) for k in allocated]
        + [(warp, "mfi.pair"), (warp + ".alloc", warp)] * launches)
