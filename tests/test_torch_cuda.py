"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small and odd shapes the 4K smoke test does not reach (widths
that are not a multiple of a warp, planes smaller than the blur's reach,
stride wider than the picture, res_scalar 0 and 2), for 8-bit NV12 and
10-bit P010 with black/white levels; the port's flow and blend on the
card against the NumPy oracle (``ops/oracle``, 8-bit; P010 content that
is 8-bit << 8 gives the oracle's flow, and its blend >> 8 the oracle's
blend at blend positions whose 16-bit weight is exact); and the whole
engine on the card against the engine on the CPU.  Bit-exact.

These tests need an NVIDIA card (marker ``gpu``) and skip without one.
They import no jax, so on a machine without it they run as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops import oracle
from mpv_frame_interpolator_tpu_torch.convert import frame_to_device
from mpv_frame_interpolator_tpu_torch.ops import flow as F
from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
from mpv_frame_interpolator_tpu_torch.pipeline import engine as E

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
                                   (136, 24), (270, 480)])
def test_blur(cuda, lh, lw):
    rng = np.random.default_rng(lh * 1000 + lw)
    off = torch.from_numpy(rng.integers(-500, 500, (2, lh, lw)).astype(
        np.int32)).to(cuda)
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


def test_frame_to_device_keeps_the_chroma_split(cuda):
    cfg = synthetic.SyntheticConfig(width=64, height=48, stride=80)
    frame = next(synthetic.gradient_pan(cfg, 1))
    dev = frame_to_device(frame, cuda)
    assert dev.y.is_cuda and dev.u.is_contiguous()
    np.testing.assert_array_equal(dev.v.cpu().numpy(), frame.uv[:, 1::2])
    assert dev.fmt == frame.fmt
