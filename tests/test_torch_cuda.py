"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small and odd shapes the 4K smoke test does not reach (widths
that are not a multiple of a warp, planes smaller than the blur's reach,
stride wider than the picture, res_scalar 0 and 2), the port's flow and
blend on the card against the NumPy oracle (``ops/oracle``), and the whole
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
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
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
        assert torch.equal(x, y)


def _frames(rng, h, stride, dev):
    y = torch.from_numpy(rng.integers(0, 256, (h, stride), dtype=np.uint8))
    uv = torch.from_numpy(rng.integers(0, 256, (h // 2, stride),
                                       dtype=np.uint8))
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


@pytest.mark.parametrize("source,scene", [("moving_box", False),
                                          ("scene_cut", True)])
def test_engine_on_the_card_equals_the_cpu(cuda, source, scene):
    cfg = synthetic.SyntheticConfig(width=64, height=48, fps=24.0)
    engines = [E.InterpolationEngine(E.EngineConfig(
        device=d, display_fps=60.0, auto_quality=False,
        scene_detection=scene, initial_search_radius=16))
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
