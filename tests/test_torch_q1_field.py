"""Q1 on the sub-pel flow's 1/64-pel field whole, on the CPU.

Under ``subpel_flow`` K1 blurs the 1/64-pel field b = (offset << 6) +
frac, and the JAX engine splits it into its floor flow = b >> 6 and frac
= b - (flow << 6), which its bilinear branch puts back together as (flow
<< 6) + frac.  The port hands b to Q1 whole in mode 2 (hopperq, hopperxq;
``bilinear_blend(..., subpel=True)``), so the pair runs no tensor op
between K1 and Q1:

* the plain version on b equals the JAX bilinear branch on its split,
  over random fields of both signs, NV12 and P010, with and without the
  occlusion correction (at whole pels it is Q1 on the flow:
  ``tests/test_torch_subpel.py``);
* ``engine._flow_stage`` gives the bilinear families b whole, flagged as
  1/64 pel, the integer families the rounded flow; ``engine._warp_stage`` on b
  equals the JAX branch on the split in mode 2 and the floor's outputs in
  the other modes;
* every Q1 call of the engine through ``push`` and ``push_many`` takes b
  whole and gives the JAX branch's outputs on its split;
* the wrapper's card path, on meta tensors with a stand-in for the
  kernels' library: ``mfi.q1`` opens around ``mfi.q1.alloc`` and the
  launch under the profiler, the C entry takes the field and the
  ``subpel`` flag, and the spans are in ``utils/trace.SPANS``.

The card's own checks (the kernel on b against the plain version, the
spans of a 4K pair) are in ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpv_frame_interpolator_tpu.frame import interleave_chroma
from mpv_frame_interpolator_tpu.ops import flow as JF
from mpv_frame_interpolator_tpu.ops import warp as JW
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.ops import flow as F
from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_bilinear as KQ
from mpv_frame_interpolator_tpu_torch.pipeline import engine as E
from mpv_frame_interpolator_tpu_torch.utils import trace

torch.set_num_threads(1)

TS = (0.0, 0.2, 0.5, 0.8, 1.0, 0.37)


def _planes(rng, h, stride, scale_shift):
    dt = np.uint16 if scale_shift else np.uint8
    top = 65535 if scale_shift else 255
    return [torch.from_numpy(rng.integers(0, top + 1, shape).astype(dt))
            for shape in ((h, stride), (h // 2, stride)) * 2]


def _field(rng, geom, lim):
    """A 1/64-pel field of both signs: blocks within +-lim pel plus wild
    single cells, each with a random remainder."""
    lh, lw = geom.low_h, geom.low_w
    base = rng.integers(-lim, lim + 1, (2, -(-lh // 4), -(-lw // 4)))
    f = base.repeat(4, 1).repeat(4, 2)[:, :lh, :lw]
    wild = rng.random((2, lh, lw)) < 0.05
    f = np.where(wild, rng.integers(-4 * lim, 4 * lim + 1, (2, lh, lw)), f)
    b = f * 64 + rng.integers(-63, 64, (2, lh, lw))
    assert b.min() < 0 < b.max()
    return torch.from_numpy(b.astype(np.int32))


def _split(field):
    flow = field >> 6
    return flow, field - (flow << 6)


def _jax_split(planes, field, t, width, scale_shift, levels, occlusion,
               max_res=270):
    """The JAX bilinear branch on the split of the 1/64-pel field (the JAX
    engine's ``b64 >> 6`` and remainder, ``_warp_fields(..., frac)``), for
    one position: (y, uv interleaved) as tensors."""
    f1y, f1uv, f2y, f2uv = (p.numpy() for p in planes)
    h, stride = f1y.shape
    geom = JF.FlowGeometry.create(h, stride, width, max_res)
    flow, frac = (x.numpy() for x in _split(field))
    a = [jnp.asarray(x) for x in (f1y, f1uv[:, 0::2], f1uv[:, 1::2], f2y,
                                  f2uv[:, 0::2], f2uv[:, 1::2])]
    # op by op, the levels' lax.cond included: dispatched on its own, a
    # cond compiles its branches anew on every call (~5 compiles a call)
    with jax.disable_jit():
        fields = JW._warp_fields(geom, jnp.asarray(flow), jnp.asarray(frac),
                                 full_res=True)
        y, u, v = JW._warp_sample(
            geom, JW.BLENDED_FRAME, scale_shift, jnp.uint16 if scale_shift
            else jnp.uint8, *a, fields, jnp.float32(float(t)),
            jnp.float32(levels[0]), jnp.float32(levels[1]),
            occlusion_aware=occlusion, bilinear=True, sampling="gather")
    uv = interleave_chroma(np.asarray(u), np.asarray(v))
    return torch.from_numpy(np.array(y)), torch.from_numpy(uv)


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.to(torch.int64), y.to(torch.int64))


@pytest.mark.parametrize("scale_shift,levels", [(0, (0, 255)),
                                                (8, (16, 235))])
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("h,w,stride,max_res", [(48, 64, 80, 270),
                                                (96, 128, 128, 64)])
def test_plain_field64_equals_the_split(scale_shift, levels, occlusion, h, w,
                                        stride, max_res):
    """The plain version on b against the JAX branch on its split."""
    rng = np.random.default_rng(h * w + scale_shift + occlusion)
    geom = F.FlowGeometry.create(h, stride, w, max_res)
    planes = _planes(rng, h, stride, scale_shift)
    for lim in (2, 40):
        field = _field(rng, geom, lim)
        _, frac = _split(field)
        assert int(frac.min()) >= 0 and int(frac.max()) <= 63
        for t in (TS if lim == 2 else TS[1::2]):
            tt = torch.tensor([t], dtype=torch.float32)
            rest = (geom.res_scalar, w, scale_shift, levels, occlusion)
            got = W.bilinear_blend(*planes, field, tt, *rest, True)
            _equal(got, _jax_split(planes, field, t, w, scale_shift,
                                   levels, occlusion, max_res))
            # the wrapper's CPU path is the plain version
            _equal(got, KQ.bilinear_blend(*planes, field, tt, *rest, True))


def _pair(pixfmt, n=2, size=(96, 64)):
    cfg = synthetic.SyntheticConfig(width=size[0], height=size[1], fps=24.0,
                                    pixfmt=pixfmt)
    from mpv_frame_interpolator_tpu_torch.convert import frame_to_device
    return [frame_to_device(f, "cpu") for f in synthetic.moving_box(cfg, n)]


@pytest.mark.parametrize("model", ["hopperq", "hopperxq", "hopper",
                                   "hopperx", "blend"])
def test_flow_stage_gives_the_bilinear_families_the_field_whole(model):
    f1, f2 = _pair("nv12")
    geom = F.FlowGeometry.create(64, 96, 96)
    args = (geom, 0, model, f1, f2, None, None, 8, 8, 6, 8)
    field, subpel = E._flow_stage(*args, subpel=True)
    if model == "blend":
        assert subpel is False and int(field.abs().sum()) == 0
        return
    _, b64 = F.flow(geom, f1.y, f1.u, f1.v, f2.y, f2.u, f2.v, 8,
                    subpel=True)
    if model in ("hopperq", "hopperxq"):
        assert subpel is True and torch.equal(field, b64)
    else:
        assert subpel is False and torch.equal(field, (b64 + 32) >> 6)
    # without subpel_flow every flow family takes the blurred flow
    field, subpel = E._flow_stage(*args, subpel=False)
    assert subpel is False and field.dtype == torch.int32


@pytest.mark.parametrize("model", ["hopperq", "hopperxq"])
@pytest.mark.parametrize("mode", [0, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("pixfmt,levels", [("nv12", (0, 255)),
                                           ("p010", (16, 235))])
def test_warp_stage_on_the_field_equals_the_split(model, mode, pixfmt,
                                                  levels):
    rng = np.random.default_rng(mode + 7)
    shift = 0 if pixfmt == "nv12" else 8
    geom = F.FlowGeometry.create(64, 96, 96)
    planes = _planes(rng, 64, 96, shift)
    field = _field(rng, geom, 3)
    flow, _ = _split(field)
    ts = torch.tensor([0.0, 0.2, 0.4, 0.6000000000000001, 0.8])
    y, uv = E._warp_stage(geom, shift, levels, mode, "pair", model, planes,
                          field, ts, subpel=True)
    if mode == 2:
        want = [_jax_split(planes, field, t, 96, shift, levels,
                           model == "hopperxq") for t in ts.tolist()]
        want_y, want_uv = [a for a, _ in want], [b for _, b in want]
    else:
        want_y, want_uv = E._warp_stage(geom, shift, levels, mode, "pair",
                                        model, planes, flow, ts)
    for i in range(len(ts)):
        _equal((y[i], uv[i]), (want_y[i], want_uv[i]))


@pytest.mark.parametrize("model,pixfmt,levels", [
    ("hopperxq", "p010", (16.0, 235.0)), ("hopperq", "nv12", (0.0, 255.0))])
def test_engine_field_path_equals_the_split_path(monkeypatch, model, pixfmt,
                                                 levels):
    """Every Q1 call of the engine, push then push_many, takes K1's
    1/64-pel field whole and gives the JAX branch's outputs on its
    split."""
    frames = _pair(pixfmt, 7)
    calls = []
    blend = E.bilinear_blend

    def recording(*a, **kw):
        out = blend(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(E, "bilinear_blend", recording)
    e = E.InterpolationEngine(E.EngineConfig(
        device="cpu", display_fps=120.0, auto_quality=False,
        initial_search_radius=8, model=model, subpel_flow=True,
        black_level=levels[0], white_level=levels[1]))
    outs = [o for f in frames[:3] for o in e.push(f)]
    outs += e.push_many(frames[3:], group_size=2)
    assert len(outs) == 1 + 5 * 6     # the first frame's, then 6 pairs
    assert len(calls) == 5 * 6
    for a, kw, got in calls:
        assert not kw and len(a) == 12
        planes, field, t, wa, shift, k_w, occlusion, subpel = (
            a[:4], a[4], a[5], a[7], a[8], a[9], a[10], a[11])
        assert subpel is True and field.dtype == torch.int32
        assert occlusion == (model == "hopperxq")
        _equal(got, _jax_split(planes, field, float(t), wa, shift, k_w,
                               occlusion))


class Entries:
    """A stand-in for the kernels' library: each C entry records its name
    and arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mfi_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _require_here(t, name, dtype, shape=None, device=None):
    """``_build.require`` without its CUDA check."""
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}")


@pytest.fixture
def card_path(monkeypatch):
    """The wrapper's card path on meta tensors (a device that is not the
    CPU and holds no data), with the library's entries recorded."""
    lib = Entries()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "require", _require_here)
    monkeypatch.setattr(_build, "stream_of", lambda t: 7)
    monkeypatch.setattr(KQ.counts, "kernel", KQ.counts.kernel)
    return lib


def _meta_args(scale_shift=8, h=64, w=96):
    dt = torch.uint16 if scale_shift else torch.uint8
    meta = torch.device("meta")
    planes = [torch.empty(shape, dtype=dt, device=meta)
              for shape in ((h, w), (h // 2, w)) * 2]
    field = torch.empty((2, h, w), dtype=torch.int32, device=meta)
    t = torch.empty((1,), dtype=torch.float32, device=meta)
    return planes, field, t


@pytest.mark.parametrize("whole", [True, False])
def test_card_path_opens_the_q1_spans(card_path, whole):
    planes, field, t = _meta_args()
    before = KQ.counts.kernel
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y, uv = KQ.bilinear_blend(*planes, field, t, 0, 96, 8, (16, 235),
                                  True, whole)
    assert (tuple(y.shape), tuple(uv.shape)) == ((64, 96), (32, 96))
    assert y.dtype == torch.uint16 and KQ.counts.kernel == before + 1
    [(name, args)] = card_path.calls
    assert name == "mfi_bilinear_blend"
    assert len(args) == len(_build._SIGNATURES[name])
    # one field pointer, and the flag that says it is in 1/64 pel
    assert args[4] == field.data_ptr() and args[5] == t.data_ptr()
    assert args[8:20] == (64, 96, 96, 64, 96, 0, 8, 16, 235, 1, int(whole),
                          1)
    assert args[20] == 7
    spans = sorted((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("mfi."))
    assert [s[0] for s in spans] == ["mfi.q1", "mfi.q1.alloc"]
    assert {s[0] for s in spans} <= set(trace.SPANS)
    outer, alloc = spans
    assert outer[1] <= alloc[1] and alloc[2] <= outer[2]


def test_card_path_checks_the_field(card_path):
    planes, field, t = _meta_args()
    with pytest.raises(ValueError, match="blurred"):
        KQ.bilinear_blend(*planes, field.to(torch.int64), t, 0, 96, 8,
                          subpel=True)
    assert not card_path.calls


def test_q1_spans_are_documented():
    assert {"mfi.q1", "mfi.q1.alloc"} <= set(trace.SPANS)
    assert "``mfi.q1``" in trace.__doc__
