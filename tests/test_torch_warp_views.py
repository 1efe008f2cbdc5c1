"""V1 and V2, the kernels of the side-by-side views (modes 5/6) and of the
HSV flow view (mode 3) (``ops/cuda/warp_views.py``), on the CPU, where
each wrapper takes its plain version:

* the wrappers against the JAX package's batched warp (``_warp_sbs`` and
  the HSV branches of ``_warp_sample``) at 96x64 (res scalar 0), on a
  stride-padded frame (stride 96 > width 64) and under P010 with levels
  (16, 235) at res scalar 3, t in {0, 0.4, 1}, on random planes and flows
  that push cells past every edge: bit-exact for V1, the JAX package's HSV
  tolerance for V2; the plain counter moves once a call and the kernel
  counter not at all;
* ``warp_hsv_plain`` bit-equal to the composition the engine ran before
  V2 (K5's plain version twice, G1's at the default levels, the colours,
  the level maps), with a P010 sample of 65535;
* a per-sample NumPy model of V1's index math -- the forced regions, the
  stride split, the adjusted coordinates, the clipped flow cell, the
  reverse flow, the displacements, the output column's chroma parity --
  against ``ops/warp.warp_sbs`` at 16x8;
* the engine's warp stage: V1 or V2 once a position in modes 3, 5 and 6,
  and no K5 or G1;
* each wrapper's ValueErrors.

The card's side (each kernel against its plain version) is in
``tests/test_torch_cuda.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpv_frame_interpolator_tpu.frame import interleave_chroma
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry
from mpv_frame_interpolator_tpu.ops.warp import make_warp_batch_fn
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.ops.cuda import blend_levels as KG
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KD
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_views as KV
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine

torch.set_num_threads(1)

TS = [0.0, 0.4, 1.0]


def _near(a, b):
    """The JAX package's HSV tolerance (DEVIATIONS #11)."""
    frac = np.mean(np.abs(a.astype(int) - b.astype(int)) > 2)
    assert frac < 0.005, f"{frac=}"


def _planes(rng, h, stride, dt):
    hi = np.iinfo(dt).max + 1
    return (rng.integers(0, hi, (h, stride)).astype(dt),
            rng.integers(0, hi, (h // 2, stride)).astype(dt))


def _flow(rng, lh, lw, far):
    """Small odd flows (odd chroma displacements) with a fifth of the
    cells pushed up to `far` pixels, past every edge."""
    return np.where(rng.random((2, lh, lw)) < 0.2,
                    rng.integers(-far, far + 1, (2, lh, lw)),
                    2 * rng.integers(-6, 7, (2, lh, lw)) + 1).astype(np.int32)


# (height, stride, width, max calc res, P010): res scalar 0, a stride
# wider than the picture, P010 at res scalar 3
_CASES = {"96x64": (64, 96, 96, 270, False),
          "stride96": (48, 96, 64, 270, False),
          "p010_rs3": (64, 96, 96, 8, True)}


def _case(name):
    h, stride, w, mcr, p010 = _CASES[name]
    geom = FlowGeometry.create(h, stride, w, mcr)
    rng = np.random.default_rng(sum(map(ord, name)))
    dt = np.uint16 if p010 else np.uint8
    f1, f2 = _planes(rng, h, stride, dt), _planes(rng, h, stride, dt)
    if p010:
        f1[0][:2] = 65535           # raw samples above the 8-bit cap
    blur = _flow(rng, geom.low_h, geom.low_w, max(h, w) // 2)
    levels = (16.0, 235.0) if p010 else (0.0, 255.0)
    return geom, f1, f2, blur, (8 if p010 else 0), levels


def _jax(geom, f1, f2, blur, mode, ss, levels):
    fn = make_warp_batch_fn(geom, mode, ss)

    def planar(y, uv):
        return y, uv[:, 0::2], uv[:, 1::2]

    y, u, v = fn(*(jnp.asarray(np.ascontiguousarray(p))
                   for p in (*planar(*f1), *planar(*f2))),
                 jnp.asarray(blur), jnp.asarray(TS, jnp.float32),
                 jnp.float32(levels[0]), jnp.float32(levels[1]))
    return [(np.asarray(y[i]), interleave_chroma(np.asarray(u[i]),
                                                 np.asarray(v[i])))
            for i in range(len(TS))]


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("mode", [TW.HSV_FLOW, TW.SIDE_BY_SIDE_1,
                                  TW.SIDE_BY_SIDE_2])
def test_wrappers_equal_jax(case, mode):
    geom, f1, f2, blur, ss, levels = _case(case)
    if case == "p010_rs3":
        assert geom.res_scalar >= 3
    want = _jax(geom, f1, f2, blur, mode, ss, levels)
    counts = KV.hsv_counts if mode == TW.HSV_FLOW else KV.sbs_counts
    args = [torch.from_numpy(p) for p in (*f1, *f2, blur)]
    for n, t in enumerate(TS):
        before = (counts.kernel, counts.plain)
        tt = torch.tensor(t, dtype=torch.float32)
        rest = (tt, geom.res_scalar, geom.actual_width, ss,
                TW.level_ints(*levels))
        got = (KV.warp_hsv(*args, *rest) if mode == TW.HSV_FLOW
               else KV.warp_sbs(mode, *args, *rest))
        assert (counts.kernel, counts.plain) == (before[0], before[1] + 1)
        for g, r in zip(got, want[n]):
            g = g.numpy()
            assert g.dtype == r.dtype and g.shape == r.shape
            if mode == TW.HSV_FLOW:
                _near(g, r)
            else:
                np.testing.assert_array_equal(g, r)


def _old_composition(f1y, f1uv, f2y, f2uv, blurred, t, rs, wa, ss, levels):
    """Mode 3 as the engine ran it before V2: K5 twice, G1 at the default
    levels, the colours, then the level maps."""
    args = (f1y, f1uv, f2y, f2uv, blurred, t)
    y12, uv12 = KD.sample_dir_plain(*args, 12, rs, wa)
    y21, uv21 = KD.sample_dir_plain(*args, 21, rs, wa)
    b_y, b_uv = KG.blend_levels_plain(y12, uv12, y21, uv21, t, ss)
    b_y, b_uv = TW.hsv_planes(b_y.to(torch.int32), b_uv.to(torch.int32),
                              blurred, rs, wa, ss)
    k, w = levels
    return (TW.levels_y(b_y, k, w, ss).to(y12.dtype),
            TW.levels_uv(b_uv, w, ss).to(y12.dtype))


@pytest.mark.parametrize("case", list(_CASES))
def test_hsv_plain_is_the_old_composition(case):
    geom, f1, f2, blur, ss, levels = _case(case)
    if ss:
        f1[0][:] = 65535            # every raw sample of f1 at the top
        f1[1][:1] = 65535
    args = [torch.from_numpy(p) for p in (*f1, *f2, blur)]
    for t in TS + [0.5]:
        tt = torch.tensor(t, dtype=torch.float32)
        rest = (tt, geom.res_scalar, geom.actual_width, ss,
                TW.level_ints(*levels))
        got = KV.warp_hsv_plain(*args, *rest)
        want = _old_composition(*args, *rest)
        for g, r in zip(got, want):
            assert g.dtype == r.dtype
            assert torch.equal(g, r)


# --- a per-sample NumPy model of V1 -----------------------------------------

def _mirror(pos, dim):
    res = pos - (pos - (dim - 2)) * 2 if pos >= dim - 1 else pos
    if pos < 1:
        res = -pos + 1
    return min(max(res, 1), dim - 2)


def _iround(x):
    x = np.float32(x)
    return int(np.sign(x) * np.floor(np.abs(x) + np.float32(0.5)))


def _levels(b, k, w, ss, chroma):
    cap = 255 << ss
    if chroma:
        if w == 255:
            return min(b, cap)
        m = 128 << ss
        return min(max((b - m) * 255 + m * w, 0) // max(w, 1), cap)
    if (k, w) == (0, 255):
        return min(b, cap)
    return min(max((b - (k << ss)) * 255, 0) // max(w - k, 1), cap)


def sbs_model(mode, f1y, f1uv, f2y, f2uv, blurred, t, rs, wa, ss, levels):
    """V1 one output sample at a time, as a thread of the kernel computes
    it."""
    k, w = levels
    H, W = f1y.shape
    _, lh, lw = blurred.shape
    t = np.float32(t)
    fs21 = np.float32(1.0) - t
    frac = 16 if ss else 24
    tw = int(min(max(np.rint(t * np.float32(1 << frac)), 0), 1 << frac))
    outs = []
    for cz, p1, p2 in ((0, f1y, f2y), (1, f1uv, f2uv)):
        rows = H >> cz
        out = np.zeros((rows, wa), np.int64)
        for cy in range(rows):
            for cx in range(wa):
                ax, ay = cx, cy
                if mode == 5:
                    if cx < wa >> 1:
                        out[cy, cx] = p1[cy, cx]
                        continue
                else:
                    top = (H >> 2) >> cz
                    in_rows = top <= cy < top + (H >> (1 + cz))
                    if not (in_rows and W >> 1 <= cx < W):
                        if in_rows and cx < W >> 1:
                            ly = min(max((cy - top) * 2, 0), rows - 1)
                            lx = min(max(cx * 2 + (cx & 1 if cz else 0), 0),
                                     W - 1)
                            if cz:
                                lx = (lx & ~1) + (cx & 1)
                            out[cy, cx] = p1[ly, lx]
                        else:
                            out[cy, cx] = (128 << ss) if cz else 0
                        continue
                    ax, ay = (cx - (wa >> 1)) * 2, (cy - top) * 2
                if cz:
                    scx = min(max((ax >> rs) & ~1, 0), lw - 1)
                    scy = min(max((ay >> rs) << 1, 0), lh - 1)
                else:
                    scx = min(max(ax >> rs, 0), lw - 1)
                    scy = min(max(ay >> rs, 0), lh - 1)
                ox12, oy12 = blurred[0, scy, scx], blurred[1, scy, scx]
                bscy = min(max(scy - (oy12 >> rs), 0), lh - 1)
                bscx = min(max(scx - (ox12 >> rs), 0), lw - 1)
                ox21, oy21 = blurred[0, bscy, bscx], blurred[1, bscy, bscx]
                half = np.float32(0.5 if cz else 1.0)
                dy12 = _iround(np.float32(oy12) * t * half)
                dy21 = _iround(np.float32(oy21) * fs21 * half)
                dx12 = _iround(np.float32(ox12) * t)
                dx21 = _iround(np.float32(ox21) * fs21)

                def fetch(src, y, x):
                    x = _mirror(x, wa)
                    if cz:
                        x = (x & ~1) + (cx & 1)     # the OUTPUT column's
                    return int(src[_mirror(y, rows), x])

                s12 = fetch(p1, ay + dy12, ax + dx12)
                s21 = fetch(p2, ay - dy21, ax - dx21)
                b = (s12 * ((1 << frac) - tw) + s21 * tw) >> frac
                out[cy, cx] = _levels(b, k, w, ss, cz)
        outs.append(out.astype(f1y.dtype))
    return outs


@pytest.mark.parametrize("mode", [TW.SIDE_BY_SIDE_1, TW.SIDE_BY_SIDE_2])
@pytest.mark.parametrize("stride,rs,p010", [(16, 0, False), (20, 1, True),
                                            (22, 0, True), (21, 1, False)])
def test_sbs_index_model(mode, stride, rs, p010):
    """16x8 frames (stride 16, 20, 22 and an odd 21 over a width of 16, so
    that mode 6 splits at the stride), res scalar 0 and 1, 8-bit at the
    default levels and P010 at (16, 235), t in {0, 0.4, 1}."""
    rng = np.random.default_rng(stride * 10 + rs + mode)
    H, wa = 8, 16
    dt = np.uint16 if p010 else np.uint8
    ss = 8 if p010 else 0
    levels = TW.level_ints(16, 235) if p010 else (0, 255)
    f1, f2 = _planes(rng, H, stride, dt), _planes(rng, H, stride, dt)
    lh, lw = -(-H // (1 << rs)), -(-stride // (1 << rs))
    blur = _flow(rng, lh, lw, 12)
    for t in TS:
        got = TW.warp_sbs(mode, *(torch.from_numpy(p) for p in (*f1, *f2,
                                                                  blur)),
                          torch.tensor(t, dtype=torch.float32), rs, wa, ss,
                          levels)
        want = sbs_model(mode, *f1, *f2, blur, t, rs, wa, ss, levels)
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), r)


# --- the engine's calls ------------------------------------------------------

@pytest.mark.parametrize("mode", [TW.HSV_FLOW, TW.SIDE_BY_SIDE_1,
                                  TW.SIDE_BY_SIDE_2])
def test_engine_calls_a_view_once_a_position(mode):
    geom, f1, f2, blur, ss, levels = _case("stride96")
    counts = [KV.sbs_counts, KV.hsv_counts, KD.counts, KG.counts]
    before = [(c.kernel, c.plain) for c in counts]
    port_engine._warp_stage(
        geom, ss, (0, 255), mode, "pallas", "hopper",
        [torch.from_numpy(p) for p in (*f1, *f2)], torch.from_numpy(blur),
        torch.tensor(TS, dtype=torch.float32))
    moved = [(c.kernel - k, c.plain - p) for c, (k, p) in zip(counts, before)]
    hsv = mode == TW.HSV_FLOW
    assert moved == [(0, 0 if hsv else len(TS)), (0, len(TS) if hsv else 0),
                     (0, 0), (0, 0)]


# --- argument checks ----------------------------------------------------------

def _args(dt=np.uint8, h=48, stride=64):
    rng = np.random.default_rng(0)
    f1, f2 = _planes(rng, h, stride, dt), _planes(rng, h, stride, dt)
    return [torch.from_numpy(p) for p in (*f1, *f2)] + [
        torch.zeros((2, h, stride), dtype=torch.int32)]


def _call(which, planes, t, ss=0, mode=TW.SIDE_BY_SIDE_1, wa=64):
    if which == "hsv":
        return KV.warp_hsv(*planes, t, 0, wa, ss)
    return KV.warp_sbs(mode, *planes, t, 0, wa, ss)


T0 = torch.tensor(0.4)


@pytest.mark.parametrize("which", ["hsv", "sbs"])
def test_refuses_a_dtype_the_scale_shift_does_not_give(which):
    with pytest.raises(ValueError, match="must be torch.uint16"):
        _call(which, _args(np.uint8), T0, ss=8)
    with pytest.raises(ValueError, match="must be torch.uint8"):
        _call(which, _args(np.uint16), T0, ss=0)


@pytest.mark.parametrize("which", ["hsv", "sbs"])
def test_refuses_shapes(which):
    planes = _args()
    planes[2] = planes[2][:-2]                  # f2y two rows short
    with pytest.raises(ValueError, match="f2y"):
        _call(which, planes, T0)
    planes = _args()
    planes[4] = planes[4][:1]                   # one flow plane
    with pytest.raises(ValueError, match="blurred"):
        _call(which, planes, T0)
    with pytest.raises(ValueError, match="actual width"):
        _call(which, _args(), T0, wa=65)


@pytest.mark.parametrize("which", ["hsv", "sbs"])
def test_refuses_a_scale_shift_or_t(which):
    with pytest.raises(ValueError, match="scale_shift"):
        _call(which, _args(), T0, ss=4)
    with pytest.raises(ValueError, match="one blend position"):
        _call(which, _args(), torch.tensor([0.2, 0.4]))


@pytest.mark.parametrize("mode", [TW.BLENDED_FRAME, TW.HSV_FLOW, 7])
def test_sbs_refuses_another_mode(mode):
    with pytest.raises(ValueError, match="not a side-by-side mode"):
        _call("sbs", _args(), T0, mode=mode)
