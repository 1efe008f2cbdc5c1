"""C1, the pair's prologue (``ops/cuda/prologue.py``), and V3, the grey
view of mode 4 (``ops/cuda/warp_views.warp_grey``), on the CPU, where
each wrapper takes its plain version, against the JAX package:

* the plain score against JAX ``pipeline/scene.cut_score``: exact while
  the sum stays below 2^24 (XLA multiplies the float32 sum by the float32
  reciprocal of the count, and so does the port); within one float32 ulp
  above it, with the same cut decision (the JAX package sums in float32
  in XLA's order);
* the probe against JAX ``ops/flow._subsampled_f2``, exactly, at res
  scalars 0-3 and on a frame whose stride exceeds its width and whose
  height is not a multiple of 2^rs;
* the engine against the JAX engine on a clip of random frames with one
  cut, under "nearest" and "hold" and model "repeat", in modes 2 and 4,
  NV12 and P010: every output bit-exact, the cut counts equal;
* a threshold of 28.1 (not a float32) against a score equal to its float32
  value, which lies above its float64 value: no cut in either package;
* the grey view's plain version against JAX ``make_warp_batch_fn`` in
  mode 4, and the engine's call of it (once a pair);
* a NumPy model of the kernel's partition (the grid-stride cells of a
  cooperative grid, per-block partial sums, block 0's fixed-order sum and
  the fold, the probe written once a cell and only inside lh x lw)
  against the plain version, and of V3's 16-byte runs;
* the engine's cached blend positions unchanged after a cut pair;
* ``ops/flow.flow``'s probe and cut arguments, the wrappers' ValueErrors,
  and the arity of the C entry points against ``_build._SIGNATURES``.

The card's side (each kernel against its plain version, graph replay, two
streams) is in ``tests/test_torch_cuda.py``."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.frame import (
    FrameFormat as JaxFormat, VideoFrame as JaxFrame, interleave_chroma)
from mpv_frame_interpolator_tpu.ops import flow as jax_flow
from mpv_frame_interpolator_tpu.ops.warp import make_warp_batch_fn
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu.pipeline import scene as jax_scene
from mpv_frame_interpolator_tpu_torch.ops import flow as TF
from mpv_frame_interpolator_tpu_torch.ops import warp as TW
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import prologue as KC
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_views as KV
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _prologue(geom, y1, y2, f2u, f2v, ts, **kw):
    cuts = torch.zeros((), dtype=torch.int32)
    pro = KC.pair_prologue(geom, _t(y1), _t(y2), _t(f2u), _t(f2v),
                           torch.tensor(ts, dtype=torch.float32), cuts, **kw)
    return pro, int(cuts)


# --- the score ---------------------------------------------------------------

@pytest.mark.parametrize("rs,p010", [(0, False), (1, True), (2, False),
                                     (3, True)])
def test_score_exact_below_2_24(rs, p010):
    rng = np.random.default_rng(rs)
    dt = np.uint16 if p010 else np.uint8
    hi = np.iinfo(dt).max + 1
    y1, y2 = (rng.integers(0, hi, (50, 72)).astype(dt) for _ in range(2))
    geom = TF.FlowGeometry.create(50, 72, 64, 50 >> rs)
    assert geom.res_scalar == rs
    shift = 8 if p010 else 0
    pro, _ = _prologue(geom, y1, y2, y1[:25, :36], y1[:25, :36], [0.5],
                       bit_shift=shift, probe=False)
    want = np.float32(jax_scene.cut_score(jnp.asarray(y1), jnp.asarray(y2),
                                          rs, shift))
    assert pro.score.dtype == torch.float32 and pro.score.dim() == 0
    assert np.float32(pro.score) == want


def test_score_above_2_24_within_an_ulp():
    rng = np.random.default_rng(7)
    y1 = rng.integers(0, 256, (512, 512)).astype(np.uint8)
    y2 = rng.integers(0, 256, (512, 512)).astype(np.uint8)
    assert np.abs(y1.astype(int) - y2.astype(int)).sum() > 1 << 24
    geom = TF.FlowGeometry.create(512, 512, 512, 512)
    want = np.float32(jax_scene.cut_score(jnp.asarray(y1), jnp.asarray(y2),
                                          0))
    for threshold in (float(want), float(want) - 0.01, 90.0):
        pro, cuts = _prologue(geom, y1, y2, y1[:256, :256], y1[:256, :256],
                              [0.5], threshold=threshold, probe=False)
        got = np.float32(pro.score)
        assert abs(got - want) <= np.spacing(want), (got, want)
        # the same decision wherever the score is not within an ulp of
        # the threshold
        if abs(want - np.float32(threshold)) > np.spacing(want):
            assert cuts == int(want > np.float32(threshold))
        assert int(pro.cut) == cuts


def _ten_percent_frames(h, w):
    """Luma planes whose mean |difference| is exactly 28.1 in the reals:
    28 everywhere, 29 on a tenth of the samples (h * w a multiple of
    10)."""
    y1 = np.zeros((h, w), np.uint8)
    y2 = np.full((h, w), 28, np.uint8)
    y2.reshape(-1)[:h * w // 10] = 29
    return y1, y2


def test_threshold_28_1_compared_in_float32():
    """28.1 is not a float32: its float32 value lies above its float64
    value.  A score equal to float32(28.1) is no cut in either package
    (the threshold rounds to float32), and is a cut against 28.09."""
    y1, y2 = _ten_percent_frames(40, 64)
    geom = TF.FlowGeometry.create(40, 64, 64)
    assert float(np.float32(28.1)) > 28.1
    for threshold, cut in ((28.1, 0), (28.09, 1)):
        pro, cuts = _prologue(geom, y1, y2, y1[:20, :32], y1[:20, :32],
                              [0.2, 0.6], threshold=threshold, probe=False)
        want = jax_scene.cut_score(jnp.asarray(y1), jnp.asarray(y2), 0)
        assert np.float32(pro.score) == np.float32(want) == np.float32(28.1)
        assert bool(want > np.float32(threshold)) == bool(cut)
        assert (int(pro.cut), cuts) == (cut, cut)
        assert pro.ts.tolist() == ([0.0, 1.0] if cut else
                                   [np.float32(0.2), np.float32(0.6)])


def test_engine_threshold_28_1_against_the_jax_engine():
    """The two engines at threshold 28.1 on frames whose score is
    float32(28.1): no cut in either, the same outputs."""
    fmt = JaxFormat(64, 40)
    y1, y2 = _ten_percent_frames(40, 64)
    rng = np.random.default_rng(3)
    uv = rng.integers(0, 256, (20, 64)).astype(np.uint8)
    frames = [JaxFrame(y, uv, fmt, pts=i / 24.0, nominal_fps=24.0)
              for i, y in enumerate((y1, y2, y1))]
    # the score and the cut do not depend on the family: blend searches no
    # flow, which keeps the JAX engine's compile short
    ref, port = _engines(threshold=28.1, display_fps=60.0, model="blend")
    _drive(ref, port, frames)
    assert port.scene_cuts() == 0
    assert np.float32(port.last_cut_score()) == np.float32(28.1)


# --- the probe ---------------------------------------------------------------

@pytest.mark.parametrize("h,stride,w,mcr", [
    (48, 64, 64, 270),          # rs 0
    (64, 96, 96, 32),           # rs 1
    (50, 80, 66, 16),           # rs 2, H not a multiple of 4, stride > w
    (60, 88, 70, 8)])           # rs 3, H not a multiple of 8, stride > w
@pytest.mark.parametrize("p010", [False, True])
def test_probe_equals_the_jax_probe(h, stride, w, mcr, p010):
    rng = np.random.default_rng(h * stride)
    dt = np.uint16 if p010 else np.uint8
    hi = np.iinfo(dt).max + 1
    y2 = rng.integers(0, hi, (h, stride)).astype(dt)
    u2, v2 = (rng.integers(0, hi, (h // 2, stride // 2)).astype(dt)
              for _ in range(2))
    geom = TF.FlowGeometry.create(h, stride, w, mcr)
    jgeom = jax_flow.FlowGeometry.create(h, stride, w, mcr)
    assert (geom.res_scalar, geom.low_h, geom.low_w) == (
        jgeom.res_scalar, jgeom.low_h, jgeom.low_w)
    pro, _ = _prologue(geom, y2, y2, u2, v2, [0.5], bit_shift=8 * p010,
                       scene_enabled=False)
    want = jax_flow._subsampled_f2(jgeom, jnp.asarray(y2), jnp.asarray(u2),
                                   jnp.asarray(v2))
    for got, ref in zip(pro.probe, want):
        assert got.dtype == torch.from_numpy(y2).dtype
        assert tuple(got.shape) == (geom.low_h, geom.low_w)
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(ref).astype(np.int64))
    assert pro.score is None and int(pro.cut) == 0


# --- the engine against the JAX engine ---------------------------------------

def _engines(threshold=28.0, **kw):
    kw.setdefault("auto_quality", False)
    kw.setdefault("measure_timing", False)
    ref = jax_engine.InterpolationEngine(jax_engine.EngineConfig(
        background_precompile=False, scene_threshold=threshold, **kw))
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", scene_threshold=threshold, **kw))
    return ref, port


def _drive(ref, port, frames):
    """Push both engines; returns the pairs whose JAX score was a cut."""
    cuts = 0
    for f in frames:
        r_outs, p_outs = ref.push(f), port.push(f)
        assert len(r_outs) == len(p_outs)
        for r, p in zip(r_outs, p_outs):
            assert p.pts == r.pts
            rf, pf = r.to_video_frame(), p.to_video_frame()
            np.testing.assert_array_equal(pf.y, rf.y)
            np.testing.assert_array_equal(pf.uv, rf.uv)
        if r_outs and r_outs[0]._index is not None:
            a = np.float32(ref.last_cut_score())
            b = np.float32(port.last_cut_score())
            assert abs(a - b) <= np.spacing(max(a, b))
            cuts += bool(a > np.float32(ref.scene.threshold))
    return cuts


def _random_clip(p010: bool, n: int = 5, cut_at: int = 3):
    """Random frames: one scene of small noise around a random picture,
    then a cut to another random picture, at 64x48 (stride 80)."""
    rng = np.random.default_rng(11 + p010)
    dt = np.uint16 if p010 else np.uint8
    fmt = JaxFormat(64, 48, pixfmt="p010" if p010 else "nv12", stride=80)

    def picture():
        return (rng.integers(16, 240, (48, 80)),
                rng.integers(16, 240, (24, 80)))

    scenes = [picture(), picture()]
    frames = []
    for i in range(n):
        y, uv = scenes[i >= cut_at]
        planes = [np.clip(p + rng.integers(-3, 4, p.shape), 0, 255)
                  for p in (y, uv)]
        if p010:
            planes = [p << 8 for p in planes]
        frames.append(JaxFrame(*(p.astype(dt) for p in planes), fmt,
                               pts=i / 24.0, nominal_fps=24.0))
    return frames


@pytest.mark.parametrize("p010,policy,model,mode", [
    (False, "hold", "hopper", 2),
    (True, "hold", "hopper", 2),
    (False, "nearest", "repeat", 2),
    (True, "hold", "repeat", 2),
    (False, "hold", "hopper", 4),
    (True, "nearest", "hopper", 4)])
def test_engine_on_a_cut_equals_the_jax_engine(p010, policy, model, mode):
    ref, port = _engines(display_fps=60.0, cut_policy=policy, model=model,
                         frame_output_mode=mode, initial_search_radius=8,
                         num_iterations=2)
    before = (KC.counts.plain, KV.grey_counts.plain)
    cuts = _drive(ref, port, _random_clip(p010))
    assert cuts == 1 and port.scene_cuts() == 1
    # the prologue once a pair, the grey view once a pair in mode 4
    assert KC.counts.plain - before[0] == 4
    assert KV.grey_counts.plain - before[1] == (4 if mode == 4 else 0)


def test_cached_positions_unchanged_after_a_cut_pair():
    """The engine caches one blend tensor per tuple and hands it to later
    pairs: the prologue folds into a new tensor."""
    port = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", display_fps=60.0, auto_quality=False,
        measure_timing=False, model="repeat"))
    for f in _random_clip(False):
        port.push(f)
    assert port.scene_cuts() == 1
    assert port._ts_cache
    for blends, ts in port._ts_cache.items():
        assert ts.tolist() == [float(np.float32(b)) for b in blends]


@pytest.mark.parametrize("model,launches", [("blend", 0), ("repeat", 4)])
def test_engine_without_scene_detection(model, launches):
    """Scene detection off: model "blend" leaves the prologue nothing to
    compute (no call a pair), "repeat" still folds (one a pair); every
    output equals the JAX engine's."""
    ref, port = _engines(display_fps=60.0, model=model,
                         scene_detection=False)
    before = KC.counts.plain
    for f in _random_clip(False):
        r_outs, p_outs = ref.push(f), port.push(f)
        assert len(r_outs) == len(p_outs)
        for r, p in zip(r_outs, p_outs):
            rf, pf = r.to_video_frame(), p.to_video_frame()
            np.testing.assert_array_equal(pf.y, rf.y)
            np.testing.assert_array_equal(pf.uv, rf.uv)
    assert KC.counts.plain - before == launches
    assert port.scene_cuts() == 0


@pytest.mark.parametrize("scene,probe,repeat", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True)])
def test_prologue_runs_only_with_work(scene, probe, repeat):
    """No scene detection, no probe and no "repeat": no call of the plain
    version (nor, on the card, a launch), the positions as given; any one
    of them: one call."""
    rng = np.random.default_rng(6)
    geom = TF.FlowGeometry.create(48, 64, 64)
    y1, y2 = rng.integers(0, 256, (2, 48, 64)).astype(np.uint8)
    u2, v2 = rng.integers(0, 256, (2, 24, 32)).astype(np.uint8)
    ts = [0.25, 0.75]
    before = KC.counts.plain
    pro, cuts = _prologue(geom, y1, y2, u2, v2, ts, scene_enabled=scene,
                          threshold=300.0, probe=probe, repeat=repeat,
                          partials=KC.scratch("cpu"))
    work = scene or probe or repeat
    assert KC.counts.plain - before == int(work)
    assert (pro.cut is None) == (not work) and cuts == 0
    assert pro.ts.tolist() == ([0.0, 1.0] if repeat else ts)


# --- the grey view -----------------------------------------------------------

@pytest.mark.parametrize("h,stride,w,mcr,p010", [
    (64, 96, 96, 270, False), (48, 96, 64, 270, False),
    (64, 96, 96, 8, True)])
def test_grey_view_equals_the_jax_grey_view(h, stride, w, mcr, p010):
    geom = jax_flow.FlowGeometry.create(h, stride, w, mcr)
    rng = np.random.default_rng(h + stride + w)
    dt = np.uint16 if p010 else np.uint8
    blur = rng.integers(-80, 81, (2, geom.low_h, geom.low_w)).astype(
        np.int32)
    ss = 8 if p010 else 0
    planes = [rng.integers(0, 200, (h // 2, stride // 2)).astype(dt)
              for _ in range(4)]
    fn = make_warp_batch_fn(geom, TW.GREY_FLOW, ss)
    jy, ju, jv = fn(*(jnp.asarray(p) for p in (
        np.zeros((h, stride), dt), planes[0], planes[1],
        np.zeros((h, stride), dt), planes[2], planes[3])),
        jnp.asarray(blur), jnp.asarray([0.5], jnp.float32),
        jnp.float32(0.0), jnp.float32(255.0))
    before = (KV.grey_counts.kernel, KV.grey_counts.plain)
    y, uv = KV.warp_grey(_t(blur), geom.res_scalar, h, w, ss,
                         torch.uint16 if p010 else torch.uint8)
    assert (KV.grey_counts.kernel, KV.grey_counts.plain) == (
        before[0], before[1] + 1)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy[0]))
    np.testing.assert_array_equal(
        uv.numpy(), interleave_chroma(np.asarray(ju[0]), np.asarray(jv[0])))


def _grey_runs_model(blur, rs, rows, wa, ss, dt):
    """V3's threads: run j of the flat luma plane then of the flat chroma
    plane, 16 bytes each, a cell's flow read once a run, the last run of
    a plane cut short; int32 arithmetic wrapping as uint32."""
    per = 16 // np.dtype(dt).itemsize
    lh, lw = blur.shape[1:]
    outs = [np.zeros(rows * wa, dt), np.zeros(rows // 2 * wa, dt)]
    luma_runs = -(-rows * wa // per)
    runs = luma_runs + -(-(rows // 2) * wa // per)
    written = [np.zeros(o.size, int) for o in outs]
    for j in range(runs):
        chroma = j >= luma_runs
        first = (j - luma_runs if chroma else j) * per
        count = min(per, outs[chroma].size - first)
        for k in range(count):
            i = first + k
            if chroma:
                v = 128 << ss
            else:
                cy, cx = divmod(i, wa)
                at = (min(cy >> rs, lh - 1), min(cx >> rs, lw - 1))
                a = np.uint32(abs(int(blur[0][at]))) + np.uint32(
                    abs(int(blur[1][at])))
                g = int(np.int32(np.uint32(a << np.uint32(2))))
                v = (min(g, 255) << ss) & 0xFFFFFFFF
            outs[chroma][i] = v & (0xFF if dt == np.uint8 else 0xFFFF)
            written[chroma][i] += 1
    assert all((w == 1).all() for w in written)
    return outs[0].reshape(rows, wa), outs[1].reshape(rows // 2, wa)


@pytest.mark.parametrize("rows,wa,rs,p010", [(8, 13, 0, False),
                                             (10, 21, 1, True),
                                             (12, 32, 2, False)])
def test_grey_runs_model(rows, wa, rs, p010):
    rng = np.random.default_rng(rows * wa)
    lh, lw = -(-rows // (1 << rs)), -(-wa // (1 << rs))
    blur = rng.integers(-70, 71, (2, lh, lw)).astype(np.int32)
    # magnitudes whose << 2 wraps past 2^31 (a negative int32) and past
    # 2^32
    blur[0, 0, 0] = (1 << 30) + (1 << 29)
    blur[1, -1, -1] = 1 << 30
    dt = np.uint16 if p010 else np.uint8
    ss = 8 if p010 else 0
    want = TW.grey_planes(_t(blur), rs, rows, wa, ss, torch.from_numpy(
        np.zeros(1, dt)).dtype)
    for got, ref in zip(_grey_runs_model(blur, rs, rows, wa, ss, dt), want):
        np.testing.assert_array_equal(got, ref.numpy())


# --- C1's partition ----------------------------------------------------------

THREADS = 256
MAX_BLOCKS = 1024


def _c1_model(geom, y1, y2, f2u, f2v, ts, bit_shift, scene, threshold,
              nearest, repeat, sms, per_sm=8):
    """C1's launch in NumPy: the grid csrc/pair_prologue.cu sizes, each
    thread's grid-stride cells (probe, then score), each block's partial
    (uint64), block 0's sum of the partials (thread k: blocks k, k + 256,
    ...; then the threads in order), one float32 division, the float32
    comparison and the fold.  Checks that every probe cell is written once
    and none outside lh x lw."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    rows, cols = y1.shape
    sh, sw = -(-rows // (1 << rs)), -(-cols // (1 << rs))
    cells = max(lh * lw, sh * sw if scene else 0, 1)
    blocks = min(-(-cells // THREADS), sms * min(per_sm, 2), MAX_BLOCKS)
    stride = blocks * THREADS
    probe = [np.zeros((lh, lw), y2.dtype) for _ in range(3)]
    written = np.zeros((lh, lw), int)
    partials = np.zeros(blocks, np.uint64)
    for b in range(blocks):
        acc = np.uint64(0)
        for t in range(THREADS):
            for i in range(b * THREADS + t, lh * lw, stride):
                cy, cx = divmod(i, lw)
                y, x = cy << rs, cx << rs
                probe[0][cy, cx] = y2[y, x]
                probe[1][cy, cx] = f2u[y >> 1, x >> 1]
                probe[2][cy, cx] = f2v[y >> 1, x >> 1]
                written[cy, cx] += 1
            if scene:
                idx = np.arange(b * THREADS + t, sh * sw, stride)
                r, c = idx // sw, idx % sw
                d = np.abs(y1[r << rs, c << rs].astype(np.int64)
                           - y2[r << rs, c << rs].astype(np.int64))
                acc += np.uint64((d >> bit_shift).sum())
        partials[b] = acc
    assert (written == 1).all()
    score = cut = None
    if scene:
        per_thread = [partials[k::THREADS].sum(dtype=np.uint64)
                      for k in range(THREADS)]
        total = np.uint64(0)
        for v in per_thread:
            total += v
        score = np.float32(total) * (np.float32(1) / np.float32(sh * sw))
        cut = int(score > np.float32(threshold))
    folded = []
    for t in np.asarray(ts, np.float32):
        if cut:
            t = np.float32(t >= 0.5) if nearest else np.float32(0.0)
        if repeat:
            t = np.float32(t >= 0.5)
        folded.append(np.float32(t))
    return score, cut or 0, np.array(folded, np.float32), probe


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("h,stride,w,mcr,p010,threshold", [
    (48, 80, 64, 270, False, 20.0),     # 3840 cells, one cut
    (50, 80, 66, 16, True, 90.0),       # rs 2, no cut
    (60, 88, 70, 8, False, 0.0)])       # rs 3, a cut
@pytest.mark.parametrize("policy,repeat", [("nearest", False),
                                           ("hold", True)])
def test_c1_partition_model(sms, h, stride, w, mcr, p010, threshold, policy,
                            repeat):
    rng = np.random.default_rng(h + sms)
    dt = np.uint16 if p010 else np.uint8
    hi = np.iinfo(dt).max + 1
    y1, y2 = (rng.integers(0, hi, (h, stride)).astype(dt) for _ in range(2))
    f2u, f2v = (rng.integers(0, hi, (h // 2, stride // 2)).astype(dt)
                for _ in range(2))
    geom = TF.FlowGeometry.create(h, stride, w, mcr)
    ts = [0.0, 0.2, 0.5, 0.7, 1.0]
    shift = 8 if p010 else 0
    score, cut, folded, probe = _c1_model(
        geom, y1, y2, f2u, f2v, ts, shift, True, threshold,
        policy == "nearest", repeat, sms)
    pro, cuts = _prologue(geom, y1, y2, f2u, f2v, ts, bit_shift=shift,
                          threshold=threshold, cut_policy=policy,
                          repeat=repeat)
    assert np.float32(pro.score) == score
    assert int(pro.cut) == cuts == cut
    np.testing.assert_array_equal(pro.ts.numpy(), folded)
    for got, want in zip(pro.probe, probe):
        np.testing.assert_array_equal(got.numpy(), want)
    # scene detection off: no score, no cut, repeat still snaps
    _, cut, folded, _ = _c1_model(geom, y1, y2, f2u, f2v, ts, shift, False,
                                  threshold, True, repeat, sms)
    pro, cuts = _prologue(geom, y1, y2, f2u, f2v, ts, bit_shift=shift,
                          scene_enabled=False, repeat=repeat, probe=False)
    assert pro.score is None and pro.probe is None
    assert (cuts, cut) == (0, 0)
    # without "repeat" there is nothing to compute: no call, no flag
    assert pro.cut is None if not repeat else int(pro.cut) == 0
    np.testing.assert_array_equal(pro.ts.numpy(), folded)


# --- the flow's probe and cut arguments, errors, entry points ----------------

def test_flow_takes_the_probe_and_the_cut():
    rng = np.random.default_rng(5)
    geom = TF.FlowGeometry.create(48, 64, 64)
    f1 = [_t(rng.integers(0, 256, s).astype(np.uint8))
          for s in ((48, 64), (24, 32), (24, 32))]
    f2 = [_t(np.roll(p.numpy(), 2, axis=1)) for p in f1]
    off, blurred = TF.flow(geom, *f1, *f2, 8)
    probe = TF.subsampled_f2(geom, *f2)
    zero, one = (torch.tensor(v, dtype=torch.int32) for v in (0, 1))
    assert blurred.abs().sum() > 0
    for kw in ({"probe": probe}, {"cut": zero}, {"probe": probe, "cut": zero},
               {"cut": zero, "subpel": True}):
        o, b = TF.flow(geom, *f1, *f2, 8, **kw)
        assert torch.equal(o, off)
        if "subpel" not in kw:
            assert torch.equal(b, blurred)
    for kw in ({"cut": one}, {"cut": one, "subpel": True}):
        o, b = TF.flow(geom, *f1, *f2, 8, **kw)
        assert torch.equal(o, off) and not b.any()
    with pytest.raises(ValueError):
        TF.flow(geom, *f1, *f2, 8, blur=False, cut=one)


def test_wrapper_errors():
    geom = TF.FlowGeometry.create(48, 64, 64)
    y = torch.zeros((48, 64), dtype=torch.uint8)
    c = torch.zeros((24, 32), dtype=torch.uint8)
    ts = torch.zeros(2)
    cuts = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError):
        KC.pair_prologue(geom, y, y, c, c, ts, cuts, cut_policy="snap")
    with pytest.raises(ValueError):
        KC.pair_prologue(geom, y, y[:, :32], c, c, ts, cuts)
    with pytest.raises(ValueError):
        KC.pair_prologue(geom, y, y, c, c, ts[None], cuts)
    with pytest.raises(ValueError):
        KC.pair_prologue(geom, y[:16], y[:16], c, c, ts, cuts)
    blur = torch.zeros((2, 48, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        KV.warp_grey(blur, 0, 48, 64, 4, torch.uint8)
    with pytest.raises(ValueError):
        KV.warp_grey(blur[0], 0, 48, 64, 0, torch.uint8)


_ENTRY = re.compile(r'extern "C" int (mfi_\w+)\(([^)]*)\)')


@pytest.mark.parametrize("source,entry", [
    ("pair_prologue.cu", "mfi_pair_prologue"),
    ("warp_views.cu", "mfi_warp_grey"),
    ("flow_step.cu", "mfi_flow_pyramid")])
def test_entry_point_arity(source, entry):
    """The C entry's parameters against its ctypes argtypes, one by one:
    a pointer for each pointer, a float for each float, an int for each
    int (ctypes would pass a pointer cut to 32 bits otherwise)."""
    text = (_build.CSRC_DIR / source).read_text()
    params = dict(_ENTRY.findall(text))[entry].split(",")
    kinds = []
    for p in params:
        p = p.strip()
        kinds.append("p" if "*" in p else "f" if p.startswith("float")
                     else "i")
    want = ["p" if a is _build.P or a.__name__.startswith("LP_") else
            "f" if a is ctypes.c_float else "i"
            for a in _build._SIGNATURES[entry]]
    assert kinds == want
    assert source in _build.SOURCES
