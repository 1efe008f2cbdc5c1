"""Q1's run decomposition (csrc/warp_bilinear.cu over csrc/warp_runs.cuh),
modelled in plain PyTorch and held bit-exact against bilinear_blend_plain,
and on small cases against the JAX package's bilinear branch.

Q1 gives each thread a 16-byte output run of one row (16 samples at 8
bits, 8 under P010), cut into segments of one flow cell as K5 cuts it
(2^rs luma samples, 2^(rs+1) interleaved chroma samples, capped at the
run).  Per segment: one flow lookup, the back-projected reverse flow, and
for each direction one 1/64-pel displacement d, so that every sample of
the segment has the tap offset d >> 6 and the weights d & 63.  A segment
is interior when both taps of every sample, in rows y0 and y0 + 1 of both
sources, lie in [1, dim - 2] (where mirror_edge2 is the identity); it
reads from each of its 2 rows x 2 sources a window of seg + 1 samples
(luma) or seg + 2 interleaved samples (chroma: the taps of column cx are
columns cx + 2 (d >> 6) and two on, u and v from the same window), built
from the aligned 16-byte chunks around it -- a chunk only when the window
reaches into it.  Every other run takes the per-sample step: each tap
mirrored and read at the segment's displacement.  Both end in the JAX
float order.

The model below does this independently of the plain version (its own
segment flows, interior test, window reads from the row's bytes and
per-sample taps) and checks that no chunk read of an interior run leaves
its source row.  Hypothesis draws res scalars 0-3, widths that are not a
multiple of 16, strides wider than the width, large, odd and negative
flows, both occlusion settings, the sub-pel field, and P010 with black and
white levels.  Bit-exact (tolerance 0)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry
from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_bilinear as KQ
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
from test_torch_bilinear import _field, _jax_blend, _planes
from test_torch_warp_runs import _LEVELS, RUN, _case, _equal, _row_samples

torch.set_num_threads(1)

_INV = np.float32(1.0 / 4096.0)


def _taps(src, rows, cols, fx, fy):
    """The bilinear sample from the four taps: rows (r0, r1) and columns
    (c0, c1) of src, weights fx, fy in 1/64 (int64, 1/4096 units)."""
    s = src.to(torch.int64)
    top = s[rows[0], cols[0]] * (64 - fx) + s[rows[0], cols[1]] * fx
    bot = s[rows[1], cols[0]] * (64 - fx) + s[rows[1], cols[1]] * fx
    return top * (64 - fy) + bot * fy


def _plane_bilinear_runs(f1, f2, blurred, frac, t, rs, rows, wa, chroma, ss,
                         levels, occlusion, vec, chroma_step=2):
    """One plane through Q1's runs: the (rows, wa) output and the (rows,
    runs) interior mask.  chroma_step is the distance between a chroma
    sample's two taps in the interleaved window (2; 1 models a wrong
    kernel)."""
    item = f1.element_size()
    e = RUN // item                      # samples a run
    seg = 1 << min(rs + int(chroma), e.bit_length() - 1)
    nseg = e // seg
    nruns = -(-wa // e)
    _, lh, lw = blurred.shape
    i64, f32 = torch.int64, torch.float32
    xs = (torch.arange(nruns)[:, None] * e
          + torch.arange(nseg)[None] * seg)            # (R, G)
    cy = torch.arange(rows)
    if chroma:
        scx = ((xs >> rs) & ~1).clamp(max=lw - 1)
        scy = ((cy >> rs) << 1).clamp(max=lh - 1)
    else:
        scx = (xs >> rs).clamp(max=lw - 1)
        scy = (cy >> rs).clamp(max=lh - 1)
    bx, by = blurred[0].to(i64), blurred[1].to(i64)
    sy, sx = scy[:, None, None], scx[None]
    ox12, oy12 = bx[sy, sx], by[sy, sx]                # (Y, R, G)
    bsy = (sy - (oy12 >> rs)).clamp(0, lh - 1)
    bsx = (sx - (ox12 >> rs)).clamp(0, lw - 1)
    ox21, oy21 = bx[bsy, bsx], by[bsy, bsx]
    t = t.to(f32).reshape(())
    fs21 = 1.0 - t
    if frac is None:
        unit = 32.0 if chroma else 64.0
        s12, s21 = t * unit, fs21 * unit
    else:
        fx_, fy_ = frac[0].to(i64), frac[1].to(i64)
        ox12, oy12 = (ox12 << 6) + fx_[sy, sx], (oy12 << 6) + fy_[sy, sx]
        ox21 = (ox21 << 6) + fx_[bsy, bsx]
        oy21 = (oy21 << 6) + fy_[bsy, bsx]
        s12, s21 = (t * 0.5, fs21 * 0.5) if chroma else (t, fs21)
    d = {12: (W.iround(ox12.to(f32) * s12).to(i64),
              W.iround(oy12.to(f32) * s12).to(i64)),
         21: (-W.iround(ox21.to(f32) * s21).to(i64),
              -W.iround(oy21.to(f32) * s21).to(i64))}
    # the interior test on the planar segment, widened by one tap
    dim_x = wa >> 1 if chroma else wa
    hx = xs >> 1 if chroma else xs
    pseg = seg // 2 if chroma else seg
    X, Y = xs[None], cy[:, None, None]
    lo_x = torch.minimum(d[12][0] >> 6, d[21][0] >> 6)
    hi_x = torch.maximum(d[12][0] >> 6, d[21][0] >> 6)
    lo_y = torch.minimum(d[12][1] >> 6, d[21][1] >> 6)
    hi_y = torch.maximum(d[12][1] >> 6, d[21][1] >> 6)
    ok = ((hx[None] + lo_x >= 1) & (hx[None] + pseg + hi_x <= dim_x - 2)
          & (Y + lo_y >= 1) & (Y + hi_y + 1 <= rows - 2))
    interior = ok.all(dim=-1) & vec                    # (Y, R)

    step = chroma_step if chroma else 1
    j = torch.arange(seg)
    cx = X[..., None] + j                              # (1, R, G, S)
    inside = interior[..., None]
    q = {}
    for direction, src in ((12, f1), (21, f2)):
        dx, dy = (v[..., None] for v in d[direction])  # (Y, R, G, 1)
        fx, fy = dx & 63, dy & 63
        # the interior runs: windows of rows y0 and y0 + 1
        y0 = (Y[..., None] + (dy >> 6)).clamp(0, rows - 1)
        start = X[..., None] + step * (dx >> 6)
        wins = []
        for r in (y0, (y0 + 1).clamp(max=rows - 1)):
            win, legal = _row_samples(src, r[..., 0], start[..., 0],
                                     seg + step, item)
            assert bool((legal | ~inside).all()), \
                "a chunk read of an interior run leaves its source row"
            wins.append(win)                           # (Y, R, G, seg+step)
        top = wins[0][..., :seg] * (64 - fx) + wins[0][..., step:] * fx
        bot = wins[1][..., :seg] * (64 - fx) + wins[1][..., step:] * fx
        vec_q = top * (64 - fy) + bot * fy
        # the per-sample step: each tap mirrored, at the segment's d
        py = (Y[..., None] << 6) + dy
        px = (((cx >> 1) if chroma else cx) << 6) + dx
        ry = [W.mirror_edge2(p, rows) for p in (py >> 6, (py >> 6) + 1)]
        rx = [W.mirror_edge2(p, dim_x) for p in (px >> 6, (px >> 6) + 1)]
        if chroma:
            rx = [c * 2 + (cx & 1) for c in rx]
        shape = vec_q.shape
        edge_q = _taps(src, [r.expand(shape) for r in ry],
                       [c.expand(shape) for c in rx], fx, fy)
        q[direction] = torch.where(inside[..., None], vec_q, edge_q)
    # the JAX float order, each product and sum rounded once in float32
    a, b = q[12].to(f32), q[21].to(f32)
    blended = torch.floor((a * fs21 + b * t) * _INV + 0.5).to(i64)
    if occlusion:
        blended = W.occlusion_adjust(blended, torch.floor(a * _INV + 0.5),
                                     torch.floor(b * _INV + 0.5), t, ss)
    k, w = levels
    out = W.levels_uv(blended, w, ss) if chroma else W.levels_y(blended, k,
                                                                 w, ss)
    return out.reshape(rows, nruns * e)[:, :wa], interior


def bilinear_runs_model(f1y, f1uv, f2y, f2uv, blurred, t, rs, wa, ss=0,
                        levels=(0, 255), occlusion=False, frac=None,
                        chroma_step=2):
    """Q1 through its runs: (y, uv) of the planes' dtype and the count of
    interior runs of each plane."""
    vec = KW.vector_path((f1y, f1uv, f2y, f2uv), wa)
    outs, counts = [], []
    for p1, p2, chroma in ((f1y, f2y, False), (f1uv, f2uv, True)):
        got, interior = _plane_bilinear_runs(
            p1, p2, blurred, frac, t, rs, p1.shape[0], wa, chroma, ss,
            levels, occlusion, vec, chroma_step)
        outs.append(got.to(p1.dtype))
        counts.append(int(interior.sum()))
    return outs, counts


def _even_width(runs, ragged, item):
    width = max(6, runs * RUN // item - ragged)
    return width - width % 2


_TS = [0.0, 0.2, 0.5, 0.8, 1.0, 0.37]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), rs=st.integers(0, 3),
       ss=st.sampled_from([0, 8]), runs=st.integers(1, 5),
       ragged=st.integers(0, 15), pad=st.sampled_from([0, 16, 6, 32]),
       rows=st.integers(3, 16), far=st.sampled_from([1, 2, 9, 40, 300]),
       levels=st.sampled_from(_LEVELS), t=st.sampled_from(_TS),
       occlusion=st.booleans(), with_frac=st.booleans())
def test_bilinear_runs_equal_the_plain_version(seed, rs, ss, runs, ragged,
                                               pad, rows, far, levels, t,
                                               occlusion, with_frac):
    item = 2 if ss else 1
    width = _even_width(runs, ragged, item)
    rng = np.random.default_rng(seed)
    planes, blurred = _case(rng, 2 * rows, width, width + pad, rs, ss, far)
    frac = torch.from_numpy(rng.integers(-64, 65, tuple(blurred.shape))
                            .astype(np.int32)) if with_frac else None
    tt = torch.tensor(t, dtype=torch.float32)
    got, _ = bilinear_runs_model(*planes, blurred, tt, rs, width, ss, levels,
                                 occlusion, frac)
    _equal(got, KQ.bilinear_blend_plain(*planes, blurred, tt, rs, width, ss,
                                        levels, occlusion, frac))


@pytest.mark.parametrize("ss", [0, 8])
@pytest.mark.parametrize("rs", [0, 1, 2, 3, 4])
def test_interior_bilinear_runs_take_the_vector_path(rs, ss):
    """At moderate flow most runs are interior in both planes at every
    res scalar the segment dispatch has (0-4), with and without the
    sub-pel field; the result is still the plain version's."""
    rng = np.random.default_rng(10 * rs + ss)
    planes, blurred = _case(rng, 48, 128, 144, rs, ss, 3)
    frac = torch.from_numpy(rng.integers(-32, 33, tuple(blurred.shape))
                            .astype(np.int32))
    levels = W.level_ints(16, 235) if ss else (0, 255)
    t = torch.tensor(0.4)
    item = 2 if ss else 1
    for f, occlusion in ((None, False), (frac, True)):
        got, counts = bilinear_runs_model(*planes, blurred, t, rs, 128, ss,
                                          levels, occlusion, f)
        _equal(got, KQ.bilinear_blend_plain(*planes, blurred, t, rs, 128, ss,
                                            levels, occlusion, f))
        assert sum(counts) > (48 + 24) * (128 * item // RUN) // 2, counts
        assert min(counts) > 0, counts


@pytest.mark.parametrize("ss", [0, 8])
def test_frame_edges_are_always_edge_bilinear_runs(ss):
    """At zero flow a sample's taps are its own column and the next, its
    own row and the next: mirror_edge2 moves column 0 and row 0, and the
    second tap of the last column and of the last two rows, so the first
    and last runs and rows 0, rows - 2 and rows - 1 take the per-sample
    step; every other run is interior."""
    rng = np.random.default_rng(ss + 1)
    planes, _ = _case(rng, 16, 64, 64, 0, ss, 1)
    blurred = torch.zeros((2, 16, 64), dtype=torch.int32)
    e = RUN // (2 if ss else 1)
    for p1, p2, chroma in ((planes[0], planes[2], False),
                           (planes[1], planes[3], True)):
        rows = p1.shape[0]
        _, interior = _plane_bilinear_runs(
            p1, p2, blurred, None, torch.tensor(0.5), 0, rows, 64, chroma,
            ss, (0, 255), False, True)
        want = torch.ones((rows, 64 // e), dtype=torch.bool)
        want[[0, -2, -1]], want[:, 0], want[:, -1] = False, False, False
        assert torch.equal(interior, want)


def test_chroma_taps_are_two_interleaved_columns_apart():
    """A chroma sample's taps are planar columns x0 and x0 + 1, i.e.
    interleaved columns cx + 2 (d >> 6) and two on, so u and v come from
    one window of seg + 2 samples at any displacement (no chroma trap).  A
    model that takes the second tap one interleaved column on is wrong,
    and the test can tell."""
    rng = np.random.default_rng(5)
    planes, blurred = _case(rng, 48, 128, 128, 2, 0, 9)
    t = torch.tensor(0.3)
    plain = KQ.bilinear_blend_plain(*planes, blurred, t, 2, 128)
    got, counts = bilinear_runs_model(*planes, blurred, t, 2, 128)
    _equal(got, plain)
    assert counts[1] > 0
    naive, _ = bilinear_runs_model(*planes, blurred, t, 2, 128,
                                   chroma_step=1)
    assert torch.equal(naive[0], plain[0])
    assert not torch.equal(naive[1], plain[1])


def test_a_pitch_off_the_16_byte_grid_takes_the_per_sample_step():
    """A stride that is not a multiple of 16 bytes refuses the vector path:
    every run takes the per-sample step, still the plain version's."""
    rng = np.random.default_rng(9)
    planes, blurred = _case(rng, 32, 64, 70, 1, 0, 3)
    assert not KW.vector_path(planes, 64)
    t = torch.tensor(0.6)
    got, counts = bilinear_runs_model(*planes, blurred, t, 1, 64, 0,
                                      (0, 255), True)
    assert counts == [0, 0]
    _equal(got, KQ.bilinear_blend_plain(*planes, blurred, t, 1, 64, 0,
                                        (0, 255), True))


@pytest.mark.parametrize("ss,levels,occlusion", [
    (0, (0.0, 255.0), False), (8, (16.0, 235.0), True)])
def test_bilinear_runs_equal_the_jax_bilinear_branch(ss, levels, occlusion):
    """One small case: the run model against the JAX package's
    _warp_sample(bilinear=True) on its gather path, as
    tests/test_torch_bilinear.py runs it."""
    h, w = 48, 64
    rng = np.random.default_rng(40 + ss)
    geom = FlowGeometry.create(h, w, w)
    planes = _planes(rng, h, w, ss)
    blur = _field(rng, geom, 6)
    t = 0.3
    (y, uv), counts = bilinear_runs_model(
        *(torch.from_numpy(p) for p in planes), torch.from_numpy(blur),
        torch.tensor(t), geom.res_scalar, w, ss, W.level_ints(*levels),
        occlusion)
    assert min(counts) > 0, counts
    ref_y, ref_uv = _jax_blend(geom, planes, blur, t, ss, levels, occlusion,
                               "gather")
    np.testing.assert_array_equal(y.numpy(), ref_y)
    np.testing.assert_array_equal(uv.numpy(), ref_uv)
