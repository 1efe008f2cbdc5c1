"""K2's run decomposition (csrc/warp_pair.cu), modelled in plain PyTorch
and held bit-exact against pair_blend_plain, which the other CPU tests hold
against the JAX package.

The kernel gives each thread a 16-byte output run of one row (16 samples
at 8 bits, 8 at P010).  A run is cut into segments of one flow cell (2^rs
luma samples, 2^(rs+1) interleaved chroma samples), capped at the run; each
segment's displacement is computed once a position from the cell's flow.
A run is interior when no sample's warped coordinate needs mirror_edge2 to
do more than the identity, i.e. every one lies in [1, dim - 2] (and the
launch may take the vector path at all); an interior run reads each
segment's source as a 16-byte window assembled from the aligned 16-byte
chunks around it -- the second chunk only when the window reaches into it
-- and a chroma segment with an odd displacement reads two windows, at
s - 1 for its even (u) samples and s + 1 for its odd (v) samples.  Every
other run takes the per-sample step, the plain version's arithmetic.

The model below does the interior arithmetic independently of the plain
version (its own flow lookup per segment, its own window reads from the
row's bytes, its own u/v select) and checks that no chunk read leaves its
source row.  Hypothesis draws res scalars 0-3, widths that are not a
multiple of 16, strides wider than the width, large displacements, odd
flows and P010 with black/white levels."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW

torch.set_num_threads(1)

RUN = KW.RUN_BYTES


def _row_samples(src, rows, starts, count, item):
    """count samples of `src` rows `rows` from column `starts` on, read as
    the kernels' window_words reads them: the bytes of the window assembled
    from the aligned 16-byte chunks around it, chunk c read only when the
    window's count * item bytes reach into it (0 where a chunk was not
    read).  Also returns whether every chunk read stays in the row."""
    row_bytes = src.shape[1] * item
    raw = src.contiguous().view(torch.uint8).to(torch.int64)
    sb = starts * item
    a, o = sb & ~(RUN - 1), sb & (RUN - 1)
    need = count * item
    chunks = (need + 30) // RUN          # the most a window spans
    legal = a >= 0
    for c in range(chunks):
        read = (o + need > RUN * c) if c else torch.ones_like(o, dtype=bool)
        legal = legal & (~read | (a + RUN * (c + 1) <= row_bytes))
    out = []
    for j in range(count):
        v = torch.zeros_like(sb)
        for b in range(item):
            k = j * item + b             # byte k of the window
            idx = (sb + k).clamp(0, row_bytes - 1)
            read = (o + k) // RUN == 0
            for c in range(1, chunks):
                read = read | (((o + k) // RUN == c) & (o + need > RUN * c))
            v = v | (torch.where(read, raw[rows, idx], 0) << (8 * b))
        out.append(v)
    return torch.stack(out, dim=-1), legal


def _plane_runs(f1, f2, blurred, ts, rs, rows, wa, chroma, ss, k, w, vec,
                chroma_trap=True):
    """One plane through the run decomposition: (N, rows, wa) output, the
    (N, rows, runs) interior mask."""
    item = f1.element_size()
    e = RUN // item                      # samples a run
    lseg = min(rs + int(chroma), e.bit_length() - 1)
    seg = 1 << lseg
    nseg = e // seg
    nruns = -(-wa // e)
    _, lh, lw = blurred.shape
    i64 = torch.int64
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
    f32 = torch.float32
    t12 = ts.to(f32)[:, None, None, None]              # (N, 1, 1, 1)
    t21 = 1.0 - t12
    a = oy12.to(f32)[None] * t12
    b = oy21.to(f32)[None] * t21
    if chroma:
        a, b = a * 0.5, b * 0.5
    dx = {12: W.iround(ox12.to(f32)[None] * t12).to(i64),
          21: -W.iround(ox21.to(f32)[None] * t21).to(i64)}
    dy = {12: W.iround(a).to(i64), 21: -W.iround(b).to(i64)}
    X, Y = xs[None, None], cy[None, :, None, None]
    ok = ((X + torch.minimum(dx[12], dx[21]) >= 1)
          & (X + seg - 1 + torch.maximum(dx[12], dx[21]) <= wa - 2)
          & (Y + torch.minimum(dy[12], dy[21]) >= 1)
          & (Y + torch.maximum(dy[12], dy[21]) <= rows - 2))
    interior = ok.all(dim=-1) & vec                    # (N, Y, R)

    samples = {}
    for d, src in ((12, f1), (21, f2)):
        r = (Y + dy[d]).clamp(0, rows - 1)
        odd = (dx[d] & 1) if (chroma and chroma_trap) else 0
        even_s, legal_a = _row_samples(src, r, X + dx[d] - odd, seg, item)
        odd_s, legal_b = _row_samples(src, r, X + dx[d] + odd, seg, item)
        inside = interior[..., None]
        assert bool((legal_a | ~inside).all() and (legal_b | ~inside).all()), \
            "a chunk read of an interior run leaves its source row"
        parity = torch.arange(seg) & 1
        samples[d] = torch.where(parity == 1, odd_s, even_s)  # (N,Y,R,G,S)
    w1, T = W.blend_weights(ts, ss)
    shape = (-1, 1, 1, 1, 1)
    bl = W.blend_fix(samples[12], samples[21], w1.reshape(shape),
                     T.reshape(shape), ss)
    out = W.levels_uv(bl, w, ss) if chroma else W.levels_y(bl, k, w, ss)
    n = ts.shape[0]
    out = out.reshape(n, rows, nruns * e)[..., :wa]
    return out, interior


def runs_model(f1y, f1uv, f2y, f2uv, blurred, ts, rs, wa, ss=0,
               levels=(0, 255), chroma_trap=True):
    """K2 through its runs: interior runs as modelled above, every other
    run per sample (the plain version's values).  Returns (y, uv) and the
    count of interior (run, position)s of each plane."""
    k, w = levels
    plain = KW.pair_blend_plain(f1y, f1uv, f2y, f2uv, blurred, ts, rs, wa,
                                ss, levels)
    vec = KW.vector_path((f1y, f1uv, f2y, f2uv), wa)
    outs, counts = [], []
    for f1, f2, chroma, want in ((f1y, f2y, False, plain[0]),
                                 (f1uv, f2uv, True, plain[1])):
        got, interior = _plane_runs(f1, f2, blurred, ts, rs, f1.shape[0], wa,
                                    chroma, ss, k, w, vec, chroma_trap)
        e = RUN // f1.element_size()
        per_sample = interior.repeat_interleave(e, dim=-1)[..., :wa]
        outs.append(torch.where(per_sample, got, want.to(torch.int64))
                    .to(want.dtype))
        counts.append(int(interior.sum()))
    return outs, counts, plain


def _case(rng, h, width, stride, rs, ss, far):
    dt = np.uint16 if ss else np.uint8
    hi = 1 << (16 if ss else 8)
    planes = [torch.from_numpy(rng.integers(0, hi, (r, stride)).astype(dt))
              for r in (h, h // 2, h, h // 2)]
    lh, lw = -(-h // (1 << rs)), -(-stride // (1 << rs))
    flow = rng.integers(-far, far + 1, (2, lh, lw))
    odd = rng.random((2, lh, lw)) < 0.5
    flow = np.where(odd, flow | 1, flow)
    return planes, torch.from_numpy(flow.astype(np.int32))


def _equal(got, want):
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        np.testing.assert_array_equal(g.numpy(), w_.numpy())


_LEVELS = [(0, 255), W.level_ints(16, 235), W.level_ints(16.5, 235.5),
           (0, 1)]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), rs=st.integers(0, 3),
       ss=st.sampled_from([0, 8]), runs=st.integers(1, 6),
       ragged=st.integers(0, 15), pad=st.sampled_from([0, 16, 5, 32]),
       rows=st.integers(3, 20), far=st.sampled_from([2, 9, 40, 300]),
       levels=st.sampled_from(_LEVELS),
       ts=st.lists(st.sampled_from([0.0, 0.4, 0.9999, 1.0, 0.25, 0.6]),
                   min_size=1, max_size=3))
def test_runs_equal_the_plain_version(seed, rs, ss, runs, ragged, pad, rows,
                                      far, levels, ts):
    item = 2 if ss else 1
    width = max(3, runs * RUN // item - ragged)
    stride = width + pad
    rng = np.random.default_rng(seed)
    planes, blurred = _case(rng, 2 * rows, width, stride, rs, ss, far)
    got, _, plain = runs_model(*planes, blurred,
                               torch.tensor(ts, dtype=torch.float32), rs,
                               width, ss, levels)
    _equal(got, plain)


@pytest.mark.parametrize("ss", [0, 8])
@pytest.mark.parametrize("rs", [0, 1, 2, 3])
def test_interior_runs_take_the_vector_path(ss, rs):
    """At moderate flow most runs are interior, both planes, every res
    scalar; the result is still the plain version's."""
    rng = np.random.default_rng(rs + ss)
    planes, blurred = _case(rng, 48, 128, 144, rs, ss, 3)
    ts = torch.tensor([0.0, 0.4, 1.0], dtype=torch.float32)
    got, counts, plain = runs_model(*planes, blurred, ts, rs, 128, ss)
    _equal(got, plain)
    item = 2 if ss else 1
    runs = 3 * (48 + 24) * (128 * item // RUN)
    assert sum(counts) > runs // 2, counts


def test_the_chroma_trap():
    """Odd chroma displacements: u (even) samples read s - 1 and v (odd)
    samples s + 1.  A model that reads one window at s for both is
    wrong -- the test can tell.  (At t = 0 or 1 one direction has weight
    0 and the other no displacement, so the trap shows between: a flow
    of 2 (2k + 1) at t = 0.5 displaces by an odd 2k + 1 both ways.)"""
    rng = np.random.default_rng(7)
    planes, _ = _case(rng, 48, 128, 128, 2, 0, 3)
    lh, lw = 12, 32
    blurred = torch.from_numpy(np.stack([
        2 * (2 * rng.integers(-3, 4, (lh, lw)) + 1),
        rng.integers(-3, 4, (lh, lw))]).astype(np.int32))
    ts = torch.tensor([0.5], dtype=torch.float32)
    got, counts, plain = runs_model(*planes, blurred, ts, 2, 128)
    _equal(got, plain)
    assert counts[1] > 0
    naive, _, _ = runs_model(*planes, blurred, ts, 2, 128,
                             chroma_trap=False)
    assert not torch.equal(naive[1], plain[1])
    assert torch.equal(naive[0], plain[0])


@pytest.mark.parametrize("ss", [0, 8])
def test_frame_edges_are_always_edge_runs(ss):
    """At zero flow mirror_edge2 still moves column 0, column Wa - 1, row
    0 and row rows - 1, so their runs take the per-sample step; every
    other run is interior."""
    rng = np.random.default_rng(ss)
    planes, _ = _case(rng, 16, 64, 64, 0, ss, 1)
    blurred = torch.zeros((2, 16, 64), dtype=torch.int32)
    ts = torch.tensor([0.0, 0.5], dtype=torch.float32)
    e = RUN // (2 if ss else 1)
    for f1, f2, chroma in ((planes[0], planes[2], False),
                           (planes[1], planes[3], True)):
        rows = f1.shape[0]
        _, interior = _plane_runs(f1, f2, blurred, ts, 0, rows, 64, chroma,
                                  ss, 0, 255, True)
        want = torch.ones((2, rows, 64 // e), dtype=torch.bool)
        want[:, 0], want[:, -1], want[:, :, 0], want[:, :, -1] = (False,) * 4
        assert torch.equal(interior, want)


def test_vector_path_needs_16_byte_rows():
    u8 = torch.zeros((8, 64), dtype=torch.uint8)
    assert KW.vector_path((u8, u8), 64)
    assert KW.vector_path((u8, u8), 48)
    assert not KW.vector_path((u8, u8), 60)        # output rows
    odd = torch.zeros((8, 72), dtype=torch.uint8)
    assert not KW.vector_path((odd, odd), 64)      # source pitch
    shifted = torch.zeros(8 * 64 + 1, dtype=torch.uint8)[1:].view(8, 64)
    assert not KW.vector_path((u8, shifted), 48)    # plane start
    u16 = torch.zeros((8, 40), dtype=torch.uint16)
    assert KW.vector_path((u16, u16), 32)
    assert not KW.vector_path((u16, u16), 36)
