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
segment's source as a window assembled from the aligned 16-byte chunks
around it -- a later chunk only when the window reaches into it -- and a
chroma segment reads one window of seg + 2 samples from s - odd (odd: its
displacement's parity), its even (u) samples from the window's first seg
samples and its odd (v) samples from seg samples two further on (so at an
odd displacement u comes from s - 1 and v from s + 1).  Every other run
takes the per-sample step, the plain version's arithmetic.

The model below does the interior arithmetic independently of the plain
version (its own flow lookup per segment, its own window reads from the
row's bytes, its own u/v select) and checks that no chunk read leaves its
source row.  Hypothesis draws res scalars 0-3, widths that are not a
multiple of 16, strides wider than the width, large displacements, odd
flows and P010 with black/white levels.

One launch serves the whole frame and any even row band [r0, r1) (the
whole frame is the band [0, H)), both planes and every position at once:
grid.x the blocks of runs across a row, grid.y the band's luma block
rows, then its chroma block rows [r0 / 2, r1 / 2); a thread's run is
written at every position (the run's flows read once for all).
``launch_model`` walks that grid block by block, takes each thread's run
from the run model at its frame row, and checks that every output sample
of the band is written exactly once.  The level maps' quotient is a
multiply and a shift in the kernel (Divider); its exactness is checked
here too."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW

torch.set_num_threads(1)

RUN = KW.RUN_BYTES

# the thread block of the run kernels, as csrc/warp_runs.cuh declares it
_SHAPE = re.search(r"constexpr int kBX = (\d+), kBY = (\d+);",
                   (Path(KW.__file__).resolve().parents[2] / "csrc"
                    / "warp_runs.cuh").read_text())
KBX, KBY = int(_SHAPE[1]), int(_SHAPE[2])


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


def segment_samples(src, rows, xs, dx, seg, item, chroma):
    """Each segment's seg samples (..., seg) from source rows `rows` at
    columns xs + dx, as warp_runs.cuh's segment_windows reads them, and
    whether every chunk read stays in its row.  A chroma segment reads one
    window of seg + 2 samples from xs + dx - odd (odd the displacement's
    parity) and takes its even (u) samples from the window's first seg
    and its odd (v) samples from seg samples two further on; a luma
    segment (or chroma=False, the naive model) one window at xs + dx."""
    if not chroma:
        return _row_samples(src, rows, xs + dx, seg, item)
    odd = dx & 1
    win, legal = _row_samples(src, rows, xs + dx - odd, seg + 2, item)
    v = win.gather(-1, torch.arange(seg) + 2 * odd[..., None])
    parity = torch.arange(seg) & 1
    return torch.where(parity == 1, v, win[..., :seg]), legal


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
        samples[d], legal = segment_samples(src, r, X, dx[d], seg, item,
                                            chroma and chroma_trap)
        assert bool((legal | ~interior[..., None]).all()), \
            "a chunk read of an interior run leaves its source row"
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


def launch_grid(r0: int, r1: int, wa: int, item: int):
    """K2's launch over the band [r0, r1) of luma rows and [r0 / 2, r1 / 2)
    of chroma rows, wa samples of `item` bytes wide: (grid, luma block
    rows), as csrc/warp_pair.cu's Launch builds it from
    mfi::two_plane_grid: the blocks of runs across a row, then the luma
    block rows and the chroma ones (a block takes every position)."""
    e = RUN // item
    cols = -(-(-(-wa // e)) // KBX)
    luma, chroma = -(-(r1 - r0) // KBY), -(-((r1 - r0) // 2) // KBY)
    return (cols, luma + chroma), luma


def launch_model(f1y, f1uv, f2y, f2uv, blurred, ts, rs, wa, r0, r1, ss=0,
                 levels=(0, 255)):
    """The band [r0, r1) through K2's one launch: each block of the grid
    (run column, block row) writes the runs its threads own at every
    position, each run's samples those of ``runs_model`` at the run's
    frame row.  Returns (y, uv) and each output sample's count of
    writes."""
    (y, uv), _, _ = runs_model(f1y, f1uv, f2y, f2uv, blurred, ts, rs, wa,
                               ss, levels)
    n, item = ts.shape[0], f1y.element_size()
    e = RUN // item
    (cols, zs), luma_blocks = launch_grid(r0, r1, wa, item)
    bands = ((r0, r1, y), (r0 // 2, r1 // 2, uv))
    # int64 while filling: CPU tensors of uint16 take no index_put
    outs = [torch.zeros((n, hi - lo, wa), dtype=torch.int64)
            for lo, hi, _ in bands]
    hits = [torch.zeros_like(o) for o in outs]
    pos = torch.arange(n)[:, None, None]
    for z in range(zs):
        plane = int(z >= luma_blocks)
        lo, hi, src = bands[plane]
        by = z - luma_blocks if plane else z
        rows = lo + by * KBY + torch.arange(KBY)
        rows = rows[rows < hi]
        for col in range(cols):
            x0 = (col * KBX + torch.arange(KBX)) * e
            xs = (x0[x0 < wa][:, None] + torch.arange(e)).flatten()
            xs = xs[xs < wa]
            at = (pos, (rows - lo)[None, :, None], xs[None, None])
            outs[plane][at] = src[pos, rows[None, :, None],
                                  xs[None, None]].to(torch.int64)
            hits[plane][at] += 1
    return [o.to(y.dtype) for o in outs], hits


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), rs=st.integers(0, 3),
       ss=st.sampled_from([0, 8]), runs=st.integers(1, 20),
       ragged=st.integers(0, 15), pad=st.sampled_from([0, 16, 5]),
       half=st.integers(3, 40), edges=st.tuples(st.integers(0, 40),
                                                 st.integers(0, 40)),
       far=st.sampled_from([2, 9, 40, 300]),
       levels=st.sampled_from(_LEVELS), n=st.integers(1, 5))
def test_the_launch_writes_each_band_sample_once(seed, rs, ss, runs, ragged,
                                                 pad, half, edges, far,
                                                 levels, n):
    """Any even band (the whole frame among them), N = 1..5, both sample
    types: the launch's blocks write every output sample of both planes
    once, and the band equals the plain version's rows."""
    item = 2 if ss else 1
    width = max(3, runs * RUN // item - ragged)
    h = 2 * half
    a, b = sorted(min(x, half) for x in edges)
    r0, r1 = (2 * a, 2 * b) if a < b else (0, h)
    rng = np.random.default_rng(seed)
    planes, blurred = _case(rng, h, width, width + pad, rs, ss, far)
    ts = torch.from_numpy(rng.choice(
        np.float32([0.0, 0.25, 0.4, 0.6, 0.9999, 1.0]), n))
    got, hits = launch_model(*planes, blurred, ts, rs, width, r0, r1, ss,
                             levels)
    assert all(bool((h_ == 1).all()) for h_ in hits)
    _equal(got, KW.pair_blend_rows_plain(*planes, blurred, ts, rs, width,
                                         r0, r1, ss, levels))


@pytest.mark.parametrize("ss", [0, 8])
def test_bands_at_every_even_edge(ss):
    """Every even band of a 24-row frame (edges at every even row,
    stacked splits and the whole frame): each launch writes its samples
    once and equals the plain version's rows, odd chroma displacements
    included (odd flows at t = 0.4)."""
    rng = np.random.default_rng(24 + ss)
    item = 2 if ss else 1
    width = 48 // item
    planes, blurred = _case(rng, 24, width, width, 2, ss, 9)
    ts = torch.tensor([0.0, 0.4, 1.0], dtype=torch.float32)
    levels = W.level_ints(16, 235) if ss else (0, 255)
    whole, _, _ = runs_model(*planes, blurred, ts, 2, width, ss, levels)
    for r0 in range(0, 24, 2):
        for r1 in range(r0 + 2, 25, 2):
            got, hits = launch_model(*planes, blurred, ts, 2, width, r0, r1,
                                     ss, levels)
            assert all(bool((h_ == 1).all()) for h_ in hits), (r0, r1)
            _equal(got, (whole[0][:, r0:r1], whole[1][:, r0 // 2:r1 // 2]))
    _equal(whole, KW.pair_blend_plain(*planes, blurred, ts, 2, width, ss,
                                      levels))


@pytest.mark.parametrize("item,cols", [(1, 30), (2, 60)])
def test_one_block_takes_every_position(item, cols):
    """One block for all positions of its runs (it loops over them), so
    the runs' flow lookups serve every position; at 4K: 240 runs a row at
    8 bits (480 under P010) in blocks of KBX, 68 luma block rows, then 34
    chroma; a quarter band 17 and 9."""
    assert (KBX, KBY) == (8, 32)
    assert launch_grid(0, 2160, 3840, item) == ((cols, 102), 68)
    assert launch_grid(540, 1080, 3840, item) == ((cols, 17 + 9), 17)


def _divider(d: int):
    """warp_common.cuh's divider(d): l = ceil(log2 d), m = ceil(2^(31 + l)
    / d), the shift 31 + l."""
    l = max(d - 1, 0).bit_length()
    return -(-(1 << (31 + l)) // d), 31 + l


def test_level_divider_is_exact_division():
    """The kernels' level maps (K2, K4, G1, Q1) take the quotient
    floor(n / d) as (n * m) >> (31 + l) with m < 2^32 (warp_common.cuh,
    Divider): every
    divisor up to 2^16 meets the exactness condition 0 <= m d -
    2^(31 + l) < 2^l, and the quotients equal n // d at the extremes of
    n in [0, 2^31) and around multiples of d."""
    d = np.arange(1, 1 << 16, dtype=object)
    for dd in d:
        m, sh = _divider(int(dd))
        e = m * dd - (1 << sh)
        assert 0 <= e < (1 << (sh - 31)) and m < (1 << 32), dd
    rng = np.random.default_rng(16)
    for dd in (1, 2, 3, 7, 219, 235, 255, 256, 257, 4095, 16000, 65535,
               (1 << 30) + 1, (1 << 31) - 1):
        m, sh = _divider(dd)
        top = (1 << 31) - 1
        ns = {0, 1, dd - 1, dd, dd + 1, top, top - 1, top - top % dd,
              top - top % dd - 1}
        ns |= {int(x) for x in rng.integers(0, 1 << 31, 200)}
        ns |= {j * dd + r for j in rng.integers(0, top // dd + 1, 50)
               for r in (-1, 0, 1) if 0 <= j * dd + r <= top}
        for n in ns:
            assert (n * m) >> sh == n // dd, (dd, n)
