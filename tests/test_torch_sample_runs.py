"""K5's and K4's run decomposition (csrc/warp_sample.cu and
csrc/warp_fused.cu over csrc/warp_runs.cuh), modelled in plain PyTorch and
held bit-exact against sample_dir_plain and fused_blend_plain, and on one
small case each against the JAX package.

K5 gives each thread a 16-byte output run of one row of ONE direction: the
run is cut into segments of one flow cell (2^rs luma samples, 2^(rs+1)
interleaved chroma samples), capped at the run; per segment, one flow
lookup (the forward flow for direction 12; for 21 the forward flow, then
the reverse flow through it) and one rounded displacement.  An interior
segment (every warped coordinate in [1, dim - 2]) reads a window
assembled from the aligned chunks around it, a chroma segment one of two
more samples from s - odd (u from s - 1, v from s + 1 at an odd
displacement); the window's samples are the output's.  Every other run takes the per-sample step, the
plain version's arithmetic.  The model below does this independently of
the plain version (its own flow lookup, window reads from the row's bytes
and u/v select) and checks that no chunk read of an interior run leaves
its source row.

K4 is K2's run body at one position, so its model is K2's
(tests/test_torch_warp_runs.py) at N = 1 with t a 0-dim tensor, as the
engine hands it a position.

Hypothesis draws res scalars 0-3, widths that are not a multiple of 16,
strides wider than the width, large and odd flows, both directions, and
P010 with black/white levels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mpv_frame_interpolator_tpu.ops import warp as JW
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry
from mpv_frame_interpolator_tpu.ops.pallas import warp_fused as JWF
from mpv_frame_interpolator_tpu_torch.ops import warp as W
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KD
from test_torch_warp_runs import _LEVELS, RUN, _case, _equal, runs_model, \
    segment_samples

torch.set_num_threads(1)


def _plane_sample_runs(src, blurred, t, direction, rs, rows, wa, chroma, vec,
                       chroma_trap=True):
    """One plane of one direction through K5's runs: the (rows, wa) output
    as the interior runs read it, and the (rows, runs) interior mask."""
    item = src.element_size()
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
    ox, oy = bx[sy, sx], by[sy, sx]                    # (Y, R, G)
    s = t.to(f32).reshape(())
    if direction == 21:
        bsy = (sy - (oy >> rs)).clamp(0, lh - 1)
        bsx = (sx - (ox >> rs)).clamp(0, lw - 1)
        ox, oy = bx[bsy, bsx], by[bsy, bsx]
        s = 1.0 - s
    a = oy.to(f32) * s
    if chroma:
        a = a * 0.5
    sign = -1 if direction == 21 else 1
    dx = sign * W.iround(ox.to(f32) * s).to(i64)
    dy = sign * W.iround(a).to(i64)
    X, Y = xs[None], cy[:, None, None]
    ok = ((X + dx >= 1) & (X + seg - 1 + dx <= wa - 2)
          & (Y + dy >= 1) & (Y + dy <= rows - 2))
    interior = ok.all(dim=-1) & vec                    # (Y, R)
    r = (Y + dy).clamp(0, rows - 1)
    out, legal = segment_samples(src, r, X, dx, seg, item,
                                 chroma and chroma_trap)  # (Y, R, G, S)
    assert bool((legal | ~interior[..., None]).all()), \
        "a chunk read of an interior run leaves its source row"
    return out.reshape(rows, nruns * e)[:, :wa], interior


def sample_runs_model(f1y, f1uv, f2y, f2uv, blurred, t, direction, rs, wa,
                      chroma_trap=True):
    """K5 through its runs: interior runs as modelled above, every other
    run per sample (the plain version's values).  Returns (y, uv), the
    count of interior runs of each plane and the plain version's output."""
    plain = KD.sample_dir_plain(f1y, f1uv, f2y, f2uv, blurred, t, direction,
                                rs, wa)
    src = (f1y, f1uv) if direction == 12 else (f2y, f2uv)
    vec = KW.vector_path(src, wa)
    outs, counts = [], []
    for plane, chroma, want in ((src[0], False, plain[0]),
                                (src[1], True, plain[1])):
        got, interior = _plane_sample_runs(plane, blurred, t, direction, rs,
                                           plane.shape[0], wa, chroma, vec,
                                           chroma_trap)
        e = RUN // plane.element_size()
        per_sample = interior.repeat_interleave(e, dim=-1)[..., :wa]
        outs.append(torch.where(per_sample, got, want.to(torch.int64))
                    .to(want.dtype))
        counts.append(int(interior.sum()))
    return outs, counts, plain


def fused_runs_model(f1y, f1uv, f2y, f2uv, blurred, t, rs, wa, ss=0,
                     levels=(0, 255)):
    """K4 through its runs: K2's run body at the one position t (0-dim).
    Returns (y, uv) and the count of interior runs of each plane."""
    (y, uv), counts, _ = runs_model(f1y, f1uv, f2y, f2uv, blurred,
                                    t.reshape(1), rs, wa, ss, levels)
    return (y[0], uv[0]), counts


_TS = [0.0, 0.4, 0.9999, 1.0, 0.25, 0.6]


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), rs=st.integers(0, 3),
       ss=st.sampled_from([0, 8]), runs=st.integers(1, 6),
       ragged=st.integers(0, 15), pad=st.sampled_from([0, 16, 5, 32]),
       rows=st.integers(3, 20), far=st.sampled_from([2, 9, 40, 300]),
       t=st.sampled_from(_TS), direction=st.sampled_from([12, 21]))
def test_sample_runs_equal_the_plain_version(seed, rs, ss, runs, ragged, pad,
                                             rows, far, t, direction):
    item = 2 if ss else 1
    width = max(3, runs * RUN // item - ragged)
    rng = np.random.default_rng(seed)
    planes, blurred = _case(rng, 2 * rows, width, width + pad, rs, ss, far)
    got, _, plain = sample_runs_model(*planes, blurred,
                                      torch.tensor(t, dtype=torch.float32),
                                      direction, rs, width)
    _equal(got, plain)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), rs=st.integers(0, 3),
       ss=st.sampled_from([0, 8]), runs=st.integers(1, 6),
       ragged=st.integers(0, 15), pad=st.sampled_from([0, 16, 5, 32]),
       rows=st.integers(3, 20), far=st.sampled_from([2, 9, 40, 300]),
       levels=st.sampled_from(_LEVELS), t=st.sampled_from(_TS))
def test_fused_runs_equal_the_plain_version(seed, rs, ss, runs, ragged, pad,
                                            rows, far, levels, t):
    item = 2 if ss else 1
    width = max(3, runs * RUN // item - ragged)
    rng = np.random.default_rng(seed)
    planes, blurred = _case(rng, 2 * rows, width, width + pad, rs, ss, far)
    tt = torch.tensor(t, dtype=torch.float32)
    got, _ = fused_runs_model(*planes, blurred, tt, rs, width, ss, levels)
    _equal(got, KF.fused_blend_plain(*planes, blurred, tt, rs, width, ss,
                                     levels))


@pytest.mark.parametrize("direction", [12, 21])
@pytest.mark.parametrize("ss", [0, 8])
@pytest.mark.parametrize("rs", [0, 1, 2, 3])
def test_interior_sample_runs_take_the_vector_path(rs, ss, direction):
    """At moderate flow most of K5's runs are interior, both planes, every
    res scalar, both directions; the result is still the plain
    version's."""
    rng = np.random.default_rng(10 * rs + ss + direction)
    planes, blurred = _case(rng, 48, 128, 144, rs, ss, 3)
    got, counts, plain = sample_runs_model(
        *planes, blurred, torch.tensor(0.4), direction, rs, 128)
    _equal(got, plain)
    item = 2 if ss else 1
    runs = (48 + 24) * (128 * item // RUN)
    assert sum(counts) > runs // 2, counts
    assert min(counts) > 0, counts


@pytest.mark.parametrize("direction", [12, 21])
def test_the_chroma_trap_of_one_direction(direction):
    """An odd chroma displacement: u (even) samples read s - 1 and v (odd)
    samples s + 1.  A model that reads one window at s for both is wrong,
    and the test can tell.  A flow of 2 (2k + 1) at t = 0.5 displaces by
    an odd 2k + 1 in either direction."""
    rng = np.random.default_rng(11)
    planes, _ = _case(rng, 48, 128, 128, 2, 0, 3)
    lh, lw = 12, 32
    blurred = torch.from_numpy(np.stack([
        2 * (2 * rng.integers(-3, 4, (lh, lw)) + 1),
        rng.integers(-3, 4, (lh, lw))]).astype(np.int32))
    t = torch.tensor(0.5)
    got, counts, plain = sample_runs_model(*planes, blurred, t, direction, 2,
                                           128)
    _equal(got, plain)
    assert counts[1] > 0
    naive, _, _ = sample_runs_model(*planes, blurred, t, direction, 2, 128,
                                    chroma_trap=False)
    assert not torch.equal(naive[1], plain[1])
    assert torch.equal(naive[0], plain[0])


@pytest.mark.parametrize("ss", [0, 8])
def test_frame_edges_are_always_edge_sample_runs(ss):
    """At zero flow mirror_edge2 still moves column 0, column Wa - 1, row
    0 and row rows - 1, so their runs take the per-sample step; every
    other run is interior."""
    rng = np.random.default_rng(ss + 1)
    planes, _ = _case(rng, 16, 64, 64, 0, ss, 1)
    blurred = torch.zeros((2, 16, 64), dtype=torch.int32)
    e = RUN // (2 if ss else 1)
    for plane, chroma in ((planes[0], False), (planes[1], True)):
        rows = plane.shape[0]
        for direction in (12, 21):
            _, interior = _plane_sample_runs(plane, blurred,
                                             torch.tensor(0.5), direction,
                                             0, rows, 64, chroma, True)
            want = torch.ones((rows, 64 // e), dtype=torch.bool)
            want[0], want[-1], want[:, 0], want[:, -1] = (False,) * 4
            assert torch.equal(interior, want)


@pytest.mark.parametrize("ss", [0, 8])
def test_fused_runs_at_a_0_dim_position_take_the_vector_path(ss):
    """K4's runs at one position, handed as the engine hands it (a 0-dim
    tensor): most runs interior at moderate flow, exact, and equal to K2's
    output at that position."""
    rng = np.random.default_rng(ss + 3)
    planes, blurred = _case(rng, 48, 128, 144, 2, ss, 3)
    levels = W.level_ints(16.5, 235.5)
    ts = torch.tensor([0.0, 0.4, 1.0])
    pair = KW.pair_blend_plain(*planes, blurred, ts, 2, 128, ss, levels)
    for n in range(3):
        got, counts = fused_runs_model(*planes, blurred, ts[n], 2, 128, ss,
                                       levels)
        _equal(got, KF.fused_blend_plain(*planes, blurred, ts[n], 2, 128, ss,
                                         levels))
        _equal(got, (pair[0][n], pair[1][n]))
        item = 2 if ss else 1
        assert sum(counts) > (48 + 24) * (128 * item // RUN) // 2, counts


def _jax_case(seed, dt, values, h=48, w=64):
    """Planar JAX planes, the port's interleaved planes and a flow field
    drawn from `values`, from a numpy seed."""
    geom = FlowGeometry.create(h, w, w)
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dt).max + 1
    planes = [[rng.integers(0, hi, s).astype(dt)
               for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
              for _ in range(2)]
    pick = rng.integers(0, len(values), (geom.low_h, geom.low_w))
    blurred = np.stack([np.array([v[0] for v in values], np.int32)[pick],
                        np.array([v[1] for v in values], np.int32)[pick]])
    port = []
    for y, u, v in planes:
        uv = np.empty((h // 2, w), dt)
        uv[:, 0::2], uv[:, 1::2] = u, v
        port += [torch.from_numpy(y), torch.from_numpy(uv)]
    return geom, planes, port, blurred


@pytest.mark.parametrize("dt", [np.uint8, np.uint16])
def test_sample_runs_equal_the_jax_pallas_sampler(dt):
    """One small case: K5's run model against the JAX package's shift
    sampler with its Pallas kernel in interpret mode, both directions."""
    values = [(0, 0), (5, -3), (-7, 2), (3, 3)]
    geom, (f1, f2), port, blurred = _jax_case(21, dt, values)
    fields = JW._warp_fields(geom, jnp.asarray(blurred), full_res=False)
    jf1, jf2 = [jnp.asarray(p) for p in f1], [jnp.asarray(p) for p in f2]
    prep = JW._sampler_prep(geom, fields, *jf1, *jf2)
    assert bool(prep["ok"]), "test field must stay inside the shift gates"
    fields["SPREP"] = prep
    t = 0.4
    sp = [np.asarray(p) for p in JW._sample_all_planes(
        geom, fields, *jf1, *jf2, jnp.float32(t), jnp.float32(1.0) -
        jnp.float32(t), pallas=True)]
    for direction, y_ref, u_ref, v_ref in ((12, sp[0], sp[2], sp[4]),
                                           (21, sp[1], sp[3], sp[5])):
        (y, uv), counts, _ = sample_runs_model(
            *port, torch.from_numpy(blurred), torch.tensor(t), direction,
            geom.res_scalar, geom.actual_width)
        assert min(counts) > 0
        np.testing.assert_array_equal(y.numpy(), y_ref)
        np.testing.assert_array_equal(uv[:, 0::2].numpy(), u_ref)
        np.testing.assert_array_equal(uv[:, 1::2].numpy(), v_ref)


@pytest.mark.parametrize("ss", [0, 8])
def test_fused_runs_equal_the_jax_fused_kernel(ss):
    """One small case: K4's run model against the JAX package's fused
    Pallas kernel in interpret mode (blended_from_prep)."""
    dt = np.uint16 if ss else np.uint8
    geom, (f1, f2), port, blurred = _jax_case(22 + ss, dt,
                                              [(3, -2), (-4, 1), (0, 0)])
    fields = JW._warp_fields(geom, jnp.asarray(blurred))
    prep = JW._sampler_prep(geom, fields, *[jnp.asarray(p) for p in f1],
                            *[jnp.asarray(p) for p in f2], fused=True)
    assert bool(prep["ok"]), "test field must stay inside the shift gates"
    t = 0.4
    y_f, uv_f = JWF.blended_from_prep(geom, prep, jnp.float32(t), ss)
    (y, uv), counts = fused_runs_model(*port, torch.from_numpy(blurred),
                                       torch.tensor(t), geom.res_scalar,
                                       geom.actual_width, ss)
    assert min(counts) > 0
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_f))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(uv_f))
