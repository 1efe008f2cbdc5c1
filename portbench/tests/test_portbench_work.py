"""The work counts of ``portbench/work.py``: they follow the algorithm's
shapes (radius, outputs, pixel width) and nothing else."""

import pytest

from portbench import work
from portbench.reference import pair as ref

UHD = ref.geometry(2160, 3840, 3840, 270)


def k1(radius=16, item=1, shift=0, geom=UHD):
    return work.k1(geom.height, geom.stride, geom.lh, geom.lw, geom.windows,
                   radius, item, shift)


def test_uhd_geometry_is_the_reference_schedule():
    assert (UHD.rs, UHD.lh, UHD.lw) == (3, 270, 480)
    assert UHD.windows == (256, 128, 64, 32, 16, 8, 4, 2)


def test_k1_operations_are_linear_in_the_radius():
    a, b, c = (k1(r).ops for r in (4, 8, 16))
    assert c - b == pytest.approx(2 * (b - a))
    # every candidate of every layer: 16 steps of lh * lw pixels
    cand = 2 * len(UHD.windows) * 16 * UHD.lh * UHD.lw
    base = (work.SAD_OPS + work.DELTA_SHIFT_OPS + work.OFFSET_BIAS_OPS
            + work.WINDOW_SUM_OPS)
    assert k1(16).ops > cand * base


def test_k1_p010_adds_its_shift_and_doubles_sample_bytes():
    nv12, p010 = k1(item=1, shift=0), k1(item=2, shift=8)
    cand = 2 * len(UHD.windows) * 16 * UHD.lh * UHD.lw
    assert p010.ops - nv12.ops == cand * work.LUMA_SHIFT_OPS
    field = 2 * 2 * UHD.lh * UHD.lw * 4
    assert p010.nbytes - field == pytest.approx(2 * (nv12.nbytes - field))


def test_warp_bytes_and_operations_follow_the_outputs():
    h, w, s, lh, lw = 2160, 3840, 3840, 270, 480
    one_out = h * w + (h // 2) * w
    for item in (1, 2):
        for levels in ((0, 255), (16, 235)):
            pair = [work.warp(h, w, s, lh, lw, item, n, levels)
                    for n in range(1, 6)]
            for n in range(1, 5):
                # another output: its samples written once, its position
                assert pair[n].nbytes - pair[n - 1].nbytes == \
                    one_out * item + 4
                assert pair[n].ops == (n + 1) * pair[0].ops
            # both sources and the field are read once a pair, however
            # many outputs (and launches) the pair has
            sources = 2 * one_out * item + 2 * lh * lw * 4
            assert pair[4].nbytes == sources + 5 * (one_out * item + 4)


def test_counts_depend_on_shapes_only():
    assert k1() == k1()
    small = ref.geometry(64, 96, 96, 270)
    assert k1(geom=small).ops < k1().ops
    assert work.c1(2160, 3840, 3, 270, 480, 1, 5) == \
        work.c1(2160, 3840, 3, 270, 480, 1, 5)


def test_uhd_least_times_on_the_h100():
    peaks = work.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks is not None
    assert work.peaks_for("a card the table lacks") is None
    h, w = 2160, 3840
    nv12 = work.warp(h, w, w, 270, 480, 1, 5, (0, 255))
    p010 = work.warp(h, w, w, 270, 480, 2, 5, (16, 235))
    assert work.bound_by(nv12, peaks) == "bytes"
    assert work.bound_by(p010, peaks) == "bytes"
    assert work.least_s(nv12, peaks) * 1e3 == pytest.approx(0.0263, abs=5e-4)
    # P010's pair: both 25 MB sources once and five outputs, ~175 MB
    assert work.least_s(p010, peaks) * 1e3 == pytest.approx(0.0523, abs=5e-4)
    # K1's integer operations against the INT32 rate (half the FP32 lanes)
    assert work.bound_by(k1(), peaks) == "operations"
    assert work.least_s(k1(), peaks) * 1e3 == pytest.approx(0.0372,
                                                             abs=1e-3)
    c1 = work.c1(h, w, 3, 270, 480, 1, 5)
    assert work.least_s(c1, peaks) * 1e3 < 0.001
