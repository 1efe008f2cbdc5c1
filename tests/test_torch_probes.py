"""The toolchain probes P1 and P2 of the port on the CPU: the plain
versions (what each probe's kernel is held against on the card) against
the numpy hypotheses of the JAX package's probes (``tools/
pallas_pack_probe.py``, ``tools/pallas_dma_probe.py``), the host's
cp.async alignment rule on the seven DMA cases, and the probes' CPU
dispatch.  Bit-exact.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu_torch.tools import dma_probe as DP
from mpv_frame_interpolator_tpu_torch.tools import pack_probe as PP

torch.set_num_threads(1)


def _pack4(a8):
    """Little-endian uint32 words of four consecutive columns (the card's
    row-major packing)."""
    return (a8[:, 0::4].astype(np.uint32)
            | (a8[:, 1::4].astype(np.uint32) << 8)
            | (a8[:, 2::4].astype(np.uint32) << 16)
            | (a8[:, 3::4].astype(np.uint32) << 24)).astype(np.int32)


def _quads(a8):
    """The JAX probe's hypothesis: word (r, c) = rows 4r..4r+3 of column c,
    little-endian."""
    return _pack4(a8.T).T


@pytest.fixture(scope="module")
def x():
    return PP.make_inputs(0)


def test_b32_is_the_little_endian_column_pack(x):
    got = PP.plain("b32", "column words", x)
    assert got.dtype == torch.int32 and got.shape == (PP.R, PP.C // 4)
    np.testing.assert_array_equal(got.numpy(), _pack4(x["a"].numpy()))


def test_b32_row_quads_is_the_jax_packing(x):
    got = PP.plain("b32", None, x)
    assert got.dtype == torch.int32 and got.shape == (PP.R // 4, PP.C)
    np.testing.assert_array_equal(got.numpy(), _quads(x["a"].numpy()))


@pytest.mark.parametrize("shift", [0, 1, 4, 5, 15, 16, PP.C - 1])
def test_colroll_is_a_column_roll(x, shift):
    got = PP.colroll_plain(x["a"], shift)
    assert got.dtype == torch.int32 and got.shape == (PP.R // 4, PP.C)
    np.testing.assert_array_equal(
        got.numpy(), _quads(np.roll(x["a"].numpy(), shift, axis=1)))


@pytest.mark.parametrize("shift", [0, 1, 4, 5, 7, 15, 16, PP.R - 1])
def test_rowroll_is_a_row_roll(x, shift):
    got = PP.rowroll_plain(x["a"], shift)
    assert got.dtype == torch.int32 and got.shape == (PP.R // 4, PP.C)
    np.testing.assert_array_equal(
        got.numpy(), _quads(np.roll(x["a"].numpy(), -shift, axis=0)))


def test_shifts_wrap_as_np_roll_does(x):
    """run takes a shift modulo its axis: -1 and C + 5 columns, -3 and R + 7
    rows."""
    a = x["a"].numpy()
    for s in (-1, PP.C + 5):
        np.testing.assert_array_equal(
            PP.run("colroll", None, x, col_shift=s).numpy(),
            _quads(np.roll(a, s, axis=1)))
    for s in (-3, PP.R + 7):
        np.testing.assert_array_equal(
            PP.run("rowroll", None, x, row_shift=s).numpy(),
            _quads(np.roll(a, -s, axis=0)))


@pytest.mark.parametrize("shift", [0, 1, 2, 3, 4, 5, 11, 15, 16])
def test_vec16_is_a_column_shift(x, shift):
    a = x["a"].numpy()
    got = PP.vec16_plain(x["a"], shift).numpy()
    np.testing.assert_array_equal(got, a[:, shift:shift + PP.C - 16])


def _bytesel_is_where(x, variant):
    idx, val, acc = (x[k].numpy() for k in ("idx", "val", "acc"))
    got = PP.plain("bytesel", variant, x)
    assert got.dtype == torch.int32 and got.shape == (PP.R // 4, PP.C)
    np.testing.assert_array_equal(got.numpy(),
                                  _quads(np.where(idx == 1, val, acc)))


def test_bytesel_is_where(x):
    _bytesel_is_where(x, None)


def test_bytesel_vcmpeq4_is_where(x):
    _bytesel_is_where(x, "__vcmpeq4")


def test_rep8_is_a_x8_nearest_upsample(x):
    lo = x["lo"].numpy()
    got = PP.rep8_plain(x["lo"])
    assert got.dtype == torch.int32 and got.shape == (128, 256)
    np.testing.assert_array_equal(
        got.numpy(), np.repeat(np.repeat(lo.astype(np.int32), 8, 0), 8, 1))


def test_pack_probes_take_the_plain_version_on_the_cpu(x):
    before = (PP.counts.kernel, PP.counts.plain)
    outs = PP.run_all(x)
    assert len(outs) == len(PP.PROBES)
    assert (PP.counts.kernel, PP.counts.plain) == (before[0],
                                                   before[1] + len(outs))
    for i, out in enumerate(outs):
        assert (tuple(out.shape), out.dtype) == PP.SHAPES[i]


def test_probe_order_is_the_kernels():
    """PROBES lists the entries in the order of csrc/pack_probe.cu's Probe
    numbers (bit p of the mask is PROBES[p]), the JAX probe's five first."""
    src = (Path(PP.__file__).resolve().parents[1] / "csrc"
           / "pack_probe.cu").read_text()
    body = re.search(r"enum Probe \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*(k\w+)", body, re.M)
    assert names == ["kB32", "kColroll", "kRowroll", "kByteselTrick",
                     "kRep8", "kB32Words", "kVec16Aligned", "kVec16Perm",
                     "kVec16Funnel", "kByteselVcmp", "kProbes"]
    assert [p for p, _ in PP.JAX_PROBES] == ["b32", "colroll", "rowroll",
                                              "bytesel", "rep8"]
    assert len(PP.PROBES) == len(PP.SHAPES) == len(names) - 1


def test_run_many_refuses_a_repeated_or_unknown_probe(x):
    with pytest.raises(ValueError, match="distinct"):
        PP.run_many([("b32", None), ("b32", "row quads")], x)
    with pytest.raises(ValueError, match="no probe"):
        PP.run("vec16", "shift 7", x)


@pytest.mark.parametrize("case,width", zip(DP.CASES,
                                           [16, 16, None, None, 4, None,
                                            None, 16]))
def test_cp_async_alignment_rule(case, width):
    dtype, _, dx, _, cols = case
    item = torch.empty((), dtype=dtype).element_size()
    assert DP.cp_async_width(dx * item, cols * item, DP.W * item) == width


@pytest.mark.parametrize("case", DP.CASES)
def test_cp_async_bands_cover_every_row_once(case):
    """The cp.async mechanism spreads a window over blocks, a band of rows
    each: the bands cover every row of the window once, in order, each
    (but the last) a multiple of 4 rows, so that every band starts
    16-byte aligned in the output."""
    dtype, _, _, rows, cols = case
    row_bytes = cols * torch.empty((), dtype=dtype).element_size()
    bands = DP.bands(rows, row_bytes)
    covered = [r for r0, n in bands for r in range(r0, r0 + n)]
    assert covered == list(range(rows))
    n = DP.band_rows(row_bytes)
    assert n % 4 == 0
    assert all(r0 * row_bytes % 16 == 0 for r0, _ in bands)
    assert all(k == n for _, k in bands[:-1]) and 0 < bands[-1][1] <= n
    assert n * row_bytes <= max(DP.BAND_BYTES, 4 * row_bytes)
    assert len(bands) > 1


@pytest.mark.parametrize("case", DP.CASES)
def test_the_host_refuses_every_illegal_cp_async_width(case):
    """Every copy width that the window's start, its rows or the source's
    rows do not allow is refused on the host; the width taken is the
    widest one allowed."""
    dtype, _, dx, _, cols = case
    item = torch.empty((), dtype=dtype).element_size()
    starts = (dx * item, cols * item, DP.W * item)
    legal = [w for w in (16, 8, 4) if all(b % w == 0 for b in starts)]
    assert DP.cp_async_width(*starts) == (legal[0] if legal else None)
    src = DP.source(dtype)
    if not legal:
        with pytest.raises(DP.Rejected, match="no 4-, 8- or 16-byte"):
            DP.cp_async_window(src, *case[1:])


def test_dma_matrix_on_the_cpu():
    """On the CPU the plain version stands in for both mechanisms; the
    cp.async rule still rejects the cases it rejects on the card."""
    rows = DP.matrix("cpu")
    got = [(res["cp.async"].split()[0], res["TMA"]) for _, res in rows]
    assert got == [("OK", "OK"), ("OK", "OK"), ("REJECTED", "OK"),
                   ("REJECTED", "OK"), ("OK", "OK"), ("REJECTED", "OK"),
                   ("REJECTED", "OK"), ("OK", "OK")]
    assert DP.passed(rows)
    # the host's cp.async column agrees with the card's verdicts
    assert [v[0] for v in DP.verdicts(rows)] == [
        v[0] for v in DP.H100_VERDICTS]


def test_dma_window_is_the_probe_window():
    """The plain window holds what the JAX probe checks: its first two
    rows' first 8 samples and its last row's last 8."""
    for dtype, dy, dx, rows, cols in DP.CASES:
        src = DP.source(dtype)
        got = DP.window_plain(src, dy, dx, rows, cols)
        assert got.shape == (rows, cols) and got.dtype == dtype
        s = src.to(torch.int64).numpy()
        g = got.to(torch.int64).numpy()
        np.testing.assert_array_equal(g[:2, :8], s[dy:dy + 2, dx:dx + 8])
        np.testing.assert_array_equal(
            g[-1:, -8:], s[dy + rows - 1:dy + rows, dx + cols - 8:dx + cols])


def test_dma_passed_needs_the_control_and_no_wrong_case():
    ok = [(c, {"cp.async": "OK", "TMA": "OK"}) for c in DP.CASES]
    assert DP.passed(ok)
    assert not DP.passed([(DP.CASES[0], {"cp.async": "REJECTED x",
                                         "TMA": "OK"})] + ok[1:])
    assert not DP.passed(ok[:-1] + [(DP.CASES[-1], {"cp.async": "WRONG",
                                                    "TMA": "OK"})])


def test_unaligned_tma_boxes_run_in_children():
    assert [DP.in_child(m, c[0], c[2]) for c in DP.CASES
            for m in DP.MECHANISMS] == [
        False, False, False, False, False, True, False, True,
        False, True, False, True, False, True, False, True]


def test_a_child_that_dies_is_a_rejection():
    """A child whose context dies reports no result: the case reads as
    REJECTED by the card, with the child's last error line (here the
    child finds no card and exits)."""
    res = DP._finish_child(DP._start_child("TMA", 2))
    assert res.startswith("REJECTED by the card"), res
    assert "CUDA is not available" in res


def test_a_stall_sweep_child_carries_its_bound():
    """The sweep's children take the poll bound and whether the load
    starts; without a card each dies as any child does."""
    proc = DP._start_child("TMA", 0, 1 << 20, False)
    assert proc.args[-4:] == ["TMA", "0", str(1 << 20), "0"]
    res = DP._finish_child(proc)
    assert res.startswith("REJECTED by the card"), res


def test_the_stall_sweep_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        DP.main(["--stall-sweep"])


@pytest.mark.parametrize("tool", [PP, DP])
def test_probe_tools_need_a_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main([])


def test_probes_never_fall_back_off_the_cpu():
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in PP.make_inputs(1).items()}
    src = torch.empty((DP.H, DP.W), dtype=torch.uint8, device="meta")
    before = (PP.counts.kernel, PP.counts.plain, DP.counts.kernel,
              DP.counts.plain)
    with pytest.raises(ValueError, match="CUDA tensor"):
        PP.run("b32", None, meta)
    for fn in (DP.cp_async_window, DP.tma_window):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(src, 32, 128, 128, 256)
    assert before == (PP.counts.kernel, PP.counts.plain, DP.counts.kernel,
                      DP.counts.plain)
