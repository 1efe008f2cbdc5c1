"""P1 against the JAX package's probe itself, and P1's kernel plan.

``tools/pallas_pack_probe.py`` is loaded by path and its ``main()`` run
once with ``pallas_call`` in interpret mode, recording each kernel's
``(name, args, output)`` through its ``run_kernel``; nothing of the JAX
package is edited.  Then:

* the port's ``run`` on CPU tensors of the same args gives each of the
  five JAX arrays (b32, colroll, rowroll, bytesel, rep8) with the same
  shape, dtype and values;
* a NumPy model of one thread of ``csrc/pack_probe.cu`` -- its aligned
  16-byte chunks, colroll's funnel-shifted window with its wrap at the
  row's first chunk, rowroll's source rows, both selects, and the 4 x 4
  byte transpose with the ``__byte_perm`` selectors read from the source
  -- run for every thread gives the same arrays over the whole plane, and
  colroll / rowroll at other shifts equal ``np.roll``.

Bit-exact (tolerance 0)."""

import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu_torch.tools import pack_probe as PP

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SOURCE = (REPO / "mpv_frame_interpolator_tpu_torch" / "csrc"
          / "pack_probe.cu").read_text()
U32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def jax_probe():
    """{name: (args as numpy, output)} of the JAX probe's five kernels, run
    in interpret mode."""
    from jax.experimental import pallas as pl
    spec = importlib.util.spec_from_file_location(
        "pallas_pack_probe", REPO / "tools" / "pallas_pack_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    record = {}
    run_kernel = mod.run_kernel

    def recording(name, kernel, out_shape, out_dtype, *args):
        out = run_kernel(name, kernel, out_shape, out_dtype, *args)
        record[name] = ([np.array(a) for a in args], out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(mod, "run_kernel", recording)
        assert mod.main() == 0
    assert sorted(record) == sorted(p for p, _ in PP.JAX_PROBES)
    assert all(out is not None for _, out in record.values())
    return record


def _inputs(name, args):
    """The port's inputs (and shifts) for the JAX kernel's args: its
    planes as `a` (or `idx`, `val`, `acc`; `lo` for rep8), rowroll's
    s_ref as the row shift."""
    x = {k: torch.zeros(PP.LO if k == "lo" else (PP.R, PP.C),
                        dtype=torch.uint8) for k in PP.INPUTS}
    if name == "bytesel":
        x.update(zip(("idx", "val", "acc"), map(torch.from_numpy, args)))
    else:
        x["lo" if name == "rep8" else "a"] = torch.from_numpy(args[0])
    shifts = {"row_shift": int(args[1][0, 0])} if name == "rowroll" else {}
    return x, shifts


@pytest.mark.parametrize("name", [p for p, _ in PP.JAX_PROBES])
def test_port_gives_the_jax_array(jax_probe, name):
    args, want = jax_probe[name]
    x, shifts = _inputs(name, args)
    got = PP.run(name, None, x, **shifts).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# --- csrc/pack_probe.cu's plan, one thread at a time, in NumPy ----------

def _selector(name):
    return int(re.search(rf"\b{name} = (0x[0-9A-Fa-f]+)", SOURCE).group(1),
               16)


def byte_perm(x, y, s):
    """__byte_perm: byte n of the result is byte (s >> 4n) & 7 of y:x."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(
            8 * n)
    return out.astype(np.uint32)


def funnelshift_r(lo, hi, sh):
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> np.uint64(sh & 31)) & np.uint64(U32)).astype(np.uint32)


def vcmpeq4(x, y):
    xb, yb = (np.asarray(v, np.uint32)[..., None] >> (8 * np.arange(4))
              & 0xFF for v in (x, y))
    return ((xb == yb) * (0xFF << (8 * np.arange(4)))).sum(
        -1).astype(np.uint32)


def transpose4(w0, w1, w2, w3):
    """The kernel's transpose4, with its selectors: byte k of o[i] is byte
    i of wk."""
    pair_lo, pair_hi = _selector("kPairLo"), _selector("kPairHi")
    half_lo, half_hi = _selector("kHalfLo"), _selector("kHalfHi")
    t0, t1 = byte_perm(w0, w1, pair_lo), byte_perm(w0, w1, pair_hi)
    t2, t3 = byte_perm(w2, w3, pair_lo), byte_perm(w2, w3, pair_hi)
    return [byte_perm(t0, t2, half_lo), byte_perm(t0, t2, half_hi),
            byte_perm(t1, t3, half_lo), byte_perm(t1, t3, half_hi)]


def load_words(plane, rows, cols):
    """The four little-endian words of the 16-byte chunks at (rows, cols):
    each chunk aligned and inside its row."""
    assert np.all(cols % 16 == 0) and np.all((cols >= 0) & (cols <= PP.C - 16))
    b = plane[rows[..., None], cols[..., None] + np.arange(16)]
    return [np.ascontiguousarray(b).view("<u4")[..., j] for j in range(4)]


def rolled_window(plane, rows, c0, s):
    hi = (c0 - 16 * (s >> 4) + PP.C) % PP.C
    o = s & 15
    h = load_words(plane, rows, hi)
    if o == 0:
        return h
    cat = load_words(plane, rows, (hi - 16 + PP.C) % PP.C) + h
    b = 16 - o
    return [funnelshift_r(cat[(b >> 2) + k], cat[(b >> 2) + k + 1],
                          8 * (b & 3)) for k in range(4)]


def select_word(ip, vp, ap, vcmp):
    if vcmp:
        bm = vcmpeq4(ip, np.uint32(0x01010101))
    else:
        x = ip ^ np.uint32(0x01010101)
        seven = np.uint32(0x7F7F7F7F)
        m = ~(((x & seven) + seven) | x | seven)
        bm = (m >> np.uint32(7)) * np.uint32(0xFF)
    return (ap & ~bm) | (vp & bm)


def row_quads_model(probe, x, col_shift=PP.COL_SHIFT, row_shift=PP.ROW_SHIFT,
                    vcmp=False):
    """Every thread of a row-quad probe: thread (r, c0) writes words c0..c0
    + 15 of output row r from source rows 4r..4r+3 (rowroll: shifted)."""
    r = np.arange(PP.R // 4)[:, None]
    c0 = np.broadcast_to(np.arange(PP.C // 16)[None] * 16, (PP.R // 4,
                                                           PP.C // 16))
    w = []
    for k in range(4):
        rows = np.broadcast_to(
            (4 * r + k + (row_shift if probe == "rowroll" else 0)) % PP.R,
            c0.shape)
        if probe == "colroll":
            w.append(rolled_window(x["a"], rows, c0, col_shift))
        elif probe == "bytesel":
            ip, vp, ap = (load_words(x[n], rows, c0)
                          for n in ("idx", "val", "acc"))
            w.append([select_word(ip[j], vp[j], ap[j], vcmp)
                      for j in range(4)])
        else:
            w.append(load_words(x["a"], rows, c0))
    out = np.stack([np.stack(transpose4(*(w[k][j] for k in range(4))), -1)
                    for j in range(4)], -2)        # (R/4, C/16, j, i)
    return out.reshape(PP.R // 4, PP.C).view(np.int32)


def rep8_model(lo):
    """Thread i writes one uint4 of the int32 output: four columns of the
    low-res sample lo[y >> 3, x4 >> 1]."""
    i = np.arange(PP.LO[0] * 8 * PP.LO[1] * 2)
    y, x4 = i // (PP.LO[1] * 2), i % (PP.LO[1] * 2)
    v = lo[y >> 3, x4 >> 1].astype(np.int32)
    return np.repeat(v, 4).reshape(PP.LO[0] * 8, PP.LO[1] * 8)


def _numpy_inputs(name, args):
    x, shifts = _inputs(name, args)
    return {k: v.numpy() for k, v in x.items()}, shifts


@pytest.mark.parametrize("name,vcmp", [("b32", False), ("colroll", False),
                                       ("rowroll", False), ("bytesel", False),
                                       ("bytesel", True), ("rep8", False)])
def test_kernel_plan_gives_the_jax_array(jax_probe, name, vcmp):
    args, want = jax_probe[name]
    x, shifts = _numpy_inputs(name, args)
    got = (rep8_model(x["lo"]) if name == "rep8"
           else row_quads_model(name, x, vcmp=vcmp, **shifts))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _quads_np(a8):
    return (a8[0::4].astype(np.uint32) | (a8[1::4].astype(np.uint32) << 8)
            | (a8[2::4].astype(np.uint32) << 16)
            | (a8[3::4].astype(np.uint32) << 24)).astype(np.int32)


@pytest.mark.parametrize("shift", [0, 1, 4, 5, 15, 16, 17, 100, PP.C - 1])
def test_kernel_plan_colroll_is_np_roll(shift):
    x = {k: v.numpy() for k, v in PP.make_inputs(3).items()}
    np.testing.assert_array_equal(
        row_quads_model("colroll", x, col_shift=shift),
        _quads_np(np.roll(x["a"], shift, axis=1)))


@pytest.mark.parametrize("shift", [0, 1, 4, 5, 7, 15, 16, PP.R - 1])
def test_kernel_plan_rowroll_is_np_roll(shift):
    x = {k: v.numpy() for k, v in PP.make_inputs(3).items()}
    np.testing.assert_array_equal(
        row_quads_model("rowroll", x, row_shift=shift),
        _quads_np(np.roll(x["a"], -shift, axis=0)))


def test_the_transpose_selectors_are_a_byte_transpose():
    """byte k of output word i is byte i of input word k, for words whose
    bytes are all distinct."""
    w = [np.array([0x03020100 + 0x04040404 * (4 * k)], np.uint32)
         for k in range(4)]
    o = transpose4(*w)
    for i in range(4):
        for k in range(4):
            assert (int(o[i][0]) >> (8 * k)) & 0xFF == 16 * k + i
