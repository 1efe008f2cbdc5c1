"""P1: packed-byte primitives on the card (csrc/pack_probe.cu).

    python -m mpv_frame_interpolator_tpu_torch.tools.pack_probe

Counterpart of the TPU probe ``tools/pallas_pack_probe.py`` (its
``run_kernel`` and five kernels), which asks whether Mosaic packs four
uint8 rows into an int32 word and whether shifts and selects work in that
packed domain.  On a (128, 256) uint8 plane made from a numpy seed, the
first five entries of PROBES return the JAX kernels' arrays exactly,
int32 of shape (R / 4, C) with word (r, c) holding rows 4r..4r+3 of
column c, little-endian (rep8: (128, 256)):

  b32      the row-quad packing of the plane;
  colroll  np.roll(a, s, axis=1) packed, the column shift s at run time;
  rowroll  np.roll(a, -s, axis=0) packed, the row shift s at run time
           (the JAX probe's s_ref);
  bytesel  where(idx == 1, val, acc) packed, selected with the TPU probe's
           carry-free zero-byte trick;
  rep8     a x8 nearest upsample of a (16, 32) tile, int32.

The rest probe the card's own packing (a row-major uint8 plane read as
uint32 packs four consecutive columns, little-endian): the plane's words,
vec16 (16-byte loads and stores of rows shifted by 16 columns, one aligned
load, and by 5, two aligned loads assembled with __byte_perm or with
__funnelshift_r) and bytesel with __vcmpeq4.

On the card every requested probe runs in one launch of one kernel
(``run_many``; ``run_all`` is one launch).  Each kernel output is held
bit-exact against its plain PyTorch version (below), one ``OK`` / ``WRONG``
line per probe.  Exits non-zero without a card or if a probe is wrong.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from mpv_frame_interpolator_tpu_torch.ops.cuda import _build

R, C = 128, 256          # the probed plane
LO = (16, 32)            # rep8's low-res tile
COL_SHIFT = 5            # the JAX probe's column roll
ROW_SHIFT = 7            # the JAX probe's row roll (its s_ref)
VEC_SHIFT = 5            # vec16's unaligned column offset
MASK32 = 0xFFFFFFFF
INPUTS = ("a", "idx", "val", "acc", "lo")

# (probe, variant), in the order of csrc/pack_probe.cu's Probe numbers; the
# first five are the JAX probe's arrays
PROBES = (("b32", "row quads"), ("colroll", "row quads"),
          ("rowroll", "row quads"), ("bytesel", "zero-byte trick"),
          ("rep8", "int32"), ("b32", "column words"),
          ("vec16", "shift 16, one aligned load"),
          ("vec16", f"shift {VEC_SHIFT}, __byte_perm"),
          ("vec16", f"shift {VEC_SHIFT}, __funnelshift_r"),
          ("bytesel", "__vcmpeq4"))
JAX_PROBES = PROBES[:5]

_QUADS = ((R // 4, C), torch.int32)
# each entry's output (shape, dtype)
SHAPES = (_QUADS, _QUADS, _QUADS, _QUADS,
          ((LO[0] * 8, LO[1] * 8), torch.int32), ((R, C // 4), torch.int32),
          *([((R, C - 16), torch.uint8)] * 3), _QUADS)

counts = _build.LaunchCounts()


def make_inputs(seed: int = 0, device="cpu") -> dict:
    """The probed planes: `a` (R, C), `idx` in [0, 3), `val`, `acc` (R, C)
    and the tile `lo` (16, 32) in [0, 96), uint8."""
    rng = np.random.default_rng(seed)
    arrays = {"a": rng.integers(0, 256, (R, C)),
              "idx": rng.integers(0, 3, (R, C)),
              "val": rng.integers(0, 256, (R, C)),
              "acc": rng.integers(0, 256, (R, C)),
              "lo": rng.integers(0, 96, LO)}
    return {k: torch.from_numpy(v.astype(np.uint8)).to(device)
            for k, v in arrays.items()}


def index(probe: str, variant: str | None = None) -> int:
    """The entry of PROBES; variant None names the JAX probe's array."""
    for i, (p, v) in enumerate(PROBES):
        if p == probe and variant in (None, v):
            return i
    raise ValueError(f"pack_probe: no probe {probe!r} ({variant!r})")


def quads(plane):
    """uint8 (r, c) -> int32 (r / 4, c): word (i, j) holds rows 4i..4i+3 of
    column j, little-endian (the TPU's packing of a uint8 tile)."""
    r, c = plane.shape
    return plane.reshape(r // 4, 4, c).transpose(1, 2).contiguous().view(
        torch.int32).reshape(r // 4, c)


def _words(plane):
    """uint8 (r, c) -> its little-endian uint32 words as int64 (r, c/4)."""
    return plane.contiguous().view(torch.int32).to(torch.int64) & MASK32


def _bytes(words):
    """int64 words in [0, 2^32) -> the uint8 plane they pack."""
    return words.to(torch.int32).view(torch.uint8)


def colroll_plain(a, shift: int = COL_SHIFT):
    """The JAX kernel's lane roll of the packed words: column c of the
    result is column (c - shift) mod C of a."""
    return torch.roll(quads(a), shift, 1)


def rowroll_plain(a, shift: int = ROW_SHIFT):
    """The JAX kernel's row shift of the packed words: a roll of whole
    words by shift // 4 (rows move up) and a byte rotate by shift % 4 that
    takes the top bytes from the next word."""
    p = quads(a).to(torch.int64) & MASK32
    w, b = divmod(shift % a.shape[0], 4)
    lo = torch.roll(p, -w, 0) >> (8 * b)
    hi = (torch.roll(p, -(w + 1), 0) << (32 - 8 * b)) & MASK32 if b else 0
    return (lo | hi).to(torch.int32)


def vec16_plain(a, shift: int):
    """out[r, c] = a[r, c + shift] for c < C - 16, as 4-byte words: word k
    of the output is the funnel shift of source words k + shift // 4 and
    the next one by 8 * (shift % 4) bits."""
    w = _words(a)
    n = (a.shape[1] - 16) // 4
    lo_idx = torch.arange(n, device=a.device) + shift // 4
    hi_idx = (lo_idx + 1).clamp(max=w.shape[1] - 1)
    pair = w[:, lo_idx] | (w[:, hi_idx] << 32)
    return _bytes((pair >> (8 * (shift % 4))) & MASK32)


def bytesel_plain(idx, val, acc):
    """where(idx == 1, val, acc) in the row-quad packing, four bytes a
    word: 0x80 in each zero byte of idx ^ 0x01010101 without carries
    across bytes, widened to a byte mask (the JAX kernel's select)."""
    seven = 0x7F7F7F7F
    ip, vp, ap = (quads(t).to(torch.int64) & MASK32 for t in (idx, val, acc))
    x = ip ^ 0x01010101
    m = ~(((x & seven) + seven) | x | seven) & MASK32
    bm = (m >> 7) * 0xFF
    return ((ap & ~bm & MASK32) | (vp & bm)).to(torch.int32)


def rep8_plain(lo):
    return lo.to(torch.int32).repeat_interleave(8, 0).repeat_interleave(8, 1)


def plain_at(i: int, x: dict, col_shift: int = COL_SHIFT,
             row_shift: int = ROW_SHIFT):
    """The plain version of PROBES[i] on the inputs' device."""
    a = x["a"]
    return (lambda: quads(a),
            lambda: colroll_plain(a, col_shift),
            lambda: rowroll_plain(a, row_shift),
            lambda: bytesel_plain(x["idx"], x["val"], x["acc"]),
            lambda: rep8_plain(x["lo"]),
            lambda: a.contiguous().view(torch.int32),
            lambda: vec16_plain(a, 16),
            lambda: vec16_plain(a, VEC_SHIFT),
            lambda: vec16_plain(a, VEC_SHIFT),
            lambda: quads(torch.where(x["idx"] == 1, x["val"], x["acc"])),
            )[i]()


def plain(probe: str, variant: str | None, x: dict, col_shift: int = COL_SHIFT,
          row_shift: int = ROW_SHIFT):
    return plain_at(index(probe, variant), x, col_shift, row_shift)


def _kernel(ids, x: dict, col_shift: int, row_shift: int) -> list:
    a = x["a"]
    for name in INPUTS:
        _build.require(x[name], name, torch.uint8,
                       LO if name == "lo" else (R, C), a.device)
    lib = _build.load()
    outs = {i: torch.empty(SHAPES[i][0], dtype=SHAPES[i][1], device=a.device)
            for i in ids}
    table = (ctypes.c_void_p * len(PROBES))(
        *(outs[i].data_ptr() if i in outs else None
          for i in range(len(PROBES))))
    rc = lib.mfi_probe_run(*(x[k].data_ptr() for k in INPUTS), table,
                           sum(1 << i for i in ids), col_shift, row_shift,
                           _build.stream_of(a))
    _build.check("pack_probe", rc)
    counts.kernel += 1
    return [outs[i] for i in ids]


def run_many(keys, x: dict, col_shift: int = COL_SHIFT,
             row_shift: int = ROW_SHIFT) -> list:
    """The (probe, variant) entries of keys, in that order: the plain
    versions for CPU tensors, else one launch for all of them (or raise).
    A shift is taken modulo its axis, as np.roll takes it."""
    ids = [index(*k) for k in keys]
    if not ids or len(set(ids)) != len(ids):
        raise ValueError(f"pack_probe: want distinct probes, got {keys}")
    col_shift, row_shift = col_shift % C, row_shift % R
    if x["a"].device.type == "cpu":
        counts.plain += len(ids)
        return [plain_at(i, x, col_shift, row_shift) for i in ids]
    return _kernel(ids, x, col_shift, row_shift)


def run(probe: str, variant: str | None, x: dict, col_shift: int = COL_SHIFT,
        row_shift: int = ROW_SHIFT):
    """One probe (variant None: the JAX probe's array), through the same
    kernel with a mask of one probe on the card."""
    return run_many([(probe, variant)], x, col_shift, row_shift)[0]


def run_all(x: dict, col_shift: int = COL_SHIFT,
            row_shift: int = ROW_SHIFT) -> list:
    """Every probe on the inputs' device, in PROBES order: one launch on
    the card."""
    return run_many(PROBES, x, col_shift, row_shift)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("pack_probe: CUDA is not available")
    x = make_inputs(0, "cuda")
    wrong = 0
    for i, got in enumerate(run_all(x)):
        want = plain_at(i, x)
        ok = got.dtype == want.dtype and torch.equal(got, want)
        wrong += not ok
        probe, variant = PROBES[i]
        print(f"{probe + ' (' + variant + ')':40s} {'OK' if ok else 'WRONG'}",
              flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
