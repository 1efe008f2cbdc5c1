"""P1: packed-byte primitives on the card (csrc/pack_probe.cu).

    python -m mpv_frame_interpolator_tpu_torch.tools.pack_probe

Counterpart of the TPU probe ``tools/pallas_pack_probe.py`` (its
``run_kernel``), which asks whether Mosaic packs four uint8 rows into an
int32 word and whether shifts and selects work in that packed domain.  On
the card a row-major uint8 plane read as uint32 packs four consecutive
columns, little-endian; these probes check that packing and the
operations a redesigned warp kernel would build on it, on a (128, 256)
uint8 plane made from a numpy seed:

  b32      the plane read as uint32 words;
  vec16    16-byte loads and stores of uint8 rows shifted by 16 columns
           (one aligned load) and by 5 (two aligned loads assembled with
           __byte_perm, or with __funnelshift_r);
  bytesel  the packed select where(idx == 1, val, acc) with __vcmpeq4,
           and with the TPU probe's carry-free zero-byte trick;
  rep8     a x8 nearest upsample of a (16, 32) tile through shared memory.

Each kernel's output is held bit-exact against its plain PyTorch version
(below), which computes the same packed arithmetic on any device; one
``OK`` / ``WRONG`` line per probe.  Exits non-zero without a card or if a
probe is wrong.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mpv_frame_interpolator_tpu_torch.ops.cuda import _build

R, C = 128, 256          # the probed plane
SHIFT = 5                # the unaligned column offset of vec16
LO = (16, 32)            # rep8's low-res tile
MASK32 = 0xFFFFFFFF

# (probe, variant): the C entry point's method number per variant
PROBES = (("b32", "", 0), ("vec16", "shift 16, one aligned load", 0),
          ("vec16", f"shift {SHIFT}, __byte_perm", 1),
          ("vec16", f"shift {SHIFT}, __funnelshift_r", 2),
          ("bytesel", "__vcmpeq4", 0), ("bytesel", "zero-byte trick", 1),
          ("rep8", "", 0))

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


def _words(plane):
    """uint8 (r, c) -> its little-endian uint32 words as int64 (r, c/4)."""
    return plane.contiguous().view(torch.int32).to(torch.int64) & MASK32


def _bytes(words):
    """int64 words in [0, 2^32) -> the uint8 plane they pack."""
    return words.to(torch.int32).view(torch.uint8)


def b32_plain(a):
    return a.contiguous().view(torch.int32)


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
    """where(idx == 1, val, acc), four bytes a word: 0x80 in each zero
    byte of idx ^ 0x01010101 without carries across bytes, widened to a
    byte mask."""
    seven = 0x7F7F7F7F
    x = _words(idx) ^ 0x01010101
    m = ~(((x & seven) + seven) | x | seven) & MASK32
    bm = (m >> 7) * 0xFF
    return _bytes((_words(acc) & ~bm & MASK32) | (_words(val) & bm))


def rep8_plain(lo):
    return lo.repeat_interleave(8, 0).repeat_interleave(8, 1)


def plain(probe: str, method: int, x: dict):
    """The plain version of one probe on the inputs' device."""
    if probe == "b32":
        return b32_plain(x["a"])
    if probe == "vec16":
        return vec16_plain(x["a"], 16 if method == 0 else SHIFT)
    if probe == "bytesel":
        return bytesel_plain(x["idx"], x["val"], x["acc"])
    return rep8_plain(x["lo"])


def _kernel(probe: str, method: int, x: dict):
    a = x["a"]
    for name, t in x.items():
        _build.require(t, name, torch.uint8, LO if name == "lo" else (R, C),
                       a.device)
    lib = _build.load()
    stream = _build.stream_of(a)
    if probe == "b32":
        out = torch.empty((R, C // 4), dtype=torch.int32, device=a.device)
        rc = lib.mfi_probe_b32(a.data_ptr(), out.data_ptr(), R * C // 4,
                               stream)
    elif probe == "vec16":
        out = torch.empty((R, C - 16), dtype=torch.uint8, device=a.device)
        rc = lib.mfi_probe_vec16(a.data_ptr(), out.data_ptr(), R, C,
                                 16 if method == 0 else SHIFT, method, stream)
    elif probe == "bytesel":
        out = torch.empty((R, C), dtype=torch.uint8, device=a.device)
        rc = lib.mfi_probe_bytesel(x["idx"].data_ptr(), x["val"].data_ptr(),
                                   x["acc"].data_ptr(), out.data_ptr(),
                                   R * C // 4, method, stream)
    else:
        out = torch.empty((LO[0] * 8, LO[1] * 8), dtype=torch.uint8,
                          device=a.device)
        rc = lib.mfi_probe_rep8(x["lo"].data_ptr(), out.data_ptr(), stream)
    _build.check(f"pack_probe {probe}", rc)
    counts.kernel += 1
    return out


def run(probe: str, method: int, x: dict):
    """One probe: the plain version for CPU tensors, the kernel for CUDA
    tensors (or raise)."""
    if x["a"].device.type == "cpu":
        counts.plain += 1
        return plain(probe, method, x)
    return _kernel(probe, method, x)


def run_all(x: dict) -> list:
    """Every probe on the inputs' device, in PROBES order."""
    return [run(p, m, x) for p, _, m in PROBES]


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("pack_probe: CUDA is not available")
    x = make_inputs(0, "cuda")
    wrong = 0
    for (probe, variant, method), got in zip(PROBES, run_all(x)):
        want = plain(probe, method, x)
        ok = got.dtype == want.dtype and torch.equal(got, want)
        wrong += not ok
        label = f"{probe} ({variant})" if variant else probe
        print(f"{label:40s} {'OK' if ok else 'WRONG'}", flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
