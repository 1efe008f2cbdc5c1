"""The port's kernels against the NumPy oracle, on the card.

    python -m mpv_frame_interpolator_tpu_torch.tools.parity_report [--device cpu]

Counterpart of the JAX package's ``tools/parity_report.py``: runs the full
flow + warp matrix (``utils/parity.FULL_CASES`` in every mode of
``MODE_NAMES``, 28 rows) on the device, prints a table of bit-exactness
results and exits 1 on any mismatch.  The check itself lives in
``utils/parity.py``.  Without a card it raises, unless ``--device cpu``
asks for the plain versions.
"""

from __future__ import annotations

import argparse
import sys

import torch

from mpv_frame_interpolator_tpu_torch.utils.parity import (
    FULL_CASES, MODE_NAMES, run_parity)


def run(device: str = "cuda") -> int:
    name = (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "cpu")
    print(f"device: {device} ({name})")
    rows = run_parity(FULL_CASES, tuple(MODE_NAMES), device)
    width = max(len(r[0]) for r in rows) + 2
    fails = 0
    for row, ok in rows:
        print(f"{row:<{width}} {'BIT-EXACT' if ok else 'MISMATCH'}")
        fails += 0 if ok else 1
    print(f"\n{len(rows) - fails}/{len(rows)} bit-exact vs oracle")
    return 1 if fails else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
