"""warp.ms_per_pair (ms): device time of the cell's warp rows a pair in
the traced stretch: K2 (``ops/cuda/warp_pair.py``, every position of a
pair in one launch) or K4 (``ops/cuda/warp_fused.py``, one a position)."""

NAMES = ("pair_blend_kernel", "fused_blend_kernel")


def read(run):
    return run.trace.ms_per_pair(NAMES) if run.trace else None
