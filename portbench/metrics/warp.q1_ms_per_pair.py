"""warp.q1_ms_per_pair (ms): device time of Q1, the 1/64-pel bilinear
blend of the hopperq / hopperxq families (``ops/cuda/warp_bilinear.py``,
one launch a position), a pair, in the traced stretch."""

NAMES = ("bilinear_blend_kernel",)


def read(run):
    return run.trace.ms_per_pair(NAMES) if run.trace else None
