"""prologue.ms_per_pair (ms): device time of C1, the pair's prologue
(``ops/cuda/prologue.py``), a pair, in the traced stretch."""

NAMES = ("pair_prologue_kernel",)


def read(run):
    return run.trace.ms_per_pair(NAMES) if run.trace else None
