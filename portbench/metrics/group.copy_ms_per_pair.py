"""group.copy_ms_per_pair (ms): device time of the copy and memset rows
of the traced stretch a pair: the grouped path's slot fills and copies
out (and the cut score's read-back)."""

NAMES = ("Memcpy", "Memset")


def read(run):
    return run.trace.ms_per_pair(NAMES) if run.trace else None
