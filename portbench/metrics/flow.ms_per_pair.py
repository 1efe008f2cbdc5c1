"""flow.ms_per_pair (ms): device time of K1, the flow pyramid with its
blur phase (``ops/flow.py``, ``ops/cuda/flow_step.py``), a pair, in the
traced stretch."""

NAMES = ("pyramid_kernel",)


def read(run):
    return run.trace.ms_per_pair(NAMES) if run.trace else None
