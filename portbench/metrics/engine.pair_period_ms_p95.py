"""engine.pair_period_ms_p95 (ms): the 95th percentile, over the pairs of
the traced stretch, of the device-clock time from one pair's flow kernel
(K1, one launch a pair) ending to the next one's: the pace at which
``push`` delivers pairs, stalls of the host included."""

import numpy as np

NAMES = ("pyramid_kernel",)


def read(run):
    if run.trace is None:
        return None
    ends = sorted(e for _, _, e in run.trace.matching(NAMES))
    if len(ends) < 20:
        return None
    return float(np.percentile(np.diff(ends), 95)) / 1e3
