"""pair_ms_p95 (ms): the 95th percentile, over every call of the measured
window, of the time from the benchmark's call of the engine to the
completion of that call's last output.  On a card both ends are CUDA
events on the device clock (``driver.Driver``): the first recorded on an
idle stream of the benchmark's own as the call begins, the second on the
engine's stream after the call's last output; on the CPU, where a call
returns its outputs computed, the call's span on the host clock."""

import numpy as np


def read(run):
    lat = run.latencies_ms
    if not lat:
        return None
    return float(np.percentile(lat, 95))
