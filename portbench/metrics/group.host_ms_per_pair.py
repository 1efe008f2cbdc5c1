"""group.host_ms_per_pair (ms): the host's time inside the engine's
``push_many`` (slot fills, the graph's replay, the copies out) a pair,
from the benchmark's own spans around each call of the measured window
(their total over the pairs).  The same reading as
engine.host_ms_per_pair, kept apart because it moves out_fps."""


def read(run):
    return run.host_ms_per_pair()
