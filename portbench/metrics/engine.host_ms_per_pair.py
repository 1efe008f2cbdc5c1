"""engine.host_ms_per_pair (ms): the host's time inside the engine's
``push`` a pair, from the benchmark's own spans around each call of the
measured window (their total over the pairs).  The same reading as
group.host_ms_per_pair, kept apart because it moves pair_ms_p95."""


def read(run):
    return run.host_ms_per_pair()
