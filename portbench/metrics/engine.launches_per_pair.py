"""engine.launches_per_pair (launches): kernel launches a pair over the
measured window, from the port's own launch counters (the kernel
wrappers' ``counts``, which a graph's replay adds its captured launches
to); an exact count.  None where nothing launched (the CPU)."""


def read(run):
    if not run.pairs or not run.launches:
        return None
    return run.launches / run.pairs
