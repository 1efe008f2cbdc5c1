"""engine.wait_ms_per_pair (ms): the host's time a pair inside the
engine's ``mfi.engine.wait`` spans that open within ``mfi.push``
(``_collect_timing``: the wait for the pair before to end on the card,
then its cut score's read-back), over the traced stretch: the part of
engine.host_ms_per_pair that the card, not the host's own code, sets."""

NAMES, WITHIN = ("mfi.engine.wait",), ("mfi.push",)


def read(run):
    return run.trace.span_ms_per_pair(NAMES, WITHIN) if run.trace else None
