"""group.wait_ms_per_pair (ms): the host's time a pair inside the
engine's ``mfi.engine.wait`` spans that open within ``mfi.push_many``
(``_collect_timing``: the wait for the group before to end on the card,
then its cut scores' read-back), over the traced stretch."""

NAMES, WITHIN = ("mfi.engine.wait",), ("mfi.push_many",)


def read(run):
    return run.trace.span_ms_per_pair(NAMES, WITHIN) if run.trace else None
