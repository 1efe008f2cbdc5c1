"""group.fill_ms_per_pair (ms): the host's time a pair inside the
engine's ``mfi.group.fill`` spans (``_GroupSlots.fill``: a group's
copies into the graph's slots, enqueued), over the traced stretch."""

NAMES = ("mfi.group.fill",)


def read(run):
    return run.trace.span_ms_per_pair(NAMES) if run.trace else None
