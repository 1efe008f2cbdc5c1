"""device.idle_share.group (%): the share of the traced stretch in which
no kernel, memset or copy ran on the card, in the cells that drive
``push_many``.  The same reading as device.idle_share.push: a per-layer
metric moves one end-to-end metric, and the two kinds of cell report
different ones (out_fps, pair_ms_p95)."""


def read(run):
    return run.trace.idle_percent() if run.trace else None
