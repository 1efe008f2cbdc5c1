"""engine.body_ms_per_pair (ms): the host's time a pair inside the
engine's ``mfi.pair`` spans (the pair body: ``push``'s launch plan,
``PushPlan.run``, or ``_pair_outputs`` and the kernel wrappers), over the
traced stretch: the host path from the pair's first launch to its last."""

NAMES = ("mfi.pair",)


def read(run):
    return run.trace.span_ms_per_pair(NAMES) if run.trace else None
