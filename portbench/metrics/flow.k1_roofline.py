"""flow.k1_roofline (%): K1's share of its roofline: the least time of one
flow pyramid and its blur at the cell's shapes (``work.k1``, integer
operations against the card's INT32 peak, bytes against its memory
peak), times the pairs of the traced stretch, over the device time of
K1's rows there."""

from portbench import work

NAMES = ("pyramid_kernel",)


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    s = run.shapes
    least = work.least_s(work.k1(s.height, s.stride, s.lh, s.lw, s.windows,
                                 s.radius, s.item, s.scale_shift),
                         run.peaks)
    return run.trace.roofline(NAMES, least)
