"""warp.k2_roofline (%): K2's share of its roofline: the least time of a
pair's warp layer at the cell's shapes (``work.warp``: both planes of
every blended output, the sources read once), times the pairs of the
traced stretch, over the device time of K2's rows there."""

from portbench import work

NAMES = ("pair_blend_kernel",)


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    s = run.shapes
    least = work.least_s(work.warp(s.height, s.width, s.stride, s.lh, s.lw,
                                   s.item, s.positions, s.levels), run.peaks)
    return run.trace.roofline(NAMES, least)
