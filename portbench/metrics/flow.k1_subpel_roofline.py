"""flow.k1_subpel_roofline (%): the share of its roofline of K1's launch
under ``subpel_flow``: the least time of one flow pyramid, S1's probes
and fit and the blur of the 1/64-pel field at the cell's shapes
(``work_bilinear.k1_subpel``: ``work.k1`` and ``work_bilinear.s1``'s
operations, K1's bytes), times the pairs of the traced stretch, over the
device time of K1's rows there."""

from portbench import work, work_bilinear

NAMES = ("pyramid_kernel",)


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    s = run.shapes
    least = work.least_s(work_bilinear.k1_subpel(
        s.height, s.stride, s.lh, s.lw, s.windows, s.radius, s.item,
        s.scale_shift), run.peaks)
    return run.trace.roofline(NAMES, least)
