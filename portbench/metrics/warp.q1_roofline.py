"""warp.q1_roofline (%): Q1's share of its roofline: the least time of a
pair's bilinear warp at the cell's shapes (``work_bilinear.q1``: both
planes of every blended output, the sources and the 1/64-pel field read
once; the integer taps, the occlusion correction of hopperxq and the
level maps, the float32 blend left out), times the pairs of the traced
stretch, over the device time of Q1's rows there."""

from portbench import work, work_bilinear

NAMES = ("bilinear_blend_kernel",)


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    s = run.shapes
    least = work.least_s(work_bilinear.q1(
        s.height, s.width, s.stride, s.lh, s.lw, s.item, s.positions,
        s.levels, run.config["model"] == "hopperxq", s.scale_shift),
        run.peaks)
    return run.trace.roofline(NAMES, least)
