"""The plain reference (``portbench/reference``) against the port's engine
run on the CPU at a small size: a pair inside a shot and a pair across
a change of shot, in 8-bit NV12 and in P010 at TV levels 16/235; and the
reference cadence against the port's.  Only this test imports the port;
the reference never does."""

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu_torch.convert import DeviceFrame
from mpv_frame_interpolator_tpu_torch.frame import FrameFormat
from mpv_frame_interpolator_tpu_torch.pipeline.cadence import CadenceEngine
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from portbench import content
from portbench.reference import cadence, pair as ref

W, H, SHOT = 96, 64, 4
RING = content.RingParams(frames_per_shot=SHOT, max_pan_px=6, boxes=2,
                          box_min_px=8, box_max_px=24, box_max_speed_px=4,
                          base_cell_px=32, detail_cell_px=4)


def _engine(pixfmt, levels, sampling):
    return InterpolationEngine(EngineConfig(
        display_fps=120.0, auto_quality=False, initial_search_radius=16,
        black_level=levels[0], white_level=levels[1],
        warp_sampling=sampling, device="cpu"))


@pytest.mark.parametrize("pixfmt,levels,sampling", [
    ("nv12", (0, 255), "pair"), ("p010", (16, 235), "fused")])
def test_reference_equals_the_engine(pixfmt, levels, sampling):
    ring = content.make_ring(W, H, pixfmt, RING, 12345, "cpu")
    fmt = FrameFormat(W, H, pixfmt)
    engine = _engine(pixfmt, levels, sampling)
    shift = 0 if pixfmt == "nv12" else 8
    geom = ref.geometry(H, W, W, 270)
    plan = cadence.plan(2 * SHOT + 1, 24.0, 120.0)
    cuts = 0
    for i in range(2 * SHOT + 1):
        y, uv = ring[i % len(ring)]
        frame = DeviceFrame(y, uv, uv[:, 0::2].contiguous(),
                            uv[:, 1::2].contiguous(), fmt, pts=i / 24.0,
                            nominal_fps=24.0)
        outs = engine.push(frame)
        if plan[i] is None:
            continue
        f1, f2 = ring[(i - 1) % len(ring)], ring[i % len(ring)]
        pr = ref.pair(f1, f2, geom, [b for _, b in plan[i]], 16, 8, 6, shift,
                      True, 28.0)
        cuts += pr.cut
        assert [o.pts for o in outs] == [p for p, _ in plan[i]]
        for k, o in enumerate(outs):
            want = ref.output(f1, f2, pr, k, geom, shift, levels)
            for got, w in zip(o.device_planes(), want):
                assert torch.equal(got.to(torch.int64), w), (i, k)
    # the change of shot at frame SHOT is a cut, the pairs inside a shot
    # are not
    assert cuts == 2 and engine.scene_cuts() == 2


def test_reference_cadence_equals_the_engine_cadence():
    for display in (120.0, 60.0, 50.0):
        c = CadenceEngine(display)
        want = cadence.plan(3000, 24.0, display)
        for i in range(3000):
            p = c.on_source_frame(i / 24.0, 24.0)
            got = None if p.passthrough else [(s.pts, s.blend)
                                              for s in p.outputs]
            assert got == want[i], (display, i)


def test_flow_and_cut_follow_the_content():
    """A pair inside a shot is no cut; a change of shot is, with a zero
    field and the positions snapped to the nearer source."""
    ring = content.make_ring(W, H, "nv12", RING, 7, "cpu")
    geom = ref.geometry(H, W, W, 270)
    ts = [0.0, 0.2, 0.4, 0.6000000000000001, 0.8]
    inside = ref.pair(ring[0], ring[1], geom, ts, 16, 8, 6, 0, True, 28.0)
    across = ref.pair(ring[SHOT - 1], ring[SHOT], geom, ts, 16, 8, 6, 0, True,
                      28.0)
    assert not inside.cut and across.cut
    assert int(across.blurred.abs().sum()) == 0
    assert list(across.ts) == [0, 0, 0, 1, 1]
    assert np.array_equal(inside.ts, np.asarray(ts, np.float32))
