"""The bilinear families' plain reference (``reference/bilinear.py``), the
hopperxq + sub-pel configuration and its cell, the work counts of
``work_bilinear.py`` and the cell's readers, on the CPU.

* the port's engine on the CPU at 96x64 equals the reference on the seeded
  ring -- a pair inside a shot and a pair across a change of shot -- for
  hopperxq and hopperq, with and without the sub-pel flow, NV12 and P010
  at TV levels 16/235, through ``push`` and ``push_many``;
* the configuration resolves to this reference, which stops set-up for a
  model or mode it does not judge; a whole run of the cell at a small
  size is correct, an altered output is not, and the control (the blend
  in bfloat16) is not;
* the reference imports nothing of the program;
* ``work_bilinear``'s counts against hand counts at a tiny shape, and the
  readers of the cell on a made-up trace.
Only this test and the run it drives import the port; the reference
never does."""

import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import calls_for
from portbench import content, control, run, spec, work, work_bilinear
from portbench.reference import bilinear, cadence, models
from portbench.reference import pair as ref

W, H, SHOT = 96, 64, 4
RING = content.RingParams(frames_per_shot=SHOT, max_pan_px=6, boxes=2,
                          box_min_px=8, box_max_px=24, box_max_speed_px=4,
                          base_cell_px=32, detail_cell_px=4)
CELL = "uhd10xq.group8"
CONFIG = "uhd-p010-tv-hopperxq-subpel-24to120"


def _engine(model, subpel, levels):
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    return InterpolationEngine(EngineConfig(
        display_fps=120.0, auto_quality=False, initial_search_radius=16,
        black_level=levels[0], white_level=levels[1], model=model,
        subpel_flow=subpel, device="cpu"))


def _frames(ring, fmt, n):
    from mpv_frame_interpolator_tpu_torch.convert import DeviceFrame
    return [DeviceFrame(y, uv, uv[:, 0::2].contiguous(),
                        uv[:, 1::2].contiguous(), fmt, pts=i / 24.0,
                        nominal_fps=24.0)
            for i in range(n) for y, uv in [ring[i % len(ring)]]]


@pytest.mark.parametrize("model,subpel", [
    ("hopperxq", True), ("hopperq", True), ("hopperxq", False)])
@pytest.mark.parametrize("pixfmt,levels", [("p010", (16, 235)),
                                           ("nv12", (0, 255))])
@pytest.mark.parametrize("api", ["push", "push_many"])
def test_reference_equals_the_engine(model, subpel, pixfmt, levels, api):
    from mpv_frame_interpolator_tpu_torch.frame import FrameFormat
    ring = content.make_ring(W, H, pixfmt, RING, 12345, "cpu")
    engine = _engine(model, subpel, levels)
    shift = 0 if pixfmt == "nv12" else 8
    geom = ref.geometry(H, W, W, 270)
    n = 2 * SHOT + 1
    plan = cadence.plan(n, 24.0, 120.0)
    frames = _frames(ring, FrameFormat(W, H, pixfmt), n)
    if api == "push":
        outs = [o for f in frames for o in engine.push(f)]
    else:
        outs = engine.push(frames[0]) + engine.push_many(frames[1:],
                                                         group_size=4)
    got = {o.pts: o for o in outs}
    cfg = {"model": model, "subpel_flow": subpel,
           "initial_search_radius": 16, "delta_scalar": 8,
           "neighbor_bias_scalar": 6}
    cuts = fractions = 0
    for i in range(1, n):
        f1, f2 = ring[(i - 1) % len(ring)], ring[i % len(ring)]
        folded = ref.prologue(f1, f2, geom, [b for _, b in plan[i]], shift,
                              True, 28.0)
        cuts += folded.cut
        _, frac = bilinear.fields(f1, f2, folded, geom, cfg, shift)
        fractions += int((frac != 0).sum())
        made = bilinear.outputs(f1, f2, geom, folded, cfg, shift, levels)
        for (pts, _), want in zip(plan[i], made):
            for g, w in zip(got[pts].device_planes(), want):
                assert torch.equal(g.to(torch.int64), w), (i, pts)
    # the change of shot at frame SHOT is a cut and the ring wraps into
    # another; the pairs inside a shot are not, and the sub-pel flow
    # moves their fields by fractions of a pel
    assert cuts == 2 and engine.scene_cuts() == 2
    assert (fractions > 0) is subpel


def test_the_lower_blend_differs():
    ring = content.make_ring(W, H, "p010", RING, 777, "cpu")
    geom = ref.geometry(H, W, W, 270)
    cfg = {"model": "hopperxq", "subpel_flow": True,
           "initial_search_radius": 16, "delta_scalar": 8,
           "neighbor_bias_scalar": 6}
    ts = [0.0, 0.2, 0.4, 0.6000000000000001, 0.8]
    folded = ref.prologue(ring[1], ring[2], geom, ts, 8, True, 28.0)
    assert not folded.cut
    exact = list(bilinear.outputs(ring[1], ring[2], geom, folded, cfg, 8,
                                  (16, 235)))
    lower = list(bilinear.outputs_lower(ring[1], ring[2], geom, folded, cfg,
                                        8, (16, 235)))
    differing = sum(int((a != b).sum()) for ea, la in zip(exact, lower)
                    for a, b in zip(ea, la))
    assert differing > W * H


def test_the_configuration_chooses_this_reference():
    cfg = spec.config(CONFIG)
    built, settings = run.engine_config(cfg, "cpu")
    assert built.model == "hopperxq" and built.subpel_flow is True
    assert (built.black_level, built.white_level) == (16.0, 235.0)
    r = models.for_config(settings)
    assert r.name == "bilinear"
    assert r.outputs.__module__ == r.lower.__module__
    assert cfg["reduced"] == []
    bench = spec.benchmark()
    assert spec.workload(bench, CELL)["config"] == CONFIG
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["file"] == f"portbench/configs/{CONFIG}.json"


@pytest.mark.parametrize("extra,named", [
    ({"model": "hopperx"}, "model='hopperx'"),
    ({"model": "hopper"}, "model='hopper'"),
    ({"frame_output_mode": 3}, "frame_output_mode=3"),
    ({"cut_policy": "hold"}, "cut_policy='hold'")])
def test_set_up_stops_for_what_it_does_not_judge(extra, named, small,
                                                 monkeypatch):
    def no_ring(*a, **kw):
        raise AssertionError("the ring was made")
    monkeypatch.setattr(content, "make_ring", no_ring)
    o = {**small, "config": {**small["config"], **extra}}
    with pytest.raises(spec.SetupError, match=re.escape(named)):
        run.run_cell(CELL, 4242, 0, False, time.perf_counter(), device="cpu",
                     overrides=o, max_calls=calls_for(CELL))


def _run(small, hook=None):
    return run.run_cell(CELL, 31337, 0, False, time.perf_counter(),
                        device="cpu", overrides=small,
                        max_calls=calls_for(CELL), engine_hook=hook)


def test_a_sound_run_of_the_cell_is_correct(small):
    r = _run(small)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["samples_differing"]["value"] == 0
    assert r["checks"]["cut_pairs_compared"]["value"] >= 1
    assert set(r["metrics"]) == {"out_fps", "setup_s"}


def test_an_altered_output_is_not_correct(small):
    def altered(engine):
        body = engine._pair_outputs

        def pair_outputs(*a, **kw):
            y, uv, score = body(*a, **kw)
            y = list(y)
            y[0] = y[0].clone()
            y[0].view(-1)[5] ^= 1
            return y, uv, score
        engine._pair_outputs = pair_outputs
        return engine
    r = _run(small, altered)
    assert r["correct"] is False
    assert not r["checks"]["samples_differing"]["ok"]


def test_the_control_is_not_correct(small):
    for seed in (5, 6):
        r = control.readings(CELL, seed, "cpu", small)
        assert r["pairs"] >= 3 and r["cut_pairs"] >= 1
        assert r["samples_differing"] > 0, r


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "from portbench.reference import bilinear, models\n"
            "from portbench import work_bilinear\n"
            "models.load('bilinear')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mpv_frame_interpolator_tpu_torch', "
            "'mpv_frame_interpolator_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- the work counts ---------------------------------------------------------

def test_s1_by_hand():
    """A 2 x 3 low-res field over an 8 x 12 P010 frame (uint16): nine
    probes of (8 + 1 + 15) operations, the fit's 43 and the field's 4 a
    pixel; the offset and the field, f1's samples (bounded by the frame),
    the probe."""
    s = work_bilinear.s1(2, 3, 8, 12, 2, 8)
    assert s.ops == 6 * (9 * (8 + 1 + 15) + 43 + 4)
    # f1 luma: min(96, 54); chroma min(48, 108)
    assert s.nbytes == 6 * 8 + (54 + 48) * 2 + 3 * 6 * 2 + 6 * 8
    nv12 = work_bilinear.s1(2, 3, 8, 12, 1, 0)
    assert nv12.ops == 6 * (9 * (8 + 15) + 43 + 4)


def test_k1_subpel_adds_s1s_operations_to_k1():
    geom = ref.geometry(2160, 3840, 3840, 270)
    args = (2160, 3840, geom.lh, geom.lw, geom.windows, 16, 2, 8)
    k1, both = work.k1(*args), work_bilinear.k1_subpel(*args)
    s1 = work_bilinear.s1(geom.lh, geom.lw, 2160, 3840, 2, 8)
    assert both.ops == k1.ops + s1.ops and both.nbytes == k1.nbytes


def test_q1_by_hand():
    """A 4 x 8 P010 frame, 2 positions, one 1 x 2 field: 2 x 48 output
    samples of 2 x 9 tap operations, 12 + 1 of the correction and 5 of
    the levels at 16/235."""
    q = work_bilinear.q1(4, 8, 8, 1, 2, 2, 2, (16, 235), True, 8)
    assert q.ops == 2 * (32 + 16) * (18 + 13 + 5)
    assert q.nbytes == 2 * (32 + 16) * 2 + 2 * 2 * 4 + 2 * 4 + 2 * 48 * 2
    plain = work_bilinear.q1(4, 8, 8, 1, 2, 1, 2, (0, 255), False, 0)
    assert plain.ops == 2 * 48 * (18 + 1)


def test_q1_at_4k_is_under_its_measured_time():
    """The least time of a 4K P010 pair at five positions stays under what
    Q1 has been measured to take there (~0.06 ms a position)."""
    geom = ref.geometry(2160, 3840, 3840, 270)
    peaks = work.Peaks(16.727e12, 3.35e12)
    q = work_bilinear.q1(2160, 3840, 3840, geom.lh, geom.lw, 2, 5,
                         (16, 235), True, 8)
    assert 0.05e-3 < work.least_s(q, peaks) < 0.3e-3
    assert work.bound_by(q, peaks) == "operations"


# -- the readers --------------------------------------------------------------

class _View:
    def __init__(self, trace_view, launches=0, pairs=0):
        from portbench.run import Shapes
        geom = ref.geometry(2160, 3840, 3840, 270)
        self.trace = trace_view
        self.peaks = work.Peaks(16.727e12, 3.35e12)
        self.config = {"model": "hopperxq"}
        self.shapes = Shapes(2160, 3840, 3840, 2, 8, geom.rs, geom.lh,
                             geom.lw, geom.windows, 16, 5, (16, 235))
        self.launches = launches
        self.pairs = pairs


def _trace_view():
    from portbench import trace
    rows = ([("void bilinear_blend_kernel<unsigned short, true, true, 4, 3>",
              100.0 * i, 100.0 * i + 60.0) for i in range(10)]
            + [("void pyramid_kernel<unsigned short, 16, false, true>",
                1000.0 + 300.0 * i, 1000.0 + 300.0 * i + 270.0)
               for i in range(2)])
    return trace.TraceView(rows, 2000.0, 1140.0, 2, [], [])


def test_the_q1_and_subpel_readers():
    view = _View(_trace_view())
    assert spec.reader("warp.q1_ms_per_pair").read(view) == pytest.approx(
        0.3)
    q1 = spec.reader("warp.q1_roofline").read(view)
    k1 = spec.reader("flow.k1_subpel_roofline").read(view)
    assert 5.0 < q1 < 100.0 and 5.0 < k1 < 100.0
    # the subpel share counts S1's operations on top of K1's
    assert k1 > spec.reader("flow.k1_roofline").read(view)
    view.trace = None
    for name in ("warp.q1_ms_per_pair", "warp.q1_roofline",
                 "flow.k1_subpel_roofline"):
        assert spec.reader(name).read(view) is None


def test_the_launches_reader():
    reader = spec.reader("group.launches_per_pair")
    assert reader.read(_View(None, launches=7 * 96, pairs=96)) == 7.0
    assert reader.read(_View(None, launches=0, pairs=96)) is None
    assert np.isclose(reader.read(_View(None, launches=7 * 96, pairs=96)),
                      spec.reader("engine.launches_per_pair").read(
                          _View(None, launches=7 * 96, pairs=96)))
