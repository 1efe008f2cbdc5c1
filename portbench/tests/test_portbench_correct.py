"""The check fails what it should: the control (the reference in the
program's place, its blend in bfloat16) and each fault a cell can have,
planted under the timed path of a whole run -- the harness's look for a
card skipped, on the CPU at a small size."""

import time

import pytest
import torch

from conftest import calls_for
from portbench import control, run


def _alter(y):
    """One sample changed where the output is produced."""
    if isinstance(y, torch.Tensor):
        y = y.clone()
        y.view(-1)[7] ^= 1
        return y
    return [_alter(y[0])] + list(y[1:])


def altered(engine):
    body = engine._pair_outputs

    def pair_outputs(*a, **kw):
        y, uv, score = body(*a, **kw)
        return _alter(y), uv, score
    engine._pair_outputs = pair_outputs
    return engine


def unchanged(engine):
    """A step that returns its state unchanged: every pair gives the first
    pair's outputs again."""
    body = engine._pair_outputs
    first = []

    def pair_outputs(*a, **kw):
        if not first:
            first.append(body(*a, **kw))
        return first[0]
    engine._pair_outputs = pair_outputs
    return engine


def half_left_out(engine):
    """Every second pair is left out: it gives the pair before it."""
    body = engine._pair_outputs
    state = {"n": 0, "last": None}

    def pair_outputs(*a, **kw):
        state["n"] += 1
        if state["n"] % 2 == 0 and state["last"] is not None:
            return state["last"]
        state["last"] = body(*a, **kw)
        return state["last"]
    engine._pair_outputs = pair_outputs
    return engine


def cut_not_folded(engine):
    engine.scene.enabled = False
    return engine


def _run(cell, small, hook=None):
    return run.run_cell(cell, 31337, 0, False, time.perf_counter(),
                        device="cpu", overrides=small,
                        max_calls=calls_for(cell), engine_hook=hook)


@pytest.mark.parametrize("cell", ["uhd8.group8", "uhd10tv.group8",
                                  "uhd8.push"])
def test_a_sound_run_is_correct(cell, small):
    r = _run(cell, small)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["samples_differing"]["value"] == 0


@pytest.mark.parametrize("fault,check", [
    (altered, "samples_differing"), (unchanged, "samples_differing"),
    (half_left_out, "samples_differing"),
    (cut_not_folded, "cut_count_error")])
@pytest.mark.parametrize("cell", ["uhd8.group8", "uhd10tv.group8",
                                  "uhd8.push"])
def test_a_fault_is_not_correct(cell, fault, check, small):
    r = _run(cell, small, fault)
    assert r["correct"] is False
    assert not r["checks"][check]["ok"], r["checks"]
    assert r["failed"] > 0 or check == "cut_count_error"


@pytest.mark.parametrize("cell", ["uhd8.group8", "uhd10tv.group8"])
def test_the_control_is_not_correct(cell, small):
    for seed in (5, 6, 7):
        r = control.readings(cell, seed, "cpu", small)
        assert r["pairs"] >= 3
        assert r["samples_differing"] > 0, r


class _Engine:
    """Returns no outputs: only the stream's position matters here."""

    def push(self, frame):
        return []

    def push_many(self, frames, group_size):
        return []


@pytest.mark.parametrize("cell", ["uhd8.group8", "uhd8.push"])
def test_the_control_samples_the_runs_pairs(cell, small):
    """The control draws its pairs from the frame the window starts at in a
    run (``driver.Driver.warm``)."""
    from mpv_frame_interpolator_tpu_torch.frame import FrameFormat
    from portbench import content, driver, spec
    _, cfg, traffic, ring, sample = spec.settings(cell, small)
    frames = content.make_ring(cfg["width"], cfg["height"], cfg["pixfmt"],
                               content.RingParams(**ring), 1, "cpu")
    stream = driver.Stream(frames, FrameFormat(cfg["width"], cfg["height"],
                                               cfg["pixfmt"]), 24.0)
    drv = driver.Driver(_Engine(), stream, traffic)
    drv.warm(int(traffic["warm_calls"]), 15)
    assert stream.next_index == control.first_window_frame(traffic)
