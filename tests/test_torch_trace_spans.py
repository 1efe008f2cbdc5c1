"""The engine's spans (``utils/trace.annotate``, ``utils/trace.SPANS``) on
the CPU at 96x64 NV12: none is made while no profiler records, and under
``torch.profiler`` ``push`` and ``push_many`` open the documented spans,
nested.  The CPU's
plain paths open only the engine's spans; the kernel wrappers' spans and
the card's (the wait, the replay, the copies out) are checked on the card
in ``tests/test_torch_cuda.py::test_engine_spans_on_the_card``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator_tpu_torch.utils import trace

torch.set_num_threads(1)

CFG = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)


def _engine():
    return InterpolationEngine(EngineConfig(
        device="cpu", display_fps=60.0, auto_quality=False,
        initial_search_radius=5))


def _spans(prof):
    """(name, start, end) of every ``mfi.`` host span, by start."""
    return sorted((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name.startswith("mfi."))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_span_without_a_profiler(monkeypatch):
    """With no profiler, every span is one shared object that enters no
    profiler op: an engine's push and push_many run with the profiler's
    span types made to raise."""
    assert not torch._C._autograd._profiler_enabled()
    assert trace.annotate("mfi.push") is trace.annotate("mfi.pair")
    assert trace.annotate("x") is trace._OFF

    def refuse(*args, **kw):
        raise AssertionError("a span was made with no profiler on")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    e = _engine()
    frames = list(synthetic.moving_box(CFG, 4))
    assert len(e.push(frames[0]) + e.push(frames[1])) == 1 + 3
    assert len(e.push_many(frames[2:], group_size=2)) == 2 + 3
    with trace.annotate("mfi.pair") as span:
        assert span is trace._OFF


@pytest.mark.parametrize("api", ["push", "push_many"])
def test_engine_spans_under_the_profiler(api):
    """``push`` gives mfi.push around mfi.pair; ``push_many`` gives
    mfi.push_many around the group's slot fill and its pairs' bodies; every
    span has its documented name."""
    e = _engine()
    frames = list(synthetic.moving_box(CFG, 4))
    e.push(frames[0])
    e.push(frames[1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if api == "push":
            outs = e.push(frames[2])
        else:
            outs = e.push_many(frames[2:], group_size=2)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert set(names) <= set(trace.SPANS)
    # the CPU's plain paths open no kernel wrapper's span
    assert not [n for n in names if n.startswith(("mfi.c1", "mfi.k"))]
    if api == "push":
        assert len(outs) == 2
        assert sorted(names) == ["mfi.pair", "mfi.push"]
        push = next(s for s in spans if s[0] == "mfi.push")
        pair = next(s for s in spans if s[0] == "mfi.pair")
        assert _inside(pair, push)
    else:
        assert len(outs) == 3 + 2
        assert names.count("mfi.push_many") == 1
        assert names.count("mfi.group.fill") == 1
        assert names.count("mfi.pair") == 2
        outer = next(s for s in spans if s[0] == "mfi.push_many")
        fill = next(s for s in spans if s[0] == "mfi.group.fill")
        assert all(_inside(s, outer) for s in spans if s is not outer)
        assert all(fill[2] <= s[1] for s in spans if s[0] == "mfi.pair")
