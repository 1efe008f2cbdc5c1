"""Set-up of a cell from its files: the configuration file reaches the
engine whole, a key the harness does not know stops the run, and the
reference that judges the outputs is the one the configuration chooses
(``reference/models.py``) -- a configuration it does not cover stops at
set-up, before the ring is made or the engine called."""

import dataclasses
import re
import time

import pytest

from conftest import calls_for
from portbench import content, control, run, spec
from portbench.reference import models, pair

# the engine keys the harness passed before it read the configuration
# file whole: the shipped configurations must build the same engine
FORMER_KEYS = ("display_fps", "frame_output_mode", "auto_quality",
               "initial_search_radius", "scene_detection", "scene_threshold",
               "cut_policy", "delta_scalar", "neighbor_bias_scalar",
               "black_level", "white_level", "max_calc_res",
               "num_iterations", "measure_timing", "model", "warp_sampling",
               "layer_buckets")
CONFIGS = [c["name"] for c in spec.benchmark()["configs"]]


def _former(cfg, device):
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import EngineConfig
    kw = {k: cfg[k] for k in FORMER_KEYS}
    kw["layer_buckets"] = tuple(kw["layer_buckets"])
    return EngineConfig(**kw, device=device)


@pytest.mark.parametrize("name", CONFIGS)
def test_a_shipped_configuration_builds_the_same_engine(name):
    cfg = spec.config(name)
    built, settings = run.engine_config(cfg, "cpu")
    want = _former(cfg, "cpu")
    for f in dataclasses.fields(want):
        assert getattr(built, f.name) == getattr(want, f.name), f.name
    # the reference reads every field, filled in, and the file's own keys
    assert settings["subpel_flow"] is False
    assert settings["pixfmt"] == cfg["pixfmt"]
    assert models.for_config(settings).outputs is pair.outputs


def test_every_engine_field_reaches_the_engine():
    cfg = {**spec.config(CONFIGS[0]), "subpel_flow": True,
           "degrade_rungs": [[1, 2], [2, 4, "blend"]], "split_timing": "off",
           "too_slow_patience": 5, "playback_speed": 1.5,
           "layer_buckets": [8, 16]}
    built, settings = run.engine_config(cfg, "cpu")
    assert built.subpel_flow is True and settings["subpel_flow"] is True
    assert built.degrade_rungs == ((1, 2, None), (2, 4, "blend"))
    assert built.layer_buckets == (8, 16)
    assert (built.split_timing, built.too_slow_patience,
            built.playback_speed) == ("off", 5, 1.5)
    assert built.device == "cpu"


class _Untouched:
    """Stand-ins that fail the test if set-up went as far as the ring or
    the engine."""

    def __init__(self, monkeypatch):
        self.engines = []

        def no_ring(*a, **kw):
            raise AssertionError("the ring was made")
        monkeypatch.setattr(content, "make_ring", no_ring)

    def hook(self, engine):
        self.engines.append(engine)
        return engine


def _run(cell, small, **kw):
    return run.run_cell(cell, 4242, 0, False, time.perf_counter(),
                        device="cpu", overrides=small,
                        max_calls=calls_for(cell), **kw)


@pytest.mark.parametrize("extra,named", [
    ({"subpel_flows": True}, "subpel_flows"),
    ({"model": "hopperxq", "subpel_flow": True}, "model='hopperxq'"),
    ({"subpel_flow": True}, "subpel_flow=True"),
    ({"frame_output_mode": 3}, "frame_output_mode=3"),
    ({"cut_policy": "hold"}, "cut_policy='hold'"),
    ({"reference": "no_such_model"}, "no_such_model"),
])
def test_set_up_stops_before_the_ring(extra, named, small, monkeypatch):
    """An unknown key, or a configuration that its reference does not
    cover, stops set-up with a message that names it."""
    untouched = _Untouched(monkeypatch)
    o = {**small, "config": {**small["config"], **extra}}
    with pytest.raises(spec.SetupError, match=re.escape(named)):
        _run("uhd8.push", o, engine_hook=untouched.hook)
    assert untouched.engines == []


REFERENCE = '''
from portbench.reference import pair

COVERS = {"model": ("hopper",), "frame_output_mode": (2,),
          "subpel_flow": (False,)}


def outputs(f1, f2, geom, folded, cfg, scale_shift, levels):
    with open(__file__ + ".calls", "a") as fh:
        fh.write("%d\\n" % len(folded.ts))
    for y, uv in pair.outputs(f1, f2, geom, folded, cfg, scale_shift,
                              levels):
        if ALTER:
            y = y.clone()
            y.view(-1)[3] += 1
        yield y, uv
'''


@pytest.mark.parametrize("alter", [False, True])
def test_the_configurations_reference_judges(alter, small, tmp_path,
                                             monkeypatch):
    """A reference named by the configuration and loaded from its file is
    the one that makes the outputs the check compares: the same blend
    passes, and one sample changed in it fails every compared pair."""
    (tmp_path / "probe_ref.py").write_text(f"ALTER = {alter}\n" + REFERENCE)
    monkeypatch.setattr(models, "DIR", tmp_path)
    o = {**small, "config": {**small["config"], "reference": "probe_ref"}}
    r = _run("uhd8.group8", o)
    calls = (tmp_path / "probe_ref.py.calls").read_text().split()
    assert len(calls) == r["checks"]["pairs_compared"]["value"] >= 3
    assert r["correct"] is (not alter), r["checks"]
    if alter:
        assert r["failed"] == len(calls)


def test_a_reference_without_a_lower_variant_has_no_control(small, tmp_path,
                                                            monkeypatch):
    (tmp_path / "probe_ref.py").write_text("ALTER = False\n" + REFERENCE)
    monkeypatch.setattr(models, "DIR", tmp_path)
    o = {**small, "config": {**small["config"], "reference": "probe_ref"}}
    with pytest.raises(spec.SetupError, match="lower-precision"):
        control.readings("uhd8.group8", 5, "cpu", o)
