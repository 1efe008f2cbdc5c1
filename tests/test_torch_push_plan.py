"""``push``'s launch plan (``pipeline/push_plan.py``): C1, K1 and K2 of
the main-path pair launched from arguments checked once per key, into
intermediates the engine owns.

On the CPU, with a recording stand-in for the kernels' library (and the
card's checks made on the CPU's tensors): the plan passes each C entry
the arguments its wrapper passes; each field of the key builds a new plan,
and the number of positions does not; the pairs the plan does not serve
(other modes, samplers and models, ``subpel_flow``, the CPU itself) call
the wrappers and count as fallbacks; a frame whose planes do not fit the
plan takes the wrappers, which raise their own errors.

On a card (marker ``gpu``; skipped without one): the plan's outputs,
scores and cut counts equal the wrappers' bit for bit, through a scene
cut, NV12 and P010, split timing, a change of radius and level and a
switch of streams, with three launches a pair.  This file imports no jax,
so on the card's machine it runs as

    python -m pytest --noconftest -q tests/test_torch_push_plan.py
"""

import ctypes
import dataclasses

import pytest
import torch

from mpv_frame_interpolator_tpu_torch.convert import DeviceFrame, frame_to_device
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.ops import flow as F
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.ops.cuda import prologue as KC
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
from mpv_frame_interpolator_tpu_torch.pipeline import engine as E


class Entries:
    """A stand-in for the kernels' library: each C entry records its name
    and arguments (a ctypes array as a list) and returns 0."""

    def __init__(self):
        self.calls = []
        self.stream = 7         # the raw handle `_build.stream_of` gives

    def __getattr__(self, name):
        if not name.startswith("mfi_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, tuple(
                list(a) if isinstance(a, ctypes.Array) else a
                for a in args)))
            return 0
        return entry

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def _require_here(t, name, dtype, shape=None, device=None):
    """``_build.require`` without its CUDA check: the card's checks of
    the CPU's tensors."""
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@pytest.fixture
def entries(monkeypatch):
    lib = Entries()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "require", _require_here)
    monkeypatch.setattr(_build, "stream_of", lambda t: lib.stream)
    return lib


def _clip(n, width=64, height=48, pixfmt="nv12", cut_at=None):
    cfg = synthetic.SyntheticConfig(width=width, height=height, fps=24.0,
                                    pixfmt=pixfmt)
    if cut_at is None:
        return list(synthetic.moving_box(cfg, n))
    return list(synthetic.scene_cut(cfg, n, cut_at=cut_at))


def _engine(plan=True, **kw):
    kw = {"display_fps": 120.0, "auto_quality": False, "device": "cpu", **kw}
    e = E.InterpolationEngine(E.EngineConfig(**kw))
    e._plan_enabled = plan          # on the CPU's tensors, with `entries`
    return e


# -- on the CPU: the plan's logic ----------------------------------------


@pytest.mark.parametrize("pixfmt,scene,policy,fps", [
    ("nv12", True, "nearest", 120.0), ("nv12", False, "nearest", 60.0),
    ("p010", True, "hold", 60.0)])
def test_the_plan_passes_each_entry_its_wrappers_arguments(
        entries, pixfmt, scene, policy, fps):
    """Each pair's three calls against the wrappers' own: C1 through
    ``prologue._launch`` into the plan's intermediates, K1 through
    ``flow_step._launch`` (its own intermediates, so those three pointers
    aside), K2 as ``warp_pair.pair_blend`` calls it; 3 launches and one
    fused blur a pair on the wrappers' counters."""
    e = _engine(display_fps=fps, scene_detection=scene, cut_policy=policy,
                black_level=16.0, white_level=235.0)
    frames = _clip(7, pixfmt=pixfmt)
    e.push(frames[0])
    ss = 8 if pixfmt == "p010" else 0
    for frame in frames[1:]:
        f1 = e._cur
        before = [c.kernel for c in E._KERNEL_COUNTS], KB.counts.fused
        outs = e.push(frame)
        f2 = e._cur
        assert sum(c.kernel for c in E._KERNEL_COUNTS) - sum(before[0]) == 3
        assert KB.counts.fused == before[1] + 1
        (c1, a1), (k1, b1), (k2, c2) = entries.take()
        assert (c1, k1, k2) == ("mfi_pair_prologue", "mfi_flow_pyramid",
                                "mfi_pair_blend")
        plan, geom, knobs = e._push_plan, e.geom, e._knobs()
        ts = next(t for t in e._ts_cache.values() if t.data_ptr() == a1[4])
        n = ts.shape[0]
        assert n == len(outs) and a1[13] == n
        pro = KC.Prologue(plan.score, plan.cut, plan.folded, plan.probe)
        KC._launch(geom, f1.y, f2.y, f2.u, f2.v, ts, e._cuts, e._partials,
                   pro, ss, knobs.scene_threshold, policy, False)
        KS._launch(f1.y, f1.u, f1.v, *plan.probe, None, None,
                   KS.pyramid_steps(geom.window_schedule(),
                                    F.FIRST_NEIGHBOR_ITERATION),
                   e.quality.search_radius, knobs.delta_scalar,
                   knobs.neighbor_bias_scalar, geom.res_scalar, geom.height,
                   geom.stride, ss, None, True,
                   e._layers_for(e.quality.search_radius), False, plan.cut)
        (_, w1), (_, w2) = entries.take()
        assert a1 == w1
        w2 = list(w2)
        w2[8:10], w2[12] = (plan.field.data_ptr(),
                            plan.blurred.data_ptr()), plan.sums.data_ptr()
        assert list(b1) == w2
        y, uv = outs[0]._y, outs[0]._uv
        assert y.shape == (n, geom.height, geom.actual_width)
        assert uv.shape == (n, geom.height // 2, geom.actual_width)
        k, w = knobs.levels
        vec = KW.vector_path((f1.y, f1.uv, f2.y, f2.uv, y, uv),
                             geom.actual_width)
        assert c2 == (f1.y.data_ptr(), f1.uv.data_ptr(), f2.y.data_ptr(),
                      f2.uv.data_ptr(), plan.blurred.data_ptr(),
                      plan.folded.data_ptr(), y.data_ptr(), uv.data_ptr(), n,
                      geom.height, geom.actual_width, geom.stride,
                      geom.low_h, geom.low_w, geom.res_scalar, ss, k, w,
                      int(vec), entries.stream)
    assert e.plan_stats == {"builds": 1, "pairs": 6, "fallbacks": 0}


def _set(attr, value):
    def change(e):
        obj = e
        *path, last = attr.split(".")
        for part in path:
            obj = getattr(obj, part)
        setattr(obj, last, value)
    return change


KEY_CHANGES = {
    "level and geometry": _set("quality.level", 1),
    "radius": _set("quality.search_radius", 6),
    "layers": _set("config.layer_buckets", (8, 16)),
    "black level": _set("black_level", 16.0),
    "white level": _set("white_level", 235.0),
    "delta scalar": _set("delta_scalar", 7),
    "neighbour bias": _set("neighbor_bias_scalar", 5),
    "scene detection": _set("scene.enabled", False),
    "scene threshold": _set("scene.threshold", 30.0),
    "sampler": _set("config.warp_sampling", "shift"),
    "cut policy": _set("config.cut_policy", "hold"),
    "stream": lambda e: setattr(_build.load(), "stream", 9),
    "calc resolution": lambda e: (_set("config.max_calc_res", 64)(e),
                                  e.invalidate_geometry()),
}


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_each_field_of_the_key_builds_a_plan(entries, change):
    """A change of any field of the key between two pairs builds a new
    plan for the next pair (the one before is dropped), and every pair
    still runs on a plan."""
    e = _engine(initial_search_radius=5, layer_buckets=(5, 8, 16))
    frames = _clip(7, width=128, height=96)
    for f in frames[:4]:
        e.push(f)
    first = e._push_plan
    assert e.plan_stats == {"builds": 1, "pairs": 3, "fallbacks": 0}
    KEY_CHANGES[change](e)
    for f in frames[4:]:
        e.push(f)
    assert e.plan_stats["builds"] == 2
    assert e.plan_stats["fallbacks"] == 0
    assert e._push_plan is not first and e._push_plan.key != first.key


@pytest.mark.parametrize("pixfmt,size", [("p010", (64, 48)),
                                         ("nv12", (96, 48))])
def test_a_new_format_or_size_builds_a_plan(entries, pixfmt, size):
    e = _engine()
    for f in _clip(3) + _clip(3, *size, pixfmt=pixfmt):
        e.push(f)
    # each format's first frame passes through and anchors the flow
    assert e.plan_stats == {"builds": 2, "pairs": 4, "fallbacks": 0}
    assert e._push_plan.dtype == (torch.uint16 if pixfmt == "p010"
                                  else torch.uint8)


def test_positions_of_any_count_share_a_plan(entries):
    """At 24 -> 60 fps a pair has 3 or 2 positions in turn: one plan
    serves both, each launch of C1 and K2 taking the pair's count."""
    e = _engine(display_fps=60.0)
    counts = []
    for f in _clip(7):
        outs = e.push(f)
        calls = entries.take()
        if calls:
            n = len(outs)
            assert calls[0][1][13] == n and calls[2][1][8] == n
            counts.append(n)
    assert sorted(set(counts)) == [2, 3]
    assert e.plan_stats == {"builds": 1, "pairs": 6, "fallbacks": 0}


FALLBACKS = {
    "mode 0": dict(frame_output_mode=0),
    "mode 3": dict(frame_output_mode=3),
    "mode 4": dict(frame_output_mode=4),
    "mode 5": dict(frame_output_mode=5),
    "fused sampler": dict(warp_sampling="fused"),
    "pallas sampler": dict(warp_sampling="pallas"),
    "hopperx": dict(model="hopperx"),
    "hopperq": dict(model="hopperq"),
    "blend": dict(model="blend"),
    "repeat": dict(model="repeat"),
    "subpel_flow": dict(subpel_flow=True),
}


@pytest.mark.parametrize("case", list(FALLBACKS) + ["the CPU"])
def test_pairs_the_plan_does_not_serve_take_the_wrappers(entries, case):
    """Another mode, sampler or model, ``subpel_flow`` and the CPU: every
    pair calls the wrappers (their plain versions here, no C entry) and
    counts as a fallback; no plan is built."""
    e = _engine(plan=case != "the CPU", **FALLBACKS.get(case, {}))
    for f in _clip(4):
        e.push(f)
    assert not entries.calls
    assert e.plan_stats == {"builds": 0, "pairs": 0, "fallbacks": 3}


def test_a_rung_of_another_model_takes_the_wrappers(entries):
    """The ladder's blend rung runs model blend: its pairs fall back and
    keep the plan, which serves level 0's pairs after them again."""
    e = _engine()
    frames = _clip(8)
    for f in frames[:3]:
        e.push(f)
    e.quality.level = 3
    for f in frames[3:5]:
        e.push(f)
    assert e.plan_stats == {"builds": 1, "pairs": 2, "fallbacks": 2}
    e.quality.level = 0
    for f in frames[5:]:
        e.push(f)
    assert e.plan_stats == {"builds": 1, "pairs": 5, "fallbacks": 2}


def _misfit(frame: DeviceFrame, plane: str, how: str) -> DeviceFrame:
    t = getattr(frame, plane)
    if how == "shape":
        t = torch.cat([t, t[:, :16]], dim=1)
    elif how == "dtype":
        t = t.to(torch.int16)
    elif how == "device":
        t = t.to("meta")
    else:                                   # not contiguous, same shape
        t = torch.stack([t, t], dim=-1)[..., 0]
    return dataclasses.replace(frame, **{plane: t})


@pytest.mark.parametrize("older,plane,how,message", [
    (False, "y", "shape", "are not one \\(H, stride\\) shape"),
    (False, "uv", "shape", "f2uv must be torch.uint8 \\(24, 64\\)"),
    (True, "uv", "dtype", "f1uv must be torch.uint8"),
    (True, "y", "device", "y2 is on cpu, expected meta"),
    (False, "u", "contiguity", None)])
def test_a_frame_that_does_not_fit_takes_the_wrappers(entries, older, plane,
                                                      how, message):
    """After the plan is built, a pair whose older or newer frame has a
    plane of another shape, dtype or device, or not contiguous, launches
    nothing on the plan: it calls the wrappers, which raise their own
    ValueError (on the CPU a strided plane is theirs to take)."""
    e = _engine()
    frames = [frame_to_device(f, "cpu") for f in _clip(4)]
    for f in frames[:3]:
        e.push(f)
    assert e.plan_stats == {"builds": 1, "pairs": 2, "fallbacks": 0}
    entries.take()
    f1, f2 = frames[2], frames[3]
    if older:
        f1 = _misfit(f1, plane, how)
    else:
        f2 = _misfit(f2, plane, how)
    ts = e._ts_for((0.2, 0.4, 0.6, 0.8, 1.0))
    args = (0, e.quality.search_radius, f1, f2, ts, e._knobs(), None)
    if message is None:
        y, uv, _ = e._push_pair(*args)
        assert y.shape == (5, 48, 64)
    else:
        with pytest.raises(ValueError, match=message):
            e._push_pair(*args)
    assert not entries.calls
    assert e.plan_stats == {"builds": 1, "pairs": 2, "fallbacks": 1}


def test_the_stats_dump_holds_the_plan_stats(tmp_path):
    import json
    from mpv_frame_interpolator_tpu_torch import cli
    stats = tmp_path / "s.json"
    assert cli.main(["synthetic:moving_box", "--width", "64", "--height",
                     "48", "--frames", "4", "--untimed", "--device", "cpu",
                     "--no-auto-quality", "-o", str(tmp_path / "o.y4m"),
                     "--dump-stats", str(stats)]) == 0
    assert json.loads(stats.read_text())["plan_stats"] == {
        "builds": 0, "pairs": 0, "fallbacks": 3}


# -- on the card: the plan against the wrappers ---------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _rebuild(e):
    e.quality.search_radius = 9
    e.quality.level = 1


@pytest.mark.gpu
@pytest.mark.parametrize("pixfmt,size,fps,split,script", [
    ("nv12", (96, 64), 120.0, "auto", None),
    ("p010", (96, 64), 60.0, "auto", None),
    ("nv12", (202, 118), 60.0, "always", None),
    ("p010", (202, 118), 120.0, "always", "rebuild"),
    ("nv12", (96, 64), 120.0, "auto", "stream"),
    ("nv12", (3840, 2160), 120.0, "always", "rebuild")])
def test_the_plan_equals_the_wrappers_on_the_card(cuda, pixfmt, size, fps,
                                                  split, script):
    """The same frames through an engine on the plan and one on the
    wrappers: every output bit-identical, the same cut score read back
    after every push, the same cuts counted (the clip has a cut), three
    launches a plan pair; a change of radius and level mid-stream builds a
    plan again, and so does a switch to another stream."""
    frames = [frame_to_device(f, cuda)
              for f in _clip(12, *size, pixfmt=pixfmt, cut_at=6)]
    torch.cuda.synchronize()
    kw = dict(device=str(cuda), display_fps=fps, auto_quality=False,
              split_timing=split, initial_search_radius=16,
              black_level=16.0 if pixfmt == "p010" else 0.0,
              white_level=235.0 if pixfmt == "p010" else 255.0)
    plan_e = E.InterpolationEngine(E.EngineConfig(**kw))
    wrap_e = E.InterpolationEngine(E.EngineConfig(**kw))
    wrap_e._plan_enabled = False
    side = torch.cuda.Stream(cuda)
    for i, f in enumerate(frames):
        if i == 7 and script == "rebuild":
            _rebuild(plan_e)
            _rebuild(wrap_e)
        stream = side if script == "stream" and i >= 7 else None
        with torch.cuda.stream(stream):
            before = sum(c.kernel for c in E._KERNEL_COUNTS)
            got = plan_e.push(f)
            launched = sum(c.kernel for c in E._KERNEL_COUNTS) - before
            want = wrap_e.push(f)
        torch.cuda.synchronize()
        assert launched == (3 if i else 0)
        assert [o.pts for o in got] == [o.pts for o in want]
        for a, b in zip(got, want):
            for x, y in zip(a.device_planes(), b.device_planes()):
                assert torch.equal(_bits(x), _bits(y))
        assert plan_e.last_cut_score() == wrap_e.last_cut_score()
        if i:
            assert float(plan_e._last_cut_score) == float(
                wrap_e._last_cut_score)
    plan_e.flush()
    wrap_e.flush()
    assert plan_e.scene_cuts() == wrap_e.scene_cuts() >= 1
    assert plan_e.scene.last_score == wrap_e.scene.last_score
    builds = 2 if script else 1
    assert plan_e.plan_stats == {"builds": builds, "pairs": 11,
                                 "fallbacks": 0}
    assert wrap_e.plan_stats == {"builds": 0, "pairs": 0, "fallbacks": 11}
    assert plan_e.stats.count("flow_time") == \
        wrap_e.stats.count("flow_time") == (10 if split == "always" else 0)


@pytest.mark.gpu
def test_a_frame_on_another_device_raises_the_wrappers_error(cuda):
    e = E.InterpolationEngine(E.EngineConfig(device=str(cuda),
                                             auto_quality=False))
    frames = [frame_to_device(f, cuda) for f in _clip(3)]
    for f in frames:
        e.push(f)
    host = frame_to_device(_clip(1)[0], "cpu")
    with pytest.raises(ValueError, match="y2 must be a CUDA tensor"):
        e.push(dataclasses.replace(host, pts=3 / 24.0))
    assert e.plan_stats == {"builds": 1, "pairs": 2, "fallbacks": 1}
