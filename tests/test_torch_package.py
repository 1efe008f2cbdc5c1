"""Package-level properties of the port: it never imports jax (or triton)
and touches no CUDA state on its CPU path, it imports nothing of the JAX
package (its host modules are its own copies, each held here against its
original), its kernels build from its own sources for sm_90a, its
wrappers never fall back to the plain version for a tensor that is not on
the CPU, and what carries across from the JAX package (config, geometry,
frames) carries across unchanged."""

import ast
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu import frame as jax_frame
from mpv_frame_interpolator_tpu import models as jax_models
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.io import y4m as jax_y4m
from mpv_frame_interpolator_tpu.ops import flow as jax_flow
from mpv_frame_interpolator_tpu.pipeline import cadence as jax_cadence
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu.pipeline import present as jax_present
from mpv_frame_interpolator_tpu.pipeline import quality as jax_quality
from mpv_frame_interpolator_tpu_torch import convert
from mpv_frame_interpolator_tpu_torch import frame as port_frame
from mpv_frame_interpolator_tpu_torch import models as port_models
from mpv_frame_interpolator_tpu_torch.io import synthetic as port_synthetic
from mpv_frame_interpolator_tpu_torch.io import y4m as port_y4m
from mpv_frame_interpolator_tpu_torch.ops import flow as port_flow
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.ops.cuda import subpel as KP
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_bilinear as KQ
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KD
from mpv_frame_interpolator_tpu_torch.pipeline import cadence as port_cadence
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine
from mpv_frame_interpolator_tpu_torch.pipeline import present as port_present
from mpv_frame_interpolator_tpu_torch.pipeline import quality as port_quality

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_SUBPROCESS = r"""
import pkgutil, sys, tempfile, os
import torch
import mpv_frame_interpolator_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if m.name.endswith("__main__"):
        continue
    __import__(m.name)
for name in ("tools.quality_report", "tools.degrade_ladder",
             "examples.embed", "examples.serving_farm"):
    assert f"{pkg.__name__}.{name}" in sys.modules, name
from mpv_frame_interpolator_tpu_torch import cli
out = os.path.join(tempfile.mkdtemp(), "out.y4m")
rc = cli.main(["synthetic:moving_box", "--width", "64", "--height", "48",
               "--frames", "4", "--untimed", "--device", "cpu", "-o", out])
assert rc == 0 and os.path.getsize(out) > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton"))
assert not bad, bad
assert not torch.cuda.is_initialized()
print("CLEAN")
"""


def test_no_jax_no_triton_no_cuda_init():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("CLEAN")


_SMOKE_IMPORTS = {"__future__", "json", "os", "socket", "statistics",
                  "subprocess", "sys", "tempfile", "threading", "time",
                  "numpy", "torch", "mpv_frame_interpolator_tpu_torch"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_imports_only_the_port():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= _SMOKE_IMPORTS, names - _SMOKE_IMPORTS


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        (tmp_path / "chip_smoke.py").write_bytes(
            (REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=str(cwd))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_counts_y4m_frames(tmp_path):
    from mpv_frame_interpolator_tpu_torch import cli
    smoke = _chip_smoke()
    out = tmp_path / "out.y4m"
    stats = tmp_path / "stats.json"
    assert cli.main(["synthetic:moving_box", "--width", "64", "--height",
                     "48", "--frames", "5", "--display-fps", "120",
                     "--untimed", "--device", "cpu", "-o", str(out),
                     "--dump-stats", str(stats)]) == 0
    assert smoke.y4m_frames(str(out)) == (64, 48, 1 + 5 * 4)
    out.write_bytes(out.read_bytes()[:-1])
    with pytest.raises(SystemExit, match="truncated"):
        smoke.y4m_frames(str(out))


def test_nvcc_command_line():
    compiles, link = _build.nvcc_commands("nvcc", Path("/tmp/lib.so"),
                                          Path("/tmp/obj"))
    sources = []
    for cmd in compiles:      # one nvcc process per source
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--fmad=false" in cmd and "-c" in cmd
        sources += [Path(a) for a in cmd if a.endswith(".cu")]
    assert len(sources) == len(compiles)
    assert all(s.parent == _build.CSRC_DIR for s in sources)
    assert sorted(s.name for s in sources) == sorted(
        p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert all(s.exists() for s in sources)
    assert "-shared" in link and link[link.index("-o") + 1] == "/tmp/lib.so"
    assert sorted(a for a in link if a.endswith(".o")) == sorted(
        c[c.index("-o") + 1] for c in compiles)
    # the headers the sources include are part of the build's key
    assert sorted(_build.HEADERS) == sorted(
        p.name for p in _build.CSRC_DIR.glob("*.cuh"))


def test_build_directory_is_keyed_by_the_sources():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT
    assert _build.BUILD_ROOT.parts[-2] == "build"
    assert d == _build.build_dir()


@pytest.mark.parametrize("call", ["flow_step", "blur_flow", "pair_blend",
                                  "fused_blend", "sample_dir",
                                  "bilinear_blend", "subpel_refine"])
def test_no_fallback_off_the_cpu(call):
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper's checks reject it (here a meta tensor; a CUDA tensor goes on
    to the kernel)."""
    meta = dict(device="meta")
    if call == "flow_step":
        counts = KS.counts
        u8 = lambda *s: torch.empty(s, dtype=torch.uint8, **meta)  # noqa
        i32 = torch.empty((6, 8), dtype=torch.int32, **meta)
        args = (u8(48, 64), u8(24, 32), u8(24, 32), u8(6, 8), u8(6, 8),
                u8(6, 8), i32, i32, 0, 5, 8, 6, 2, False, 3, 48, 64)
        fn = KS.flow_step
    elif call == "blur_flow":
        counts, fn = KB.counts, KB.blur_flow
        args = (torch.empty((2, 6, 8), dtype=torch.int32, **meta),)
    elif call == "subpel_refine":
        counts, fn = KP.counts, KP.subpel_refine
        u8 = lambda *s: torch.empty(s, dtype=torch.uint8, **meta)  # noqa
        args = (torch.empty((2, 6, 8), dtype=torch.int32, **meta),
                u8(48, 64), u8(24, 32), u8(24, 32), u8(6, 8), u8(6, 8),
                u8(6, 8), 3, 48, 64)
    else:
        counts, fn = {"pair_blend": (KW.counts, KW.pair_blend),
                      "fused_blend": (KF.counts, KF.fused_blend),
                      "sample_dir": (KD.counts, KD.sample_dir),
                      "bilinear_blend": (KQ.counts, KQ.bilinear_blend)}[call]
        u16 = lambda *s: torch.empty(s, dtype=torch.uint16, **meta)  # noqa
        args = (u16(48, 64), u16(24, 64), u16(48, 64), u16(24, 64),
                torch.empty((2, 48, 64), dtype=torch.int32, **meta),
                torch.empty((2 if call == "pair_blend" else 1,),
                            dtype=torch.float32, **meta))
        args += ((21, 0, 64) if call == "sample_dir"
                 else (0, 64, 8, (16, 235)))
        if call == "bilinear_blend":
            args += (True,)
    before = (counts.kernel, counts.plain)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(*args)
    assert (counts.kernel, counts.plain) == before


def test_engine_config_from_jax_round_trip():
    for jcfg in (jax_engine.EngineConfig(),
                 jax_engine.EngineConfig(
                     display_fps=120.0, initial_search_radius=16,
                     scene_detection=False, cut_policy="hold",
                     auto_quality=False, flow_kernel="xla",
                     warp_sampling="shift", layer_buckets=(16,)),
                 jax_engine.EngineConfig(frame_output_mode=3,
                                         warp_sampling="pallas")):
        mapping = dataclasses.asdict(jcfg)
        pcfg = convert.engine_config_from_jax(mapping, device="cpu")
        assert pcfg.device == "cpu"
        for f in dataclasses.fields(pcfg):
            if f.name != "device":
                assert getattr(pcfg, f.name) == mapping[f.name], f.name
        # and back: the port's fields rebuild an equal JAX config
        back = jax_engine.EngineConfig(**{
            **mapping, **{k: v for k, v in dataclasses.asdict(pcfg).items()
                          if k != "device"}})
        assert back == jcfg


@pytest.mark.parametrize("kw,override,err", [
    (dict(subpel_flow=True), dict(initial_search_radius=257), ValueError),
    (dict(split_timing="always"), dict(split_timing="sometimes"),
     ValueError),
    (dict(degrade_rungs=()), dict(initial_search_radius=1), ValueError)])
def test_engine_config_from_jax_rejects(kw, override, err):
    """What does not convert: values the JAX config itself refuses (put
    into the mapping by hand), such as a radius outside [2, 256].  Radii
    above 16, the ladder, split timing and sub-pel flow convert
    (test_engine_config_from_jax_auto_quality_path), and so does the stats
    log (test_engine_config_from_jax_stats_log); the port leaves no
    mechanism out (`convert.OMITTED_AT_DEFAULT` is empty)."""
    assert convert.OMITTED_AT_DEFAULT == {}
    mapping = dataclasses.asdict(jax_engine.EngineConfig(**kw))
    mapping.update(override)
    with pytest.raises(err):
        convert.engine_config_from_jax(mapping)


@pytest.mark.parametrize("kw,override", [
    (dict(frame_output_mode=5, stats_log_path="pairs.log"), {}),
    (dict(model="hopperx", stats_log_path="pairs.log"), {}),
    (dict(frame_output_mode=6, subpel_flow=True), dict(stats_log_path="x"))])
def test_engine_config_from_jax_stats_log(kw, override):
    """A stats log converts with the rest of the config (it refused to
    before the port had one)."""
    mapping = dataclasses.asdict(jax_engine.EngineConfig(**kw))
    mapping.update(override)
    pcfg = convert.engine_config_from_jax(mapping, device="cpu")
    assert pcfg.stats_log_path == mapping["stats_log_path"]
    for name in kw:
        assert getattr(pcfg, name) == mapping[name], name


@pytest.mark.parametrize("kw", [
    dict(initial_search_radius=64, layer_buckets=(4, 24)),
    dict(degrade_rungs=((1, 2), (2, 2, "blend")), split_timing="always"),
    dict(degrade_rungs=(), subpel_flow=True, model="hopperq",
         split_timing="off", layer_buckets=())])
def test_engine_config_from_jax_auto_quality_path(kw):
    """The auto-quality path's knobs are real fields of the port's config,
    copied as the JAX config normalised them (buckets sorted, rungs as
    (delta, divisor, model) triples)."""
    jcfg = jax_engine.EngineConfig(**kw)
    pcfg = convert.engine_config_from_jax(dataclasses.asdict(jcfg),
                                          device="cpu")
    for name in ("initial_search_radius", "layer_buckets", "degrade_rungs",
                 "split_timing", "subpel_flow", "model"):
        assert getattr(pcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("mode", range(7))
@pytest.mark.parametrize("sampling", ["pair", "pallas"])
def test_engine_config_from_jax_modes(mode, sampling):
    """Modes 0-6 convert under every sampler."""
    mapping = dataclasses.asdict(jax_engine.EngineConfig(
        frame_output_mode=mode, warp_sampling=sampling))
    pcfg = convert.engine_config_from_jax(mapping, device="cpu")
    assert (pcfg.frame_output_mode, pcfg.warp_sampling) == (mode, sampling)


def test_engine_config_from_jax_unknown_key():
    mapping = dataclasses.asdict(jax_engine.EngineConfig())
    mapping["warp_kernel"] = "x"
    with pytest.raises(KeyError):
        convert.engine_config_from_jax(mapping)


def test_flow_geometry_matches_jax():
    for h in (48, 108, 180, 270, 271, 544, 1080, 2160, 4320):
        for w in (64, 96, 1920, 3840):
            for stride in (w, w + 32):
                for mcr in (24, 64, 270):
                    for it in (0, 3):
                        a = jax_flow.FlowGeometry.create(h, stride, w, mcr,
                                                         it)
                        b = port_flow.FlowGeometry.create(h, stride, w,
                                                          mcr, it)
                        assert dataclasses.asdict(a) == \
                            dataclasses.asdict(b)
                        assert a.window_schedule() == b.window_schedule()


def test_frame_to_device(small_cfg):
    frame = next(synthetic.moving_box(dataclasses.replace(
        small_cfg, stride=80), 1))
    dev = convert.frame_to_device(frame, "cpu")
    assert dev.y.dtype == dev.uv.dtype == torch.uint8
    np.testing.assert_array_equal(dev.y.numpy(), frame.y)
    np.testing.assert_array_equal(dev.uv.numpy(), frame.uv)
    np.testing.assert_array_equal(dev.u.numpy(), frame.uv[:, 0::2])
    np.testing.assert_array_equal(dev.v.numpy(), frame.uv[:, 1::2])
    assert dev.u.is_contiguous() and dev.v.is_contiguous()
    assert (dev.fmt, dev.pts, dev.nominal_fps) == (frame.fmt, frame.pts,
                                                   frame.nominal_fps)
    frame.y[:] = 0          # the device copy owns its memory
    assert dev.y.numpy().any()


def test_engine_stage_and_push_accept_staged_frames(small_cfg):
    eng = port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", auto_quality=False))
    frames = list(synthetic.moving_box(small_cfg, 3))
    outs = [o for f in frames for o in eng.push(eng.stage(f))]
    assert len(outs) == 1 + 3 + 2
    assert eng.stats.summary()["source_frame_time"]["count"] == 1


# --- the port stands on its own -------------------------------------------

OLD = "mpv_frame_interpolator_tpu"


def _old_package_imports(path: Path):
    """Every import in `path` of the JAX package or a module of it (the
    port's own package, whose name only starts the same, does not
    count)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        found += [n for n in names if n == OLD or n.startswith(OLD + ".")]
    return found


# the modules of the control surfaces (copies of the JAX package's, none
# of which imports jax, and all of which the port keeps as its own)
CONTROL_MODULES = ("api.py", "options.py", "pipeline/resume.py",
                   "control/__init__.py", "control/applet.py",
                   "control/applet_client.py", "control/input.py",
                   "control/ipc.py", "utils/trace.py")
# the last modules ported: the oracle copy, the metrics, the parity and
# chip-time harnesses with their entry points, and parallel/
LAST_MODULES = ("ops/oracle.py", "ops/metrics.py", "utils/parity.py",
                   "utils/chiptime.py", "parallel/__init__.py",
                   "parallel/batch.py", "parallel/streams.py",
                   "parallel/farm.py", "parallel/sharding.py",
                   "parallel/dryrun.py", "tools/parity_report.py",
                   "tools/chip_time.py", "tools/multi_card.py")


def test_the_port_imports_nothing_of_the_jax_package():
    files = sorted((REPO / "mpv_frame_interpolator_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    walked = {str(f.relative_to(REPO / "mpv_frame_interpolator_tpu_torch"))
              for f in files[:-1]}
    assert set(CONTROL_MODULES) <= walked
    assert set(LAST_MODULES) <= walked
    bad = {str(f.relative_to(REPO)): _old_package_imports(f) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_the_import_check_sees_old_package_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import mpv_frame_interpolator_tpu_torch.cli\n"
                     "from mpv_frame_interpolator_tpu_torch import frame\n"
                     "from mpv_frame_interpolator_tpu.frame import NV12\n"
                     "import mpv_frame_interpolator_tpu\n"
                     "from . import sibling\n")
    assert _old_package_imports(probe) == [
        "mpv_frame_interpolator_tpu.frame", "mpv_frame_interpolator_tpu"]


_BLOCKED = r"""
import sys
sys.modules["mpv_frame_interpolator_tpu"] = None
import mpv_frame_interpolator_tpu_torch.cli
import mpv_frame_interpolator_tpu_torch.pipeline.engine
import mpv_frame_interpolator_tpu_torch.io.sinks
import mpv_frame_interpolator_tpu_torch.api
import mpv_frame_interpolator_tpu_torch.options
import mpv_frame_interpolator_tpu_torch.pipeline.resume
import mpv_frame_interpolator_tpu_torch.control.applet
import mpv_frame_interpolator_tpu_torch.control.applet_client
import mpv_frame_interpolator_tpu_torch.control.input
import mpv_frame_interpolator_tpu_torch.control.ipc
import mpv_frame_interpolator_tpu_torch.utils.trace
import mpv_frame_interpolator_tpu_torch.parallel.sharding
import mpv_frame_interpolator_tpu_torch.parallel.dryrun
import mpv_frame_interpolator_tpu_torch.utils.parity
import mpv_frame_interpolator_tpu_torch.utils.chiptime
from mpv_frame_interpolator_tpu_torch.utils.parity import run_parity
assert all(ok for _, ok in run_parity(device="cpu"))
print("STANDS")
"""


def test_the_port_imports_with_the_jax_package_blocked():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("STANDS")


# --- each copied host module against its original --------------------------

# (display fps, source pts sequence, nominal fps): fixed rates, an
# irregular pts run that trips the drift re-anchor, and a variable rate
_PTS_CASES = [
    (60.0, [i / 24 for i in range(40)], 24.0),
    (120.0, [i / 24 for i in range(40)], 24.0),
    (60.0, [0.0, 0.04, 0.09, 0.125, 0.3, 0.33, 0.37, 0.41, 0.9, 0.95], 24.0),
    (120.0, list(np.cumsum(np.random.default_rng(3).uniform(0.02, 0.06,
                                                            50))), 0.0),
]


@pytest.mark.parametrize("display,pts,nominal", _PTS_CASES)
def test_cadence_copy_plans_as_the_original(display, pts, nominal):
    ref = jax_cadence.CadenceEngine(display)
    port = port_cadence.CadenceEngine(display)
    for i, t in enumerate(pts):
        if i == len(pts) // 2:
            for c in (ref, port):
                c.set_speed(1.25)
        a = ref.on_source_frame(float(t), nominal)
        b = port.on_source_frame(float(t), nominal)
        assert (a.passthrough, a.compute_flow, a.inconsistent_detected) == \
            (b.passthrough, b.compute_flow, b.inconsistent_detected)
        assert [(o.pts, o.blend, o.is_source_slot) for o in a.outputs] == \
            [(o.pts, o.blend, o.is_source_slot) for o in b.outputs]
        assert ref.state.name == port.state.name


@pytest.mark.parametrize("max_level", [0, 3])
def test_quality_copy_decides_as_the_original(max_level):
    """Radius, ladder level and TooSlow decisions over random durations,
    with and without a ladder (rung 2 cold for a while: the gate)."""
    rng = np.random.default_rng(7)
    durations = list(rng.uniform(0.0, 0.05, 200)) + [0.04] * 20 + [0.0] * 3
    for patience in (1, 3):
        cad = [jax_cadence.CadenceEngine(60.0),
               port_cadence.CadenceEngine(60.0)]
        for c in cad:
            c.on_source_frame(0.0, 24.0)
        ref = jax_quality.QualityController(search_radius=9,
                                            too_slow_patience=patience,
                                            max_level=max_level)
        port = port_quality.QualityController(search_radius=9,
                                              too_slow_patience=patience,
                                              max_level=max_level)
        for i, d in enumerate(durations):
            warm = (lambda lvl, i=i: lvl != 2 or i > 100)
            ref.rung_warm = port.rung_warm = warm
            ref.update(d, cad[0])
            port.update(d, cad[1])
            assert ref.search_radius == port.search_radius
            assert ref.level == port.level
            assert cad[0].state.name == cad[1].state.name


def test_present_copy_paces_as_the_original():
    clocks = [jax_present.PresentClock(60.0, untimed=True),
              port_present.PresentClock(60.0, untimed=True)]
    for pts in np.arange(0, 2, 1 / 24):
        a, b = (c.present(float(pts)) for c in clocks)
        assert dataclasses.astuple(a)[:2] == dataclasses.astuple(b)[:2]


_CLIPS = ["moving_box", "gradient_pan", "noise", "scene_cut",
          "random_frames"]


@pytest.mark.parametrize("pixfmt", ["nv12", "p010"])
@pytest.mark.parametrize("clip", _CLIPS)
def test_synthetic_copy_makes_the_original_frames(clip, pixfmt):
    kw = dict(width=64, height=48, fps=24.0, pixfmt=pixfmt, stride=80)
    ref = getattr(synthetic, clip)(synthetic.SyntheticConfig(**kw), 7)
    port = getattr(port_synthetic, clip)(
        port_synthetic.SyntheticConfig(**kw), 7)
    n = 0
    for a, b in zip(ref, port):
        assert dataclasses.asdict(a.fmt) == dataclasses.asdict(b.fmt)
        assert (a.pts, a.nominal_fps) == (b.pts, b.nominal_fps)
        assert a.y.dtype == b.y.dtype == (np.uint16 if pixfmt == "p010"
                                           else np.uint8)
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.uv, b.uv)
        n += 1
    assert n == 7


def _frames_of(pixfmt):
    cfg = port_synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                         pixfmt=pixfmt)
    return list(port_synthetic.gradient_pan(cfg, 3))


@pytest.mark.parametrize("pixfmt,fps", [("nv12", 60.0), ("p010", 23.976),
                                        ("p010", 59.94)])
def test_y4m_writer_copy_writes_the_original_bytes(tmp_path, pixfmt, fps):
    frames = _frames_of(pixfmt)
    out = []
    for mod, fmt_mod in ((jax_y4m, jax_frame), (port_y4m, port_frame)):
        path = tmp_path / f"{mod.__name__}.y4m"
        with open(path, "wb") as fh:
            w = mod.Y4MWriter(fh, 64, 48, fps, pixfmt)
            for f in frames:
                w.write(fmt_mod.VideoFrame(f.y, f.uv, fmt_mod.FrameFormat(
                    64, 48, pixfmt), pts=f.pts))
            w.close()
        out.append(path.read_bytes())
    assert out[0] == out[1]
    assert out[1].count(b"FRAME\n") == 3


@pytest.mark.parametrize("pixfmt", ["nv12", "p010"])
def test_y4m_reader_copy_round_trip(tmp_path, pixfmt):
    frames = _frames_of(pixfmt)
    path = tmp_path / "clip.y4m"
    with open(path, "wb") as fh:
        w = port_y4m.Y4MWriter(fh, 64, 48, 24.0, pixfmt)
        for f in frames:
            w.write(f)
        w.close()
    with open(path, "rb") as fh:
        port = list(port_y4m.Y4MReader(fh))
    with open(path, "rb") as fh:
        ref = list(jax_y4m.Y4MReader(fh))
    assert len(port) == len(ref) == 3
    for f, p, r in zip(frames, port, ref):
        assert p.fmt.pixfmt == pixfmt and (p.pts, p.nominal_fps) == (
            r.pts, r.nominal_fps)
        # P010 keeps the top 10 bits through y4m's 10-bit samples
        keep = 0xFFC0 if pixfmt == "p010" else 0xFF
        np.testing.assert_array_equal(p.y, f.y & keep)
        np.testing.assert_array_equal(p.uv, f.uv & keep)
        np.testing.assert_array_equal(p.y, r.y)
        np.testing.assert_array_equal(p.uv, r.uv)


def test_models_copy_is_the_original():
    assert port_models.MODELS == jax_models.MODELS
    for name in jax_models.MODELS:
        assert port_models.validate(name) == jax_models.validate(name)
    for mod in (jax_models, port_models):
        with pytest.raises(ValueError, match="unknown interpolator model"):
            mod.validate("hopperz")


def test_y4m_reader_copy_rejects_what_the_original_rejects():
    import io
    for header in (b"YUV4MPEG2 W0 H48 F24:1\n", b"NOTY4M\n",
                   b"YUV4MPEG2 W64 H48 F24:1 C444\n"):
        for mod in (jax_y4m, port_y4m):
            with pytest.raises(ValueError):
                mod.Y4MReader(io.BytesIO(header))


# --- the native host library (native/*.cpp, built at first use) -------------

def test_native_library_builds_from_its_own_sources(tmp_path, monkeypatch):
    from mpv_frame_interpolator_tpu_torch import native
    assert native.NATIVE_DIR == REPO / "mpv_frame_interpolator_tpu_torch" \
        / "native"
    cmd = native.command("g++", Path("/tmp/_mfi_native.so"))
    sources = [Path(a) for a in cmd if a.endswith(".cpp")]
    assert all(s.parent == native.NATIVE_DIR and s.exists()
               for s in sources)
    assert sorted(s.name for s in sources) == sorted(
        p.name for p in native.NATIVE_DIR.glob("*.cpp"))
    assert cmd[0] == "g++" and cmd[-2:] == ["-o", "/tmp/_mfi_native.so"]
    for flag in ("-O3", "-std=c++17", "-Wall", "-pthread", "-shared",
                 "-fPIC", f"-I{native.python_include()}"):
        assert flag in cmd
    # one directory per hash of the sources and the command line
    d = native.build_dir()
    assert d.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parts[-2:] == ("build", "mfi_torch_native")
    assert d == native.build_dir() != native.build_dir("clang++")
    copy = tmp_path / "native"
    copy.mkdir()
    for s in sources:
        (copy / s.name).write_bytes(s.read_bytes())
    monkeypatch.setattr(native, "NATIVE_DIR", copy)
    assert native.build_dir() == d
    with open(copy / "ffv1.cpp", "a") as fh:
        fh.write("\n")
    assert native.build_dir() != d


_IMPORT_BUILDS_NOTHING = r"""
import pkgutil, subprocess, sys
import torch
calls = []
real = subprocess.Popen.__init__


def spy(self, *a, **k):
    calls.append(a[0] if a else k.get("args"))
    return real(self, *a, **k)


subprocess.Popen.__init__ = spy
import mpv_frame_interpolator_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith("__main__"):
        __import__(m.name)
from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
assert calls == [], calls
assert native.load.cache_info().currsize == 0
assert _build.load.cache_info().currsize == 0
assert not [m for m in sys.modules if m.endswith("_mfi_native")]
print("NOTHING BUILT")
"""


def test_importing_the_port_builds_nothing():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_BUILDS_NOTHING],
                          env=env, capture_output=True, text=True,
                          timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("NOTHING BUILT")


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """The compiler pointed at /bin/false: the build raises with the
    command, no library appears, and nothing falls back to the Python
    codecs -- they run only where the caller asks for them."""
    from mpv_frame_interpolator_tpu_torch import native
    from mpv_frame_interpolator_tpu_torch.io import ffv1, jpeg, utvideo
    with pytest.raises(native.NativeBuildError, match="/bin/false"):
        native.build("/bin/false", root=tmp_path)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("CXX", "/bin/false")
    assert native.compiler() == "/bin/false"
    with pytest.raises(native.NativeBuildError):
        native.build(root=tmp_path / "env")

    def broken():
        raise native.NativeBuildError("no library")

    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(native.NativeBuildError):
        ffv1.FFV1Decoder(16, 16)
    with pytest.raises(native.NativeBuildError):
        jpeg.decode_jpeg_planes(b"\xff\xd8")
    with pytest.raises(native.NativeBuildError):
        utvideo.decode_planes(b"", "ULY0", 16, 16, 1)
    with pytest.raises(native.NativeBuildError):
        native.interleave_chroma_into(np.zeros((2, 2), np.uint8),
                                      np.zeros((2, 2), np.uint8),
                                      np.zeros((2, 4), np.uint8))
    ffv1.FFV1Decoder(16, 16, use_native=False)     # the plain version
