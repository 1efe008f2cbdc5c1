"""Package-level properties of the port: it never imports jax (or triton)
and touches no CUDA state on its CPU path, its kernels build from its own
sources for sm_90a, its wrappers never fall back to the plain version for
a tensor that is not on the CPU, and what carries across from the JAX
package (config, geometry, frames) carries across unchanged."""

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

from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops import flow as jax_flow
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch import convert
from mpv_frame_interpolator_tpu_torch.ops import flow as port_flow
from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine

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


_SMOKE_IMPORTS = {"__future__", "json", "os", "statistics", "subprocess",
                  "sys", "tempfile", "time", "numpy", "torch",
                  "mpv_frame_interpolator_tpu_torch"}


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
    cmd = _build.nvcc_command("nvcc", Path("/tmp/lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--fmad=false" in cmd and "-shared" in cmd
    sources = [Path(a) for a in cmd if a.endswith(".cu")]
    assert sources and all(s.parent == _build.CSRC_DIR for s in sources)
    assert sorted(s.name for s in sources) == sorted(
        p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert all(s.exists() for s in sources)


def test_build_directory_is_keyed_by_the_sources():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT
    assert _build.BUILD_ROOT.parts[-2] == "build"
    assert d == _build.build_dir()


@pytest.mark.parametrize("call", ["flow_step", "blur_flow", "pair_blend"])
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
    else:
        counts, fn = KW.counts, KW.pair_blend
        u8 = lambda *s: torch.empty(s, dtype=torch.uint8, **meta)  # noqa
        args = (u8(48, 64), u8(24, 64), u8(48, 64), u8(24, 64),
                torch.empty((2, 48, 64), dtype=torch.int32, **meta),
                torch.empty((2,), dtype=torch.float32, **meta), 0, 64)
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
                     warp_sampling="shift", layer_buckets=(16,))):
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


@pytest.mark.parametrize("kw,err", [
    (dict(frame_output_mode=0), NotImplementedError),
    (dict(model="hopperx"), NotImplementedError),
    (dict(white_level=200.0), NotImplementedError),
    (dict(subpel_flow=True), NotImplementedError),
    (dict(split_timing="always"), NotImplementedError),
    (dict(degrade_rungs=()), NotImplementedError)])
def test_engine_config_from_jax_rejects(kw, err):
    mapping = dataclasses.asdict(jax_engine.EngineConfig(**kw))
    with pytest.raises(err):
        convert.engine_config_from_jax(mapping)


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
