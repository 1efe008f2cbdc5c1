#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the port's CUDA kernels from ``mpv_frame_interpolator_tpu_torch/
   csrc`` with nvcc (timed, with ptxas' resource report);
3. each kernel against its plain PyTorch version on the card, at the main
   path's 4K shapes, inputs made from a numpy seed: bit-exact, with the
   median times of both (CUDA events);
4. the engine on the card against the engine on the CPU (the plain
   versions) on small clips at radius 5 and 16, a scene cut among them:
   every output frame and pts equal;
5. the main path end to end through the port's CLI at 3840x2160, 24 ->
   120 fps, radius 16: the output count must match the cadence, every
   kernel's launch counter must move during that run and no plain
   version's may, the y4m must hold that many 4K frames, and the scene
   cut must never fire on the smooth clip.

The port against the NumPy oracle on the card is a test:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a card (or run
outside a checkout of the repository) the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W4K, H4K = 3840, 2160
SEED = 20261016


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of fn() in ms between two CUDA events, one call at a
    time: the card's work plus the host's cost of launching it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def block_field(rng, lh: int, lw: int, rep: int, values: int, lim: int):
    """(lh, lw) int32 field, constant on rep x rep blocks, drawn from a
    few values in [-lim, lim] (what a committed flow field looks like)."""
    vals = rng.integers(-lim, lim + 1, values)
    pick = rng.integers(0, values, (-(-lh // rep), -(-lw // rep)))
    return vals[pick].repeat(rep, 0).repeat(rep, 1)[:lh, :lw].astype(
        np.int32)


def phase_kernels(dev):
    """Phase 3: kernel vs plain version at the 4K main-path shapes."""
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW

    rng = np.random.default_rng(SEED)
    geom = F.FlowGeometry.create(H4K, W4K, W4K)
    lh, lw, rs = geom.low_h, geom.low_w, geom.res_scalar
    log(f"4K geometry: {geom}")

    def planes():
        y = rng.integers(0, 256, (H4K, W4K), dtype=np.uint8)
        uv = rng.integers(0, 256, (H4K // 2, W4K), dtype=np.uint8)
        return (torch.from_numpy(y).to(dev), torch.from_numpy(uv).to(dev))

    f1y, f1uv = planes()
    f2y, f2uv = planes()
    f1u, f1v = f1uv[:, 0::2].contiguous(), f1uv[:, 1::2].contiguous()
    f2u, f2v = f2uv[:, 0::2].contiguous(), f2uv[:, 1::2].contiguous()
    probe = F.subsampled_f2(geom, f2y, f2u, f2v)
    results = {}

    # K1: single steps over the (window, neighbour bias, axis, radius)
    # cases, then the whole 16-step radius-16 pyramid
    err = 0
    cases = [(256, False, 0, 16), (128, False, 1, 5), (32, False, 0, 16),
             (16, True, 1, 16), (8, True, 0, 5), (4, True, 1, 16),
             (2, True, 0, 16), (1, True, 1, 5)]
    for window, nb, is_y, radius in cases:
        ox = torch.from_numpy(block_field(rng, lh, lw, window, 6, 64)).to(dev)
        oy = torch.from_numpy(block_field(rng, lh, lw, window, 6, 64)).to(dev)
        args = (f1y, f1u, f1v, *probe, ox, oy, is_y, radius, 8, 6, window,
                nb, rs, geom.height, geom.stride)
        got = KS.flow_step(*args)
        want = KS.flow_step_plain(*args)
        e = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        log(f"  K1 window={window} nb={nb} is_y={is_y} radius={radius}: "
            f"max_abs_err={e}")
        err = max(err, e)

    def pyramid(step):
        ox = torch.zeros((lh, lw), dtype=torch.int32, device=dev)
        oy = torch.zeros_like(ox)
        for it, window in enumerate(geom.window_schedule()):
            for is_y in (0, 1):
                ox, oy = step(f1y, f1u, f1v, *probe, ox, oy, is_y, 16, 8, 6,
                              window, it >= F.FIRST_NEIGHBOR_ITERATION, rs,
                              geom.height, geom.stride)
        return ox, oy

    got, want = pyramid(KS.flow_step), pyramid(KS.flow_step_plain)
    e = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    log(f"  K1 whole radius-16 pyramid ({2 * geom.iterations} steps): "
        f"max_abs_err={e}")
    err = max(err, e)
    steps = 2 * geom.iterations
    results["flow_step"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: pyramid(KS.flow_step), 10) / steps,
        plain_ms=cuda_ms(lambda: pyramid(KS.flow_step_plain), 3) / steps)

    # K3
    off = torch.from_numpy(rng.integers(-300, 301, (2, lh, lw)).astype(
        np.int32)).to(dev)
    e = max_abs_err(KB.blur_flow(off), KB.blur_flow_plain(off))
    log(f"  K3 (2, {lh}, {lw}): max_abs_err={e}")
    results["blur_flow"] = dict(
        max_abs_err=e, ms=cuda_ms(lambda: KB.blur_flow(off), 50),
        plain_ms=cuda_ms(lambda: KB.blur_flow_plain(off), 20))

    # K2: the five blend positions of a 24 -> 120 pair
    blurred = torch.from_numpy(np.stack([
        block_field(rng, lh, lw, 8, 12, 96),
        block_field(rng, lh, lw, 8, 12, 96)])).to(dev)
    ts = torch.tensor([0.0, 0.2, 0.4, 0.6, 0.8], dtype=torch.float32,
                      device=dev)
    args = (f1y, f1uv, f2y, f2uv, blurred, ts, rs, geom.actual_width)
    got, want = KW.pair_blend(*args), KW.pair_blend_plain(*args)
    e = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    log(f"  K2 N=5 {W4K}x{H4K}: max_abs_err={e}")
    results["pair_blend"] = dict(
        max_abs_err=e, ms=cuda_ms(lambda: KW.pair_blend(*args), 20),
        plain_ms=cuda_ms(lambda: KW.pair_blend_plain(*args), 5))

    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, max_abs_err {r['max_abs_err']}")
        check(r["max_abs_err"] == 0, f"{name} disagrees with its plain "
              f"version (max_abs_err {r['max_abs_err']})")
    return results


def synthetic_frames(name: str, width: int, height: int, frames: int):
    """Source frames of a synthetic clip, made by the port's CLI."""
    from mpv_frame_interpolator_tpu_torch import cli
    args = cli.build_parser().parse_args(
        [f"synthetic:{name}", "--width", str(width), "--height",
         str(height), "--fps", "24", "--frames", str(frames)])
    return list(cli.make_source(args)[0])


def phase_reference(dev):
    """Phase 4: the engine on the card against the engine on the CPU (the
    plain versions, which the CPU tests hold bit-exact against the JAX
    package) on small clips: every output frame and pts equal."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)

    # (clip, width, height, radius, display fps): res scalars 0 and 1, a
    # width that is not a multiple of a warp, a scene cut
    for name, w, h, radius, display in [
            ("gradient_pan", 320, 180, 5, 120.0),
            ("moving_box", 640, 360, 16, 120.0),
            ("moving_box", 202, 118, 16, 60.0),
            ("scene_cut", 320, 180, 16, 60.0)]:
        t0 = time.perf_counter()
        engines = [InterpolationEngine(EngineConfig(
            display_fps=display, auto_quality=False,
            initial_search_radius=radius, device=d))
            for d in ("cpu", str(dev))]
        n = 0
        for frame in synthetic_frames(name, w, h, 7):
            outs = [e.push(frame) for e in engines]
            check(len(outs[0]) == len(outs[1]),
                  f"{name}: output counts differ on the card and the CPU")
            for a, b in zip(*outs):
                fa, fb = a.to_video_frame(), b.to_video_frame()
                check(a.pts == b.pts and np.array_equal(fa.y, fb.y)
                      and np.array_equal(fa.uv, fb.uv),
                      f"{name} {w}x{h} radius {radius}: output at pts "
                      f"{a.pts} differs between the card and the CPU")
                check(fb.y.shape == (h, w) and fb.uv.shape == (h // 2, w),
                      f"{name}: output planes {fb.y.shape} {fb.uv.shape}")
                n += 1
        cuts = [e.scene_cuts() for e in engines]
        check(cuts[0] == cuts[1], f"{name}: scene cuts differ: {cuts}")
        if name != "gradient_pan":
            check((cuts[1] > 0) == (name == "scene_cut"),
                  f"{name}: {cuts[1]} scene cuts")
        log(f"  {name} {w}x{h} radius {radius} -> {display:g} fps: {n} "
            f"outputs equal, scene cuts {cuts[1]} "
            f"({time.perf_counter() - t0:.1f} s)")


def y4m_frames(path: str):
    """(width, height, frame count) of a 4:2:0 y4m file, counted by its
    FRAME headers; fails on a truncated or malformed frame."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        header = fh.readline().split()
        check(header[:1] == [b"YUV4MPEG2"], "output is not a y4m stream")
        fields = {t[:1]: t[1:] for t in header[1:]}
        w, h = int(fields[b"W"]), int(fields[b"H"])
        check(fields.get(b"C", b"420").startswith(b"420"),
              f"output chroma {fields.get(b'C')} is not 4:2:0")
        n = 0
        while fh.tell() < size:
            check(fh.readline().startswith(b"FRAME"),
                  f"frame {n}: no FRAME header")
            fh.seek(w * h * 3 // 2, os.SEEK_CUR)
            n += 1
        check(fh.tell() == size, f"frame {n - 1} is truncated")
    return w, h, n


def phase_main_path(dev):
    """Phase 5: the port's CLI at 4K 24 -> 120, radius 16."""
    from mpv_frame_interpolator_tpu_torch import cli
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW

    frames, fps, display = 8, 24.0, 120.0
    # the first source frame passes through; at 24 -> 120 every later one
    # gives the 5 outputs of its pair
    expected = 1 + 5 * (frames - 1)

    counts = {"flow_step": KS.counts, "blur_flow": KB.counts,
              "pair_blend": KW.counts}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.y4m")
        stats_path = os.path.join(tmp, "stats.json")
        argv = ["synthetic:moving_box", "--width", str(W4K), "--height",
                str(H4K), "--fps", str(fps), "--frames", str(frames),
                "--display-fps", str(display), "--search-radius", "16",
                "--no-auto-quality", "--untimed", "--device", str(dev),
                "-o", out, "--dump-stats", stats_path]
        for c in counts.values():
            c.reset()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launches = {k: c.kernel for k, c in counts.items()}
        plain = {k: c.plain for k, c in counts.items()}
        with open(stats_path) as fh:
            stats = json.load(fh)
        w, h, written = y4m_frames(out)
        size = os.path.getsize(out)

    pair = stats["stats"].get("source_frame_time", {})
    log(f"  cli rc={rc}: {stats['frames_in']} source -> "
        f"{stats['frames_out']} output frames (cadence expects {expected}) "
        f"in {wall:.2f} s wall = {stats['frames_out'] / wall:.1f} out-fps "
        f"(y4m sink, {written} frames of {w}x{h}, {size} bytes)")
    log(f"  per-pair calc time (CUDA events, enqueue to completion, pairs "
        f"2..): mean {pair.get('mean', 0) * 1e3:.3f} ms, p50 "
        f"{pair.get('p50', 0) * 1e3:.3f} ms, p99 "
        f"{pair.get('p99', 0) * 1e3:.3f} ms over {pair.get('count', 0)}")
    log(f"  launches {launches}, plain calls {plain}, scene cuts "
        f"{stats['scene_cuts']}")
    check(rc == 0, f"cli returned {rc}")
    check(stats["frames_out"] == expected,
          f"{stats['frames_out']} outputs, cadence expects {expected}")
    check(written == expected, f"the y4m holds {written} frames")
    check((w, h) == (W4K, H4K), f"the y4m is {w}x{h}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(not any(plain.values()),
          f"a plain version ran on the main path: {plain}")
    check(stats["scene_cuts"] == 0, "scene cut fired on a smooth clip")
    return launches


def phase_engine_rate(dev):
    """Steady-state engine throughput at 4K 24 -> 120, radius 16, frames
    pre-staged on the card, each pair synchronised (no sink)."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    eng = InterpolationEngine(EngineConfig(
        display_fps=120.0, auto_quality=False, initial_search_radius=16,
        device=str(dev)))
    staged = [eng.stage(f)
              for f in synthetic_frames("moving_box", W4K, H4K, 12)]
    for f in staged[:3]:
        eng.push(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for f in staged[3:]:
        n += len(eng.push(f))
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pairs = len(staged) - 3
    log(f"  engine: {pairs} pairs, {n} outputs in {dt * 1e3:.1f} ms = "
        f"{dt / pairs * 1e3:.3f} ms/pair wall, {n / dt:.1f} out-fps")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke "
                         "test needs an NVIDIA card")
    from mpv_frame_interpolator_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.load()
    log(f"phase 2: built {_build.LIB_NAME} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "Used" in line or "Compiling" in line:
            log(f"  {line.strip()}")

    log("phase 3: kernels vs plain versions at 4K shapes")
    results = phase_kernels(dev)
    log("phase 4: engine on the card vs engine on the CPU, small clips")
    phase_reference(dev)
    log("phase 5: main path end to end (cli, 4K 24->120, radius 16)")
    launches = phase_main_path(dev)
    phase_engine_rate(dev)

    sources = {"flow_step": ("flow_step.cu",
                             "mpv_frame_interpolator_tpu/ops/pallas/"
                             "flow_step.py:350"),
               "blur_flow": ("blur.cu",
                             "mpv_frame_interpolator_tpu/ops/pallas/"
                             "blur.py:41"),
               "pair_blend": ("warp_pair.cu",
                              "mpv_frame_interpolator_tpu/ops/pallas/"
                              "warp_pair.py:189")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"mpv_frame_interpolator_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"]}
               for name, (src, replaces) in sources.items()]
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
