#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the port's CUDA kernels from ``mpv_frame_interpolator_tpu_torch/
   csrc`` with nvcc, one process per source, all started together (timed,
   with ptxas' resource report);
3. each kernel against its plain PyTorch version on the card, at the 4K
   shapes of the paths below, inputs made from a numpy seed: bit-exact,
   with the median times of both (CUDA events) -- K1, K2, K3 at 8 bits;
   K1 on uint16 planes with luma_shift 8; K2 with scale_shift 8 and
   levels (16, 235); K4 at 8 bits and at P010, default and non-default
   levels, t in {0, 0.4, 1};
4. the engine on the card against the engine on the CPU (the plain
   versions) on small clips at radius 5 and 16, scene cuts among them:
   8-bit NV12 under the "pair" sampler, and P010 with levels (16.5, 235)
   under "pair" and "fused": every output frame and pts equal;
5. the 8-bit main path end to end through the port's CLI at 3840x2160,
   24 -> 120 fps, radius 16: the output count must match the cadence,
   the launch counters of K1, K2 and K3 must move during that run and no
   plain version's may, the y4m must hold that many 4K frames, and the
   scene cut must never fire on the smooth clip; then the engine's rate
   with frames staged on the card;
6. the P010 path end to end through the CLI at the same shape with
   ``--p010 --warp-sampling fused --black-level 16 --white-level 235``:
   the counters of K1, K3 and K4 must move, K2's must not (the fused
   sampler replaces it) and no plain version's may.

Each path's counters are set to 0 just before it runs and read just
after.  The port against the NumPy oracle on the card is a test:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.

The second-to-last line is a JSON object with one entry per kernel (its
launches on its path, its error against the plain version, its time,
the plain version's, and the least time the card could take for the same
work); the last line is ``{"ok": true, "device": {...}}``.  Without a card
(or run outside a checkout of the repository) the script exits non-zero
and prints no result.
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

# the least time the card could take: bytes each read or written once
# over the H100 SXM's HBM rate, or operations over its peak rate for
# scalar (non-tensor-core) arithmetic, whichever is longer -- NVIDIA's
# published figures for the part at its full 700 W
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


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


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by) for work that moves `nbytes` and does `ops`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def max_abs_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def max_err(got, want) -> int:
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def block_field(rng, lh: int, lw: int, rep: int, values: int, lim: int):
    """(lh, lw) int32 field, constant on rep x rep blocks, drawn from a
    few values in [-lim, lim] (what a committed flow field looks like)."""
    vals = rng.integers(-lim, lim + 1, values)
    pick = rng.integers(0, values, (-(-lh // rep), -(-lw // rep)))
    return vals[pick].repeat(rep, 0).repeat(rep, 1)[:lh, :lw].astype(
        np.int32)


def random_planes(rng, dev, dt):
    """Random 4K luma and interleaved chroma planes of dtype dt, and the
    chroma split into planar u and v."""
    hi = 1 << (8 * np.dtype(dt).itemsize)
    y = torch.from_numpy(rng.integers(0, hi, (H4K, W4K)).astype(dt)).to(dev)
    uv = torch.from_numpy(rng.integers(0, hi, (H4K // 2, W4K)).astype(
        dt)).to(dev)
    return y, uv, uv[:, 0::2].contiguous(), uv[:, 1::2].contiguous()


def phase_flow_step(dev, rng, geom, dt, luma_shift: int):
    """K1 at 4K: single steps over (window, neighbour bias, axis, radius),
    then the whole 16-step radius-16 pyramid; returns the result entry."""
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    lh, lw, rs = geom.low_h, geom.low_w, geom.res_scalar
    f1y, _, f1u, f1v = random_planes(rng, dev, dt)
    f2y, _, f2u, f2v = random_planes(rng, dev, dt)
    probe = F.subsampled_f2(geom, f2y, f2u, f2v)
    tag = f"{np.dtype(dt).name} luma_shift={luma_shift}"
    err = 0
    cases = [(256, False, 0, 16), (128, False, 1, 5), (32, False, 0, 16),
             (16, True, 1, 16), (8, True, 0, 5), (4, True, 1, 16),
             (2, True, 0, 16), (1, True, 1, 5)]
    for window, nb, is_y, radius in cases:
        ox = torch.from_numpy(block_field(rng, lh, lw, window, 6, 64)).to(dev)
        oy = torch.from_numpy(block_field(rng, lh, lw, window, 6, 64)).to(dev)
        args = (f1y, f1u, f1v, *probe, ox, oy, is_y, radius, 8, 6, window,
                nb, rs, geom.height, geom.stride, luma_shift)
        e = max_err(KS.flow_step(*args), KS.flow_step_plain(*args))
        log(f"  K1 {tag} window={window} nb={nb} is_y={is_y} "
            f"radius={radius}: max_abs_err={e}")
        err = max(err, e)

    def pyramid(step):
        ox = torch.zeros((lh, lw), dtype=torch.int32, device=dev)
        oy = torch.zeros_like(ox)
        for it, window in enumerate(geom.window_schedule()):
            for is_y in (0, 1):
                ox, oy = step(f1y, f1u, f1v, *probe, ox, oy, is_y, 16, 8, 6,
                              window, it >= F.FIRST_NEIGHBOR_ITERATION, rs,
                              geom.height, geom.stride, luma_shift)
        return ox, oy

    e = max_err(pyramid(KS.flow_step), pyramid(KS.flow_step_plain))
    log(f"  K1 {tag} whole radius-16 pyramid ({2 * geom.iterations} "
        f"steps): max_abs_err={e}")
    steps = 2 * geom.iterations
    # per radius-16 step: each candidate reads three gathered samples
    # (at most radius * lh * lw distinct ones a plane), the probe and the
    # field, and writes the stepped axis; ~35 integer operations each
    # (three |differences|, shifts, the offset and neighbour biases,
    # mirrored coordinates)
    item = np.dtype(dt).itemsize
    cand = 16 * lh * lw
    gathered = (min(f1y.numel(), cand) + min(f1u.numel(), cand)
                + min(f1v.numel(), cand)) * item
    nbytes = gathered + 3 * lh * lw * item + 3 * lh * lw * 4
    return dict(max_abs_err=max(err, e),
                ms=cuda_ms(lambda: pyramid(KS.flow_step), 10) / steps,
                plain_ms=cuda_ms(lambda: pyramid(KS.flow_step_plain), 3)
                / steps,
                bound=bound(nbytes, 35 * cand))


def warp_bound(n: int, item: int):
    """Bytes and operations of n blended 4K outputs (luma + chroma): the
    two source frames read once, the outputs written once; ~30 scalar
    operations per output sample (four products, four roundings, four
    mirrors, the blend and the level map)."""
    out = n * (H4K + H4K // 2) * W4K
    nbytes = 2 * (H4K + H4K // 2) * W4K * item + out * item
    return bound(nbytes, 30 * out)


def phase_kernels(dev):
    """Phase 3: every kernel vs its plain version at the 4K shapes."""
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops import warp as W
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW

    rng = np.random.default_rng(SEED)
    geom = F.FlowGeometry.create(H4K, W4K, W4K)
    lh, lw, rs = geom.low_h, geom.low_w, geom.res_scalar
    log(f"4K geometry: {geom}")
    results = {}

    results["flow_step"] = phase_flow_step(dev, rng, geom, np.uint8, 0)
    p010 = phase_flow_step(dev, rng, geom, np.uint16, 8)
    results["flow_step"]["max_abs_err"] = max(
        results["flow_step"]["max_abs_err"], p010["max_abs_err"])
    results["flow_step"]["p010"] = p010

    # K3
    off = torch.from_numpy(rng.integers(-300, 301, (2, lh, lw)).astype(
        np.int32)).to(dev)
    e = max_abs_err(KB.blur_flow(off), KB.blur_flow_plain(off))
    log(f"  K3 (2, {lh}, {lw}): max_abs_err={e}")
    results["blur_flow"] = dict(
        max_abs_err=e, ms=cuda_ms(lambda: KB.blur_flow(off), 50),
        plain_ms=cuda_ms(lambda: KB.blur_flow_plain(off), 20),
        # the field read and written once; 64 taps summed per output
        bound=bound(2 * off.numel() * 4, 66 * off.numel()))

    blurred = torch.from_numpy(np.stack([
        block_field(rng, lh, lw, 8, 12, 96),
        block_field(rng, lh, lw, 8, 12, 96)])).to(dev)
    frames = {dt: (random_planes(rng, dev, dt), random_planes(rng, dev, dt))
              for dt in (np.uint8, np.uint16)}

    def warp_args(dt):
        (f1y, f1uv, _, _), (f2y, f2uv, _, _) = frames[dt]
        return (f1y, f1uv, f2y, f2uv, blurred)

    # K2: the five blend positions of a 24 -> 120 pair, 8-bit at the
    # default levels (the main path) and P010 with levels (16, 235)
    ts = torch.tensor([0.0, 0.2, 0.4, 0.6, 0.8], dtype=torch.float32,
                      device=dev)
    k2 = {}
    for dt, ss, levels in ((np.uint8, 0, (0, 255)),
                           (np.uint16, 8, W.level_ints(16, 235))):
        args = (*warp_args(dt), ts, rs, geom.actual_width, ss, levels)
        e = max_err(KW.pair_blend(*args), KW.pair_blend_plain(*args))
        log(f"  K2 N=5 {W4K}x{H4K} scale_shift={ss} levels={levels}: "
            f"max_abs_err={e}")
        k2[ss] = dict(max_abs_err=e,
                      ms=cuda_ms(lambda: KW.pair_blend(*args), 20),
                      plain_ms=cuda_ms(lambda: KW.pair_blend_plain(*args),
                                       5),
                      bound=warp_bound(5, np.dtype(dt).itemsize))
    results["pair_blend"] = dict(k2[0], max_abs_err=max(
        k2[0]["max_abs_err"], k2[8]["max_abs_err"]), p010=k2[8])

    # K4: one blend position, 8-bit and P010, default and TV levels
    k4 = {}
    err = 0
    for dt, ss in ((np.uint8, 0), (np.uint16, 8)):
        for levels in ((0, 255), W.level_ints(16, 235)):
            for t in (0.0, 0.4, 1.0):
                tt = torch.tensor(t, dtype=torch.float32, device=dev)
                args = (*warp_args(dt), tt, rs, geom.actual_width, ss,
                        levels)
                e = max_err(KF.fused_blend(*args),
                            KF.fused_blend_plain(*args))
                log(f"  K4 {W4K}x{H4K} scale_shift={ss} levels={levels} "
                    f"t={t}: max_abs_err={e}")
                err = max(err, e)
                if t == 0.4:
                    k4[(ss, levels)] = dict(
                        ms=cuda_ms(lambda: KF.fused_blend(*args), 20),
                        plain_ms=cuda_ms(
                            lambda: KF.fused_blend_plain(*args), 5),
                        bound=warp_bound(1, np.dtype(dt).itemsize))
    main = k4[(8, W.level_ints(16, 235))]
    results["fused_blend"] = dict(
        main, max_abs_err=err,
        nv12=k4[(0, (0, 255))])
    for key, r in sorted(k4.items()):
        log(f"  K4 scale_shift={key[0]} levels={key[1]} t=0.4: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")

    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"max_abs_err {r['max_abs_err']}")
        if "p010" in r:
            q = r["p010"]
            log(f"  {name} P010: kernel {q['ms']:.4f} ms, plain "
                f"{q['plain_ms']:.4f} ms, bound {q['bound'][0]:.4f} ms "
                f"({q['bound'][1]})")
        check(r["max_abs_err"] == 0, f"{name} disagrees with its plain "
              f"version (max_abs_err {r['max_abs_err']})")
    return results


def synthetic_frames(name: str, width: int, height: int, frames: int,
                     p010: bool = False):
    """Source frames of a synthetic clip, made by the port's CLI."""
    from mpv_frame_interpolator_tpu_torch import cli
    args = cli.build_parser().parse_args(
        [f"synthetic:{name}", "--width", str(width), "--height",
         str(height), "--fps", "24", "--frames", str(frames)]
        + (["--p010"] if p010 else []))
    return list(cli.make_source(args)[0])


def phase_reference(dev):
    """Phase 4: the engine on the card against the engine on the CPU (the
    plain versions, which the CPU tests hold bit-exact against the JAX
    package) on small clips: every output frame and pts equal."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)

    # (clip, width, height, radius, display fps, P010, sampler, levels):
    # res scalars 0 and 1, a width that is not a multiple of a warp, scene
    # cuts, 8-bit and P010, both samplers, levels that round half to even
    tv = (16.5, 235.0)
    for name, w, h, radius, display, p010, sampling, levels in [
            ("gradient_pan", 320, 180, 5, 120.0, False, "pair", (0, 255)),
            ("moving_box", 640, 360, 16, 120.0, False, "pair", (0, 255)),
            ("moving_box", 202, 118, 16, 60.0, False, "pair", (0, 255)),
            ("scene_cut", 320, 180, 16, 60.0, False, "pair", (0, 255)),
            ("moving_box", 202, 118, 16, 120.0, True, "fused", tv),
            ("scene_cut", 320, 180, 16, 60.0, True, "pair", tv),
            ("scene_cut", 320, 180, 16, 60.0, True, "fused", tv)]:
        t0 = time.perf_counter()
        engines = [InterpolationEngine(EngineConfig(
            display_fps=display, auto_quality=False,
            initial_search_radius=radius, warp_sampling=sampling,
            black_level=levels[0], white_level=levels[1], device=d))
            for d in ("cpu", str(dev))]
        n = 0
        what = (f"{name} {w}x{h} {'P010' if p010 else 'NV12'} {sampling} "
                f"levels {levels} radius {radius}")
        for frame in synthetic_frames(name, w, h, 7, p010):
            outs = [e.push(frame) for e in engines]
            check(len(outs[0]) == len(outs[1]),
                  f"{what}: output counts differ on the card and the CPU")
            for a, b in zip(*outs):
                fa, fb = a.to_video_frame(), b.to_video_frame()
                check(a.pts == b.pts and np.array_equal(fa.y, fb.y)
                      and np.array_equal(fa.uv, fb.uv),
                      f"{what}: output at pts {a.pts} differs between the "
                      "card and the CPU")
                check(fb.y.shape == (h, w) and fb.uv.shape == (h // 2, w),
                      f"{what}: output planes {fb.y.shape} {fb.uv.shape}")
                check(fb.y.dtype == (np.uint16 if p010 else np.uint8),
                      f"{what}: output dtype {fb.y.dtype}")
                n += 1
        cuts = [e.scene_cuts() for e in engines]
        check(cuts[0] == cuts[1], f"{what}: scene cuts differ: {cuts}")
        if name != "gradient_pan":
            check((cuts[1] > 0) == (name == "scene_cut"),
                  f"{what}: {cuts[1]} scene cuts")
        log(f"  {what} -> {display:g} fps: {n} outputs equal, scene cuts "
            f"{cuts[1]} ({time.perf_counter() - t0:.1f} s)")


def y4m_frames(path: str):
    """(width, height, frame count) of a 4:2:0 y4m file (8-bit or
    C420p10), counted by its FRAME headers; fails on a truncated or
    malformed frame."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        header = fh.readline().split()
        check(header[:1] == [b"YUV4MPEG2"], "output is not a y4m stream")
        fields = {t[:1]: t[1:] for t in header[1:]}
        w, h = int(fields[b"W"]), int(fields[b"H"])
        cs = fields.get(b"C", b"420")
        check(cs.startswith(b"420"), f"output chroma {cs} is not 4:2:0")
        item = 2 if cs == b"420p10" else 1
        n = 0
        while fh.tell() < size:
            check(fh.readline().startswith(b"FRAME"),
                  f"frame {n}: no FRAME header")
            fh.seek(w * h * 3 // 2 * item, os.SEEK_CUR)
            n += 1
        check(fh.tell() == size, f"frame {n - 1} is truncated")
    return w, h, n


def kernel_counts():
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
    return {"flow_step": KS.counts, "blur_flow": KB.counts,
            "pair_blend": KW.counts, "fused_blend": KF.counts}


def run_cli(dev, frames: int, extra):
    """The port's CLI at 4K 24 -> 120, radius 16, y4m sink, with every
    launch counter set to 0 just before and read just after; returns
    (launches, plain calls, stats, y4m (w, h, frames, bytes), wall)."""
    from mpv_frame_interpolator_tpu_torch import cli
    counts = kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.y4m")
        stats_path = os.path.join(tmp, "stats.json")
        argv = ["synthetic:moving_box", "--width", str(W4K), "--height",
                str(H4K), "--fps", "24", "--frames", str(frames),
                "--display-fps", "120", "--search-radius", "16",
                "--no-auto-quality", "--untimed", "--device", str(dev),
                "-o", out, "--dump-stats", stats_path, *extra]
        for c in counts.values():
            c.reset()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launches = {k: c.kernel for k, c in counts.items()}
        plain = {k: c.plain for k, c in counts.items()}
        with open(stats_path) as fh:
            stats = json.load(fh)
        y4m = (*y4m_frames(out), os.path.getsize(out))
    check(rc == 0, f"cli returned {rc}")
    # the first source frame passes through; at 24 -> 120 every later one
    # gives the 5 outputs of its pair
    expected = 1 + 5 * (frames - 1)
    pair = stats["stats"].get("source_frame_time", {})
    log(f"  cli {' '.join(extra) or '(defaults)'}: {stats['frames_in']} "
        f"source -> {stats['frames_out']} output frames (cadence expects "
        f"{expected}) in {wall:.2f} s wall = "
        f"{stats['frames_out'] / wall:.1f} out-fps (y4m sink, {y4m[2]} "
        f"frames of {y4m[0]}x{y4m[1]}, {y4m[3]} bytes)")
    log(f"  per-pair calc time (CUDA events, enqueue to completion, pairs "
        f"2..): mean {pair.get('mean', 0) * 1e3:.3f} ms, p50 "
        f"{pair.get('p50', 0) * 1e3:.3f} ms, p99 "
        f"{pair.get('p99', 0) * 1e3:.3f} ms over {pair.get('count', 0)}")
    log(f"  launches {launches}, plain calls {plain}, scene cuts "
        f"{stats['scene_cuts']}")
    check(stats["frames_out"] == expected,
          f"{stats['frames_out']} outputs, cadence expects {expected}")
    check(y4m[2] == expected, f"the y4m holds {y4m[2]} frames")
    check(y4m[:2] == (W4K, H4K), f"the y4m is {y4m[0]}x{y4m[1]}")
    check(not any(plain.values()),
          f"a plain version ran on the path: {plain}")
    check(stats["scene_cuts"] == 0, "scene cut fired on a smooth clip")
    return launches


def phase_main_path(dev):
    """Phase 5: the 8-bit main path, CLI at 4K 24 -> 120, radius 16."""
    launches = run_cli(dev, 8, [])
    on_path = ("flow_step", "blur_flow", "pair_blend")
    check(all(launches[k] > 0 for k in on_path),
          f"a kernel of the main path never launched: {launches}")
    check(launches["fused_blend"] == 0, "K4 ran on the pair sampler's path")
    return launches


def phase_p010_path(dev):
    """Phase 6: P010 with TV levels on the fused sampler, CLI at 4K."""
    launches = run_cli(dev, 4, ["--p010", "--warp-sampling", "fused",
                                "--black-level", "16", "--white-level",
                                "235"])
    on_path = ("flow_step", "blur_flow", "fused_blend")
    check(all(launches[k] > 0 for k in on_path),
          f"a kernel of the P010 fused path never launched: {launches}")
    check(launches["pair_blend"] == 0,
          f"K2 ran on the fused sampler's path: {launches}")
    return launches


def phase_engine_rate(dev, p010: bool = False, sampling: str = "pair"):
    """Steady-state engine throughput at 4K 24 -> 120, radius 16, frames
    pre-staged on the card, each pair synchronised (no sink)."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    levels = (16, 235) if p010 else (0, 255)
    eng = InterpolationEngine(EngineConfig(
        display_fps=120.0, auto_quality=False, initial_search_radius=16,
        warp_sampling=sampling, black_level=levels[0],
        white_level=levels[1], device=str(dev)))
    staged = [eng.stage(f)
              for f in synthetic_frames("moving_box", W4K, H4K, 12, p010)]
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
    log(f"  engine {'P010' if p010 else 'NV12'} {sampling} levels "
        f"{levels}: {pairs} pairs, {n} outputs in {dt * 1e3:.1f} ms = "
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
    main_launches = phase_main_path(dev)
    phase_engine_rate(dev)
    log("phase 6: P010 fused path end to end (cli, 4K 24->120, radius 16, "
        "levels 16/235)")
    p010_launches = phase_p010_path(dev)
    phase_engine_rate(dev, p010=True, sampling="fused")

    # each kernel's launches on the path it serves: K1-K3 on the 8-bit
    # main path, K4 on the P010 fused path
    sources = {"flow_step": ("flow_step.cu", "flow_step.py:350",
                             main_launches),
               "blur_flow": ("blur.cu", "blur.py:41", main_launches),
               "pair_blend": ("warp_pair.cu", "warp_pair.py:189",
                              main_launches),
               "fused_blend": ("warp_fused.cu", "warp_fused.py:188",
                               p010_launches)}
    kernels = []
    for name, (src, replaces, launches) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpv_frame_interpolator_tpu_torch/csrc/{src}",
            "replaces": f"mpv_frame_interpolator_tpu/ops/pallas/{replaces}",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            # no single PyTorch call computes any of these functions (mod
            # 2^32 window sums with an unsigned argmin, mirrored nearest
            # gathers with the fixed-point blend, a symmetric-pad integer
            # blur truncated toward zero)
            "library_ms": None})
    log(f"launches on the 8-bit main path {main_launches}, on the P010 "
        f"fused path {p010_launches}")
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
