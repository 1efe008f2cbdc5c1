"""K1-K5, G1, Q1 and P1 on the card at their paths' 4K shapes, for
comparing two trees of the port in turns.

    python3 mpv_frame_interpolator_tpu_torch/profile_kernels.py \
        [--root TREE] [--label NAME] [--model NAME ...] [--warp]

Imports the port from TREE (default: the checkout this file is in), so one
copy of this script can measure an older tree (an unpacked ``git
archive``) and the current one in one run on one card.  Only entry
points that every tree of the port has are called: the flow step, the
pyramid (``flow_pyramid`` where the tree has it, else the loop of steps
from a zero field), ``ops/flow.flow``, ``blur_flow``, ``pair_blend``,
``fused_blend``, ``sample_dir``, ``tools.pack_probe.run_all`` and the
engine; an item that needs what the tree lacks (the blur phase of the
pyramid's launch, G1) is printed as absent.  Prints, with the card's
name and power limit:

* P1 (the toolchain probe of packed bytes): every probe of the tree's
  ``run_all`` on its inputs of seed 0, its launches, device ms and the
  host ms a call (50 enqueued);
* K1: device ms of the whole radius-16 pyramid of a 4K pair, its
  launches, and the host ms its wrapper calls take (50 pyramids
  enqueued with no synchronise between them); its resident blocks an
  SM (the occupancy API, where the tree has the query); the us of its
  phases inside the launch (the kernel's timeline, without the blur
  phase); device ms of one step at each window of the schedule;
* K1 at search radius 5, 8, 16, 24 and 64 (the instantiation the
  engine's default layer buckets pick; radii above 16 in 16-layer
  chunks): device ms of the pyramid and the us of its window sums (phase
  A) and commits (phase B) inside the launch, absent where the tree
  refuses the radius;
* the flow as the engine runs it (``ops/flow.flow``: the pyramid and its
  blur): device ms and launches a pair, and host ms (50 enqueued);
* S1 (the sub-pel refinement, where the tree has it): device ms on a 4K
  field of committed flows, 8-bit and P010; the sub-pel flow of a pair
  (one launch where K1 runs S1's phases, else K1 without its blur phase,
  S1 and the standalone blur): device ms, device rows and their us;
* K1's layer slice: one rank's device work of the layer-sharded flow of
  a pair at 16, 8 and 4 layers a slice without the collective (the
  tree's launches a step, and where a launch commits nothing, the host's
  stack, winner and commit), its device rows, and its wall ms a pair;
  the layer-sharded flow at world size 1 on nccl: device ms and wall ms
  a pair;
* K3: device ms of the standalone blur of a 4K field, and the us of the
  blur phase inside the pyramid's launch (its timeline stamp);
* K2: device ms of the five blend positions of a 4K pair, 8-bit at the
  default levels and P010 with levels (16, 235); 8-bit at N = 1..5
  positions (the first N of the pair's); its row band at one position
  (t = 0.4, 8-bit), the first band of a split into 1, 2 and 4 bands (ten
  launches a trace);
* K4: device ms of one 4K blend position, 8-bit at the default levels
  and P010 with levels (16, 235);
* K5: device ms of one 4K launch (direction 12, t = 0.4) at 8 bits and at
  P010, and of the ten launches of a "pallas" pair (both directions at
  the five positions, 8-bit);
* G1: device ms of one 4K position, 8-bit at the default levels and
  P010 with levels (16, 235), and the same with the occlusion correction
  (hopperx);
* Q1: device ms of one 4K bilinear position, 8-bit at the default
  levels with and without the occlusion correction (hopperxq, hopperq),
  and P010 with levels (16, 235) and the correction; and the same three
  with a sub-pel field (where the tree takes one); the 8-bit position on
  the per-sample step alone (``vector=False``, where the tree has it);
* the engine alone (frames staged on the card): at 8 bits, wall ms per
  pair with a synchronise after each pair, and device ms per pair and
  busy share under torch.profiler; device ms per pair and busy share on
  the P010 fused path (levels 16/235), in mode 0 (warp12), in mode 2
  under "pallas", in mode 3 (hsv), in mode 6 (sbs2), in mode 2 of
  each model family that --model names (default hopperx, hopperq,
  hopperxq and blend), at radius 5, with hopperq under subpel_flow, and
  on each rung of the default degradation ladder (levels 1-3); a path
  the tree refuses prints as absent.

With --warp only the warp kernels (K2 and its band, K4, K5, G1, Q1)
and the 8-bit and P010 fused engines are timed, with --k2 only K2 and
its band.

All flows are random blocks of 8 x 8 low-res cells within +-96.

Device ms is the sum of the device rows (kernels, memsets, copies) of a
torch.profiler trace of the call, opened with 64 spin kernels whose rows
are left out (a trace late in a process loses the device records it
takes first).  The last line is the same as JSON.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

W4K, H4K = 3840, 2160
SEED = 20261016


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_kernels", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="")
    p.add_argument("--model", action="append",
                   help="a model family whose mode-2 engine path to time "
                        "(repeatable)")
    p.add_argument("--warp", action="store_true",
                   help="time only the warp kernels and the 8-bit and P010 "
                        "fused engines")
    p.add_argument("--k2", action="store_true",
                   help="time only K2 and its row band")
    args = p.parse_args(argv)
    args.warp = args.warp or args.k2
    models = args.model or ["hopperx", "hopperq", "hopperxq", "blend"]
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: CUDA is not available")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from torch.profiler import ProfilerActivity, profile
    from mpv_frame_interpolator_tpu_torch import cli
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops import warp as W
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KD
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    from mpv_frame_interpolator_tpu_torch.profile_pair import self_device_us

    def device_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(self_device_us(e) for e in prof.key_averages()
                   if "spin" not in e.key) / 1e3 / reps

    def kernel_rows(fn):
        """{name: (count, device us)} of one call of fn's device rows."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: (e.count, self_device_us(e))
                for e in prof.key_averages() if self_device_us(e) > 0}

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(SEED)

    def planes(dt):
        hi = 1 << (8 * np.dtype(dt).itemsize)
        y = torch.from_numpy(rng.integers(0, hi, (H4K, W4K)).astype(dt))
        uv = torch.from_numpy(rng.integers(0, hi, (H4K // 2, W4K)).astype(dt))
        y, uv = y.to(dev), uv.to(dev)
        return y, uv, uv[:, 0::2].contiguous(), uv[:, 1::2].contiguous()

    geom = F.FlowGeometry.create(H4K, W4K, W4K)
    rs = geom.res_scalar
    out = {"label": args.label, "root": args.root, "card": smi}
    if not args.k2:
        from mpv_frame_interpolator_tpu_torch.tools import pack_probe as PP
        px = PP.make_inputs(0, dev)
        before = PP.counts.kernel
        PP.run_all(px)
        out["p1_launches"] = PP.counts.kernel - before
        out["p1_device_ms"] = device_ms(lambda: PP.run_all(px))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            PP.run_all(px)
        out["p1_host_ms"] = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
    f1y, f1uv, f1u, f1v = planes(np.uint8)
    f2y, f2uv, f2u, f2v = planes(np.uint8)
    probe = F.subsampled_f2(geom, f2y, f2u, f2v)
    windows = geom.window_schedule()
    zero = torch.zeros((geom.low_h, geom.low_w), dtype=torch.int32,
                       device=dev)
    steps = [(w, is_y, it >= F.FIRST_NEIGHBOR_ITERATION)
             for it, w in enumerate(windows) for is_y in (0, 1)]

    def pyramid():
        if hasattr(KS, "flow_pyramid"):
            return KS.flow_pyramid(f1y, f1u, f1v, *probe, 16, 8, 6, windows,
                                   F.FIRST_NEIGHBOR_ITERATION, rs,
                                   geom.height, geom.stride)
        ox, oy = zero, zero
        for w, is_y, nb in steps:
            ox, oy = KS.flow_step(f1y, f1u, f1v, *probe, ox, oy, is_y, 16, 8,
                                  6, w, nb, rs, geom.height, geom.stride)
        return ox, oy

    if not args.warp:
        before = KS.counts.kernel
        pyramid()
        out["k1_launches_per_pair"] = KS.counts.kernel - before
        out["k1_pyramid_device_ms"] = device_ms(pyramid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            pyramid()
        out["k1_host_ms_per_pair"] = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        n_steps = len(steps)
        out["k1_blocks_per_sm"] = (KS.blocks_per_sm(1)
                                   if hasattr(KS, "blocks_per_sm")
                                   else "absent")
        if hasattr(KS, "flow_pyramid"):
            stamps = torch.zeros((10, 2 + 2 * n_steps), dtype=torch.int64,
                                 device=dev)
            for row in stamps:
                KS.flow_pyramid(f1y, f1u, f1v, *probe, 16, 8, 6, windows,
                                F.FIRST_NEIGHBOR_ITERATION, rs, geom.height,
                                geom.stride, timeline=row)
            out["k1_phases_us"] = float((stamps[:, -1] - stamps[:, 0])
                                        .median()) / 1e3
        else:
            out["k1_phases_us"] = "absent"
        if hasattr(KS, "flow_pyramid") and \
                "blur" in inspect.signature(KS.flow_pyramid).parameters:
            stamps = torch.zeros((10, 3 + 2 * n_steps), dtype=torch.int64,
                                 device=dev)
            for row in stamps:
                KS.flow_pyramid(f1y, f1u, f1v, *probe, 16, 8, 6, windows,
                                F.FIRST_NEIGHBOR_ITERATION, rs, geom.height,
                                geom.stride, timeline=row, blur=True)
            d = stamps.diff(dim=1).median(dim=0).values
            out["k1_phases_before_blur_us"] = float(d[:-1].sum()) / 1e3
            out["k3_blur_phase_us"] = float(d[-1]) / 1e3
        else:
            out["k1_phases_before_blur_us"] = "absent"
            out["k3_blur_phase_us"] = "absent"

        def flow():
            return F.flow(geom, f1y, f1u, f1v, f2y, f2u, f2v, 16)

        before = KS.counts.kernel + KB.counts.kernel
        flow()
        out["flow_launches_per_pair"] = KS.counts.kernel + KB.counts.kernel \
            - before
        out["flow_device_ms"] = device_ms(flow)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            flow()
        out["flow_host_ms_per_pair"] = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        field = flow()[0]
        out["k3_standalone_device_ms"] = device_ms(
            lambda: KB.blur_flow(field))
        out["k1_step_device_ms"] = {
            w: device_ms(lambda w=w, nb=nb: [KS.flow_step(
                f1y, f1u, f1v, *probe, zero, zero, is_y, 16, 8, 6, w, nb, rs,
                geom.height, geom.stride) for is_y in (0, 1)]) / 2
            for w, _, nb in steps[::2]}

    blurred = torch.from_numpy(rng.integers(-96, 97, (2, geom.low_h,
                                                      geom.low_w)).astype(
        np.int32)).to(dev)
    blurred = blurred.repeat_interleave(8, 1).repeat_interleave(8, 2)[
        :, :geom.low_h, :geom.low_w].contiguous()
    ts = torch.tensor([0.0, 0.2, 0.4, 0.6, 0.8], dtype=torch.float32,
                      device=dev)
    out["k2_device_ms"] = device_ms(lambda: KW.pair_blend(
        f1y, f1uv, f2y, f2uv, blurred, ts, rs, W4K))
    g1y, g1uv, _, _ = planes(np.uint16)
    g2y, g2uv, _, _ = planes(np.uint16)
    out["k2_p010_device_ms"] = device_ms(lambda: KW.pair_blend(
        g1y, g1uv, g2y, g2uv, blurred, ts, rs, W4K, 8,
        W.level_ints(16, 235)))
    for n in range(1, 6):
        out[f"k2_n{n}_device_ms"] = device_ms(lambda n=n: KW.pair_blend(
            f1y, f1uv, f2y, f2uv, blurred, ts[:n], rs, W4K))
    for parts in (1, 2, 4):
        r0, r1 = KW.band_rows(H4K, parts)[0]
        out[f"k2_band{parts}_device_ms"] = device_ms(
            lambda r0=r0, r1=r1: [KW.pair_blend_rows(
                f1y, f1uv, f2y, f2uv, blurred, ts[2:3], rs, W4K, r0, r1)
                for _ in range(10)]) / 10
    if args.k2:
        return report(out)

    t = ts[2:3].reshape(())
    out["k4_device_ms"] = device_ms(lambda: KF.fused_blend(
        f1y, f1uv, f2y, f2uv, blurred, t, rs, W4K))
    out["k4_p010_device_ms"] = device_ms(lambda: KF.fused_blend(
        g1y, g1uv, g2y, g2uv, blurred, t, rs, W4K, 8,
        W.level_ints(16, 235)))
    out["k5_device_ms"] = device_ms(lambda: KD.sample_dir(
        f1y, f1uv, f2y, f2uv, blurred, t, 12, rs, W4K))
    out["k5_p010_device_ms"] = device_ms(lambda: KD.sample_dir(
        g1y, g1uv, g2y, g2uv, blurred, t, 12, rs, W4K))
    out["k5_pallas_pair_device_ms"] = device_ms(lambda: [
        KD.sample_dir(f1y, f1uv, f2y, f2uv, blurred, ts[i], d, rs, W4K)
        for i in range(5) for d in (12, 21)])
    try:
        from mpv_frame_interpolator_tpu_torch.ops.cuda import (
            blend_levels as KG)
    except ImportError:
        KG = None
    occlusion = KG is not None and \
        "occlusion" in inspect.signature(KG.blend_levels).parameters
    for key, y1, uv1, y2, uv2, ss, levels in (
            ("", f1y, f1uv, f2y, f2uv, 0, (0, 255)),
            ("_p010", g1y, g1uv, g2y, g2uv, 8, W.level_ints(16, 235))):
        if KG is None:
            out[f"g1{key}_device_ms"] = "absent"
        else:
            s12 = KD.sample_dir(y1, uv1, y2, uv2, blurred, t, 12, rs, W4K)
            s21 = KD.sample_dir(y1, uv1, y2, uv2, blurred, t, 21, rs, W4K)
            out[f"g1{key}_device_ms"] = device_ms(
                lambda: KG.blend_levels(*s12, *s21, t, ss, levels))
        out[f"g1_occlusion{key}_device_ms"] = device_ms(
            lambda: KG.blend_levels(*s12, *s21, t, ss, levels, True)) \
            if occlusion else "absent"
    try:
        from mpv_frame_interpolator_tpu_torch.ops.cuda import (
            warp_bilinear as KQ)
    except ImportError:
        KQ = None
        out["q1_device_ms"] = out["q1_occlusion_device_ms"] = \
            out["q1_occlusion_p010_device_ms"] = "absent"
    else:
        out["q1_device_ms"] = device_ms(lambda: KQ.bilinear_blend(
            f1y, f1uv, f2y, f2uv, blurred, t, rs, W4K))
        out["q1_occlusion_device_ms"] = device_ms(lambda: KQ.bilinear_blend(
            f1y, f1uv, f2y, f2uv, blurred, t, rs, W4K, 0, (0, 255), True))
        out["q1_occlusion_p010_device_ms"] = device_ms(
            lambda: KQ.bilinear_blend(g1y, g1uv, g2y, g2uv, blurred, t, rs,
                                      W4K, 8, W.level_ints(16, 235), True))

    def engine(p010=False, sampling="pair", mode=2, model="hopper",
               radius=16, subpel=False, level=0):
        """The engine alone on the moving box: (wall ms a pair with a
        synchronise after each, device ms a pair, busy share), or three
        times "absent" where the tree does not cover the path."""
        levels = (16, 235) if p010 else (0, 255)
        kw = {"model": model} if model != "hopper" else {}
        if subpel:
            kw["subpel_flow"] = True
        try:
            eng = InterpolationEngine(EngineConfig(
                display_fps=120.0, frame_output_mode=mode,
                auto_quality=False, initial_search_radius=radius,
                warp_sampling=sampling, black_level=levels[0],
                white_level=levels[1], device=str(dev), **kw))
        except (NotImplementedError, TypeError):
            return ("absent",) * 3
        if level:
            if not hasattr(eng, "_geoms"):
                return ("absent",) * 3
            eng.quality.level = level
        src = cli.make_source(cli.build_parser().parse_args(
            ["synthetic:moving_box", "--width", str(W4K), "--height",
             str(H4K), "--fps", "24", "--frames", "24"]
            + (["--p010"] if p010 else [])))[0]
        staged = [eng.stage(f) for f in src]
        for f in staged[:4]:
            eng.push(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in staged[4:14]:
            eng.push(f)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 10 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in staged[14:]:
                eng.push(f)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(self_device_us(e) for e in prof.key_averages()) / 1e3
        return wall_ms, busy / 10, busy / (wall * 1e3)

    (out["engine_wall_ms_per_pair"], out["engine_device_ms_per_pair"],
     out["engine_busy_share"]) = engine()
    _, out["engine_p010_fused_device_ms_per_pair"], \
        out["engine_p010_fused_busy_share"] = engine(True, "fused")
    if not args.warp:
        _, out["engine_mode0_device_ms_per_pair"], \
            out["engine_mode0_busy_share"] = engine(mode=0)
        _, out["engine_pallas_device_ms_per_pair"], \
            out["engine_pallas_busy_share"] = engine(sampling="pallas")
        _, out["engine_hsv_device_ms_per_pair"], \
            out["engine_hsv_busy_share"] = engine(mode=3)
        _, out["engine_sbs2_device_ms_per_pair"], \
            out["engine_sbs2_busy_share"] = engine(mode=6)
        for model in models:
            _, out[f"engine_{model}_device_ms_per_pair"], \
                out[f"engine_{model}_busy_share"] = engine(model=model)
        _, out["engine_r5_device_ms_per_pair"], \
            out["engine_r5_busy_share"] = engine(radius=5)
        _, out["engine_hopperq_subpel_device_ms_per_pair"], \
            out["engine_hopperq_subpel_busy_share"] = engine(model="hopperq",
                                                             subpel=True)
        for level in (1, 2, 3):
            _, out[f"engine_level{level}_device_ms_per_pair"], \
                out[f"engine_level{level}_busy_share"] = engine(radius=5,
                                                                level=level)

    if args.warp:
        return report(out)

    # the items this PR's tree added, after every item both trees have,
    # so that both run those in the same order on the same card state
    if KQ is not None and \
            "subpel" in inspect.signature(KQ.bilinear_blend).parameters:
        # the sub-pel flow's 1/64-pel field, (flow << 6) + frac
        field = (blurred << 6) + torch.from_numpy(rng.integers(
            0, 64, tuple(blurred.shape)).astype(np.int32)).to(dev)
        out["q1_frac_device_ms"] = device_ms(lambda: KQ.bilinear_blend(
            f1y, f1uv, f2y, f2uv, field, t, rs, W4K, subpel=True))
        out["q1_frac_occlusion_device_ms"] = device_ms(
            lambda: KQ.bilinear_blend(f1y, f1uv, f2y, f2uv, field, t,
                                      rs, W4K, 0, (0, 255), True, True))
        out["q1_frac_occlusion_p010_device_ms"] = device_ms(
            lambda: KQ.bilinear_blend(g1y, g1uv, g2y, g2uv, field, t,
                                      rs, W4K, 8, W.level_ints(16, 235),
                                      True, True))
    else:
        out["q1_frac_device_ms"] = out["q1_frac_occlusion_device_ms"] = \
            out["q1_frac_occlusion_p010_device_ms"] = "absent"
    if KQ is not None and \
            "vector" in inspect.signature(KQ.bilinear_blend).parameters:
        out["q1_per_sample_device_ms"] = device_ms(lambda: KQ.bilinear_blend(
            f1y, f1uv, f2y, f2uv, blurred, t, rs, W4K, vector=False))
    else:
        out["q1_per_sample_device_ms"] = "absent"
    for radius in (5, 8, 16, 24, 64):
        def pyr(radius=radius, **kw):
            return KS.flow_pyramid(f1y, f1u, f1v, *probe, radius, 8, 6,
                                   windows, F.FIRST_NEIGHBOR_ITERATION, rs,
                                   geom.height, geom.stride, **kw)
        try:
            pyr()
        except ValueError:
            out[f"k1_r{radius}_device_ms"] = "absent"
            out[f"k1_r{radius}_phase_a_b_us"] = "absent"
            continue
        out[f"k1_r{radius}_device_ms"] = device_ms(pyr)
        stamps = torch.zeros((10, 2 + 2 * n_steps), dtype=torch.int64,
                             device=dev)
        for row in stamps:
            pyr(timeline=row)
        d = stamps.diff(dim=1).median(dim=0).values.cpu().numpy() / 1e3
        out[f"k1_r{radius}_phase_a_b_us"] = [float(d[1::2].sum()),
                                             float(d[2::2].sum())]

    try:
        from mpv_frame_interpolator_tpu_torch.ops.cuda import subpel as KP
    except ImportError:
        out["s1_device_ms"] = out["s1_p010_device_ms"] = "absent"
    else:
        out["s1_device_ms"] = device_ms(lambda: KP.subpel_refine(
            field, f1y, f1u, f1v, *probe, rs, geom.height, geom.stride))
        p1 = planes(np.uint16)
        p2 = planes(np.uint16)
        probe16 = F.subsampled_f2(geom, p2[0], p2[2], p2[3])
        field16 = KS.flow_pyramid(p1[0], p1[2], p1[3], *probe16, 16, 8, 6,
                                  windows, F.FIRST_NEIGHBOR_ITERATION, rs,
                                  geom.height, geom.stride, 8)
        out["s1_p010_device_ms"] = device_ms(lambda: KP.subpel_refine(
            field16, p1[0], p1[2], p1[3], *probe16, rs, geom.height,
            geom.stride, 8))

    # the sub-pel flow of a pair: one launch where the tree has S1's
    # phases in K1 (the pyramid, S1, the blur), else the pyramid without
    # its blur phase, S1 and the standalone blur
    fused_subpel = "subpel" in inspect.signature(KS.flow_pyramid).parameters

    def subpel_flow():
        if fused_subpel:
            return F.flow(geom, f1y, f1u, f1v, f2y, f2u, f2v, 16,
                          subpel=True)
        offset = F.flow(geom, f1y, f1u, f1v, f2y, f2u, f2v, 16, blur=False)
        return F.blur_flow(F.subpel_flow(geom, offset, f1y, f1u, f1v, f2y,
                                         f2u, f2v))

    out["subpel_flow_device_ms"] = device_ms(subpel_flow)
    rows = kernel_rows(subpel_flow)
    out["subpel_flow_launches"] = sum(c for c, _ in rows.values())
    out["subpel_flow_rows"] = {k[:40]: round(us, 2)
                               for k, (_, us) in rows.items()}

    # one rank's device work of the layer-sharded flow of a pair, without
    # the collective (world 1): the tree's launches a step, and where the
    # slice commits nothing itself, the host's stack, winner and commit
    new_slice = "gathered" in inspect.signature(
        KS.flow_layer_slice).parameters
    scalars = (8, 6, rs, geom.height, geom.stride, 0)

    def rank_pair(n):
        if new_slice:
            field = torch.zeros((2, geom.low_h, geom.low_w),
                                dtype=torch.int32, device=dev)
            # the ping-pong sums of a pair, as the sharded flow holds them
            sums = torch.zeros((2, KS.slice_sums_words(
                geom.low_h, geom.low_w, n, windows)), dtype=torch.int32,
                device=dev)
            gathered = prev = None
            for k, step in enumerate(steps):
                gathered = KS.flow_layer_slice(
                    f1y, f1u, f1v, *probe, field, gathered, prev, step, 0, n,
                    16, *scalars, sums=(sums[k & 1], sums[~k & 1]))[None]
                prev = step[:2]
            KS.flow_layer_slice(f1y, f1u, f1v, *probe, field, gathered, prev,
                                None, 0, n, 16, *scalars)
            return field
        from mpv_frame_interpolator_tpu_torch.parallel.sharding import (
            first_unsigned_min)
        ox = oy = zero
        for w, is_y, nb in steps:
            best, arg = KS.flow_layer_slice(
                f1y, f1u, f1v, *probe, ox, oy, is_y, 0, n, 16, 8, 6, w, nb,
                rs, geom.height, geom.stride)
            winner = first_unsigned_min(torch.stack([torch.stack((best,
                                                                  arg))]))
            ox, oy = KS.commit_plain(ox, oy, is_y, winner, 16, w)
        return ox, oy

    for n in (16, 8, 4):
        rows = kernel_rows(lambda n=n: rank_pair(n))
        out[f"slice_rank_pair_n{n}_device_ms"] = sum(
            us for _, us in rows.values()) / 1e3
        out[f"slice_rank_pair_n{n}_slice_device_ms"] = sum(
            us for k, (_, us) in rows.items() if "slice" in k) / 1e3
        out[f"slice_rank_pair_n{n}_device_rows"] = sum(
            c for c, _ in rows.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            rank_pair(n)
            torch.cuda.synchronize()
        out[f"slice_rank_pair_n{n}_wall_ms"] = (time.perf_counter()
                                                - t0) / 20 * 1e3

    # the layer-sharded flow of a pair at world size 1 on nccl (the
    # collective included): wall ms a pair with a synchronise after each,
    # and device ms
    import os
    import tempfile
    import torch.distributed as dist
    from mpv_frame_interpolator_tpu_torch.parallel import sharding
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tmp, "store"), rank=0, world_size=1)
        try:
            fn = sharding.sharded_flow(geom, 16, None, 0, dev)

            def sharded():
                return fn(f1y, f1u, f1v, f2y, f2u, f2v)

            out["sharded_flow_w1_device_ms"] = device_ms(sharded)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                sharded()
                torch.cuda.synchronize()
            out["sharded_flow_w1_wall_ms"] = (time.perf_counter()
                                              - t0) / 20 * 1e3
        finally:
            dist.destroy_process_group()

    return report(out)


def report(out: dict) -> int:
    """Print every item, then the whole as one JSON line."""
    print(f"card: {out['card']}  tree: {out['root']} {out['label']}")
    for key, value in out.items():
        if key not in ("label", "root", "card"):
            print(f"  {key}: {value}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
