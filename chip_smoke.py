#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the port's CUDA kernels from ``mpv_frame_interpolator_tpu_torch/
   csrc`` with nvcc, one process per source, all started together (timed,
   with ptxas' resource report): K1's main-path instantiations at most 64
   registers and no spills, 4 blocks an SM;
3. each kernel against its plain PyTorch version on the card, at the 4K
   shapes of the paths below, inputs made from a numpy seed: bit-exact,
   with the median times of both (CUDA events) -- K1 (eight single steps,
   each window of the pyramid timed as one step, the whole radius-16
   pyramid in one launch, and that launch with the blur as its last
   phase, the engine's path, with the blur phase's time from the
   kernel's timeline), K2, K3 on its own at 8 bits; K1 on uint16 planes
   with luma_shift 8; K2 with scale_shift 8 and levels (16, 235), and with
   flows that push cells past every edge and odd chroma displacements,
   t in {0, 0.4, 1}; K4 at 8 bits and at P010, default and non-default
   levels, K5 at 8 bits and at P010 (65535 samples pass through
   uncapped), both directions, each on the block, edge and odd flows at
   t in {0, 0.4, 1}, the 4K planes taking the 16-byte path of K2, K4 and
   K5; G1 (the blend and levels of K5's two directions) at 8 bits and
   P010, default levels and (16, 235), t in {0, 0.4, 1}, on samples that
   reach 0 and the top value; G1's occlusion variant (hopperx) at 8 bits
   and P010 (16, 235), t in {0.2, 0.5, 0.8}; Q1 (the 1/64-pel bilinear
   blend of hopperq, with occlusion hopperxq) at NV12 default levels and
   P010 (16, 235), both occlusion settings, t in {0.2, 0.5, 0.8}, on the
   block and edge flows, and the same with a random sub-pel field (Q1's
   kFrac instantiation), each launch on its 16-byte runs held against the
   plain version and against its per-sample launch (``vector=False``),
   and on planes whose pitch is off the 16-byte grid (the per-sample
   step alone); K1 with its blur phase at search radius 5, 8,
   16, 24 and 64 (the instantiations of 5, 8 and 16 layers and the
   16-layer chunks), 8-bit and P010, each with its device ms, its window
   sums' and commits' us and its bound; S1 (the sub-pel refinement) at
   8 bits and P010: as two phases of K1's launch at radius 5, 16 and 24
   (the pyramid, S1's phases and the blur of the 1/64-pel field in one
   launch, against the pyramid, ``subpel_refine_plain`` and the plain
   blur, the phases' us from the kernel's timeline), and the standalone
   entry on a pyramid field and on wild offsets; V1 (the side-by-side
   views, modes 5 and 6) and V2 (the HSV view, mode 3) at 8 bits and
   default levels and P010 at (16, 235), t in {0, 0.4, 1}, on the block,
   edge and odd flows and a stride-padded frame: V1 bit-exact, V2 within
   the JAX package's HSV tolerance with its differing samples counted
   and placed (and bit-exact on a zero flow), each timed beside its plain
   version and its bound; C1 (the pair's prologue: the cut score, the
   cut, the folded blend positions and f2's probe in one launch) at 4K
   NV12 and P010 and on a frame whose score grid and probe grid differ,
   scene detection on and off, a cut and no cut, "nearest", "hold" and
   "repeat", a threshold float32 cannot hold (28.1, against a score of
   float32(28.1)): score bits, flag, count, positions and probe bytes
   equal to its plain version's; C1 captured in a CUDA graph and
   replayed three times, the count rising by one a cut (one scratch
   shared by every launch, as an engine's); two engines' C1 on two
   streams at once (a scratch a launch, then a scratch a stream); C1's
   wrapper's host time by part; V3 (the grey view of mode 4) bit-exact at
   4K NV12 and P010 and at an odd width; each timed (ms, device ms,
   bound, plain ms);
3b. the toolchain probes through their entry points: P1 (packed bytes:
   the JAX probe's five arrays and the card's own packing) every probe OK
   in one launch, each entry bit-exact at five pairs of shifts, beside
   the device time of a launch that does nothing; P2 (asynchronous
   copies) its matrix printed, the aligned control OK under cp.async and
   TMA, every case that is not REJECTED OK, and every verdict the H100's
   (``--expect-h100``);
4. the engine on the card against the engine on the CPU (the plain
   versions) on small clips at radius 5 and 16, scene cuts among them:
   8-bit NV12 under the "pair" sampler, and P010 with levels (16.5, 235)
   under "pair" and "fused"; modes 0, 1 and 4 and mode 2 under "pallas"
   at NV12 and P010: every output frame and pts equal; mode 3 (hsv,
   float colour math) within the JAX package's tolerance; every model
   family in mode 2 (NV12 and P010), hopperx and hopperq under "fused"
   and "pallas", modes 5 and 6 with hopper and blend, radii 24 and 64,
   the sub-pel flow of hopper, hopperq and hopperxq, and the ladder's
   rungs 1-3 pinned (res scalars 3 and 4 of a 544-row frame) -- with each
   case's launches: blend, repeat and the blend rung no K1, hopperx K5
   twice and G1 once an output, hopperq and hopperxq Q1 once an output,
   the sub-pel flow S1's phases inside K1's launch once a pair and no
   standalone S1 or K3, mode 3 V2 once an output and no K5 or G1, modes
   5 and 6 V1 once an output, mode 4 V3 once a pair, C1 once a pair in
   every case (clips under "repeat" and under ``cut_policy="hold"``
   among them);
5. the 8-bit main path end to end through the port's CLI at 3840x2160,
   24 -> 120 fps, radius 16: the output count must match the cadence,
   the launch counters of K1 and K2 must move during that run (K1
   exactly once a pair, with the blur as its last phase: K3's fused count
   once a pair, K3's own kernel never) and no plain version's may, the
   y4m must hold that many 4K frames, and the
   scene cut must never fire on the smooth clip; then the engine's rate
   with frames staged on the card;
6. the P010 path end to end through the CLI at the same shape with
   ``--p010 --warp-sampling fused --black-level 16 --white-level 235``:
   the counters of K1 and K4 must move, K2's must not (the fused
   sampler replaces it) and no plain version's may;
7. output mode 0 (``--mode warp12``) through the CLI at the same shape:
   K1 and K5 must move, K2 and K4 must not, no plain version may;
   then the engine's rate in that mode with frames staged on the card;
8. ``--warp-sampling pallas`` (blended) through the CLI at 4K: K5
   launches exactly twice per interpolated output and G1 once, K2 and K4
   never;
9. ``--model hopperxq`` through the CLI at 4K: K1 once a pair, Q1 once
   an output (5 a pair), no other warp kernel;
10. ``--model hopperx`` through the CLI at 4K: K5 twice and G1 once an
   output;
11. ``--model hopperq --subpel-flow`` through the CLI at 4K: K1 once a
   pair with S1's phases and the blur phase inside it, no standalone S1
   or K3, Q1 (with the sub-pel field) once an output;
12. the auto-quality ladder on the card: an engine at 4K 24 -> 120 fed
   over-budget durations walks radius 16 -> 5 and levels 1 -> 2 -> 3
   (the blend family), then recovers in reverse, every pair equal to a
   static engine at the rung's geometry and model; then each level's
   device ms a pair and K1's launches (none on the blend rung);
13. the player at 4K: a 24-frame 4K NV12 y4m file through the CLI with
   the prefetcher's staged uploads, without them, and with --group 8
   (CUDA graph replays): byte-equal outputs, no engine failure, each
   run's wall split a pair (source read, upload, engine, download, y4m
   write), out-fps and calc ms;
14. the grouped engine at 4K, 8-bit "pair" and P010 "fused": push and
   push_many in groups of 4 and 8, every output bit-equal to push's, with
   device ms, engine wall, busy share, host and kernel launches a pair
   and each graph's memory: C1, K1 and K2 are the NV12 pair's three
   kernel launches and its only device rows (no tensor op between them;
   the rows printed), C1, K1 and five K4 the P010 fused pair's seven;
15. seek, loop and end on the card: a small y4m clip through the
   pipeline (a seek and a loop) and the CLI (--loop 1 --end 0.4), equal
   to the CPU's frames and bytes;
16. the CLI's sources and sinks: an 8-frame 4K clip written as y4m, raw
   Matroska and FFV1 Matroska through the CLI (y4m and raw MKV through
   the Python readers and the native rings, FFV1 in with FFV1 out), every
   output equal to the Python y4m run's; small clips on the card against
   the CPU byte for byte (a cached playlist, backward play, --start, a
   --vf chain, Ut Video in Matroska); K1 and K2 once a pair, no engine
   failure, no plain version; each 4K run's wall split a pair and the
   native FFV1 ms of one 4K frame;
17. the control surfaces on the card at 4K 24 -> 120, radius 16: (1) a
   property script through api.Player (output mode 2 -> 0 -> 3 -> 2,
   levels 16/235, both scalars, radius 16 -> 5 -> 16, model hopper ->
   hopperx -> hopper, scene threshold, max-calc-res 270 -> 135 -> 270),
   every output equal to a fresh engine built at that pair's settings,
   each change taking effect at the next pair, the engine's stats log a
   line a timed pair; (2) the same script under push_many in groups of
   4 and 8 (the changes between groups, each a new captured graph),
   equal to push; the calc ms a pair with the IPC and applet threads
   polling against without them; (3) the CLI on a 4K y4m file with
   --ipc-server, --applet-fifo, --profile-dir and
   --save-position-on-quit, a client reading properties and telemetry,
   pausing, resuming, taking a screenshot, sending an applet code and
   quit-watch-later: a whole y4m, a PNG, no engine or control failure,
   K1's and K2's rows in the trace, and a second run resuming at the
   saved position with the bytes of a --start run there; (4) --config
   examples/mfi.conf --profile=baseline-3 / -4 (the 4K profiles): the
   bytes of the flags written out;
18. the last modules on the card: ``utils/parity.run_parity`` over
   FULL_CASES in every mode (28 rows, bit-exact against the oracle copy);
   K1's layer slice (radius 16, slices of 4, 8 and 16 layers, every step
   and window 1, 8-bit and P010, each launch committing two ranks' pairs
   first) and K2's row band (1, 2 and 4 bands, NV12 and P010 at 16/235)
   against their plain versions at 4K, timed, one rank's pair one slice
   launch a step and the closing commit with no other device row; the
   sharded flow at world size 1 on nccl profiled (one slice launch a
   step, no memset), with its ms a pair; ``chip_pair_seconds``
   at 4K beside the profiler's device ms a pushed pair; the pair pool on
   two slots of this card, the multi-stream engine (sequential and
   batched) and the stream farm (4 streams, one P010), every output equal
   to single engines, with out-fps; the sharded step at 4K on world sizes
   1 (nccl, in this process, its launches counted), 2 and 4 (gloo, a
   process a rank on this card), equal to the single-device path, with
   ms a pair; ``dryrun_multichip(4)``;
19. the last tools on the card: the quality report
   (``tools/quality_report``: 256x128 sine pans at 6 and 2.5 px a frame,
   radius 10, every family) with the kernels against the same report on
   the plain versions (the CPU, in this process), every rendered luma
   plane byte for byte and every PSNR the same float, each column's
   launches (the flow K1 once with its blur phase, the sub-pel flow K1
   once with S1's phases and the blur phase, blend and hopper K2, hopperx
   K5 twice and G1's occlusion variant, hopperq and hopperxq Q1, with the
   sub-pel field in the +subpel columns), the table printed; the degrade
   ladder (``tools/degrade_ladder``) at 4K, nine rungs' ms a pair after
   the card's name and power limit, the blend rung launching no K1; the
   ``embed`` and ``serving_farm`` examples at their own sizes, each
   writing or returning as many frames as the cadence gives;
20. the views through the CLI at 4K 24 -> 120, radius 16: ``--mode
   hsv``, ``--mode sbs1``, ``--mode sbs2`` and ``--mode grey``, each with
   K1 once a pair, V2 or V1 once an output or V3 once a pair and no
   other warp kernel or plain version;
   each mode's device ms a pair (``profile_pair.profile``) and calc ms a
   pair against the 29.8 ms bar; then 24 frames of each with the
   auto-quality controller on, ending at radius 16 and level 0.

The 4K synthetic CLI runs of phases 5-11 and 20 pass ``--cache no``: under
``--cache auto`` a synthetic clip, which cannot seek, is spooled to a
temporary file.

On every path C1 runs once a pair before K1 (the score, the cut, the
folded positions and the probe; K1's blur phase applies the cut), the
blur runs inside K1's launch once a pair and K3's standalone kernel
never (under the sub-pel flow S1's phases run in the
same launch, before it), G1 runs only on the "pallas" and hopperx
paths, Q1 only on the hopperq / hopperxq paths, V1 only in modes 5 and
6, V2 only in mode 3 and V3 only in mode 4.

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
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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


def ptxas_report(text: str) -> dict:
    """{mangled kernel name: (registers, spilled bytes)} from ptxas'
    verbose report."""
    out, name, spilled = {}, None, 0
    for line in text.splitlines():
        words = line.split()
        if "Compiling entry function" in line:
            name, spilled = line.split("'")[1], 0
        elif "bytes spill stores" in line and name:
            spilled = sum(int(w) for w, nxt in zip(words, words[1:])
                          if nxt == "bytes" and w.isdigit()) - int(words[0])
        elif "Used" in words and name:
            out[name] = (int(words[words.index("Used") + 1]), spilled)
    return out


T_START = time.perf_counter()


def log(msg: str):
    """Print a line; a phase's heading with the seconds since the start."""
    if msg.startswith("phase "):
        msg = f"[{time.perf_counter() - T_START:.0f} s] {msg}"
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


def spin_opening():
    """64 spin kernels (torch.cuda._sleep), the opening of every trace."""
    for _ in range(64):
        torch.cuda._sleep(100)


def kernel_rows(fn, expect: int = 1, setup=None, opening=spin_opening,
                left_out: str = "spin") -> dict:
    """{name: (count, device us)} of the device rows (kernels, memsets,
    copies) of one call of fn under torch.profiler (after one call
    outside it), `setup` called before each call, outside the trace.  A
    trace late in a long process loses the device records it takes first,
    a few of them, so `opening` (64 spin kernels) opens it and its rows
    (those whose name holds `left_out`) are left out; one with fewer than
    `expect` rows is taken again, up to five times (the last is
    returned)."""
    from torch.profiler import ProfilerActivity, profile
    from mpv_frame_interpolator_tpu_torch.profile_pair import self_device_us
    setup = setup or (lambda: None)
    setup()
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            opening()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        rows = {e.key: (e.count, self_device_us(e))
                for e in prof.key_averages()
                if self_device_us(e) > 0 and left_out not in e.key}
        if sum(c for c, _ in rows.values()) >= expect:
            break
    return rows


def device_ms(fn, expect: int = 1) -> float:
    """The card's own time of one call of fn: the sum of its device rows
    (kernels, memsets, copies) as profile_pair counts them, in a trace
    that kernel_rows opens with 64 spin kernels and takes again while it
    holds fewer than `expect` rows."""
    return sum(us for _, us in kernel_rows(fn, expect).values()) / 1e3


def launch_floor_ms(n: int = 20) -> float:
    """The device time of a launch that does nothing: the mean of n
    torch.cuda._sleep(0) (a spin kernel of no cycles) in one trace,
    opened with 64 fills in place of the spin kernels."""
    one = torch.zeros(1, device="cuda")
    rows = kernel_rows(lambda: [torch.cuda._sleep(0) for _ in range(n)], n,
                       opening=lambda: [one.fill_(1) for _ in range(64)],
                       left_out="Fill")
    count, us = next(v for k, v in rows.items() if "spin" in k)
    return us / count / 1e3


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by) for work that moves `nbytes` and does `ops`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _device(r) -> str:
    return f" (device {r['device_ms']:.4f} ms)" if "device_ms" in r else ""


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
    each window of the pyramid timed as one step, then the whole 16-step
    radius-16 pyramid in one launch; returns the result entry (times per
    pyramid, the unit the main path launches)."""
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

    # where a step's time goes: each window of the schedule as one step
    # (one launch), both axes, the neighbour bias as the pyramid has it
    windows = geom.window_schedule()
    ox = torch.from_numpy(block_field(rng, lh, lw, 8, 6, 64)).to(dev)
    oy = torch.from_numpy(block_field(rng, lh, lw, 8, 6, 64)).to(dev)
    per_window = {}
    for it, window in enumerate(windows + (1,)):
        steps = [(f1y, f1u, f1v, *probe, ox, oy, is_y, 16, 8, 6, window,
                  it >= F.FIRST_NEIGHBOR_ITERATION, rs, geom.height,
                  geom.stride, luma_shift) for is_y in (0, 1)]

        def both(steps=steps):
            return [KS.flow_step(*a) for a in steps]

        per_window[window] = (device_ms(both) / 2, cuda_ms(both, 10) / 2)
    log(f"  K1 {tag} one step per window, device / event ms: " + ", ".join(
        f"{w}: {d:.4f} / {e:.4f}" for w, (d, e) in per_window.items()))

    args = (f1y, f1u, f1v, *probe, 16, 8, 6, windows,
            F.FIRST_NEIGHBOR_ITERATION, rs, geom.height, geom.stride,
            luma_shift)
    before = KS.counts.kernel
    got = KS.flow_pyramid(*args)
    check(KS.counts.kernel == before + 1, "flow_pyramid took more than one "
          "launch")
    e = max_err([got], [KS.flow_pyramid_plain(*args)])
    steps = 2 * geom.iterations
    log(f"  K1 {tag} whole radius-16 pyramid ({steps} steps, one launch): "
        f"max_abs_err={e}")
    # inside the launch: the card's clock after each barrier (median of
    # 10 launches), the window sums (phase A) and the commit (phase B)
    stamps = torch.zeros((10, 2 + 2 * steps), dtype=torch.int64, device=dev)
    for row in stamps:
        KS.flow_pyramid(*args, timeline=row)
    d = stamps.diff(dim=1).median(dim=0).values.cpu().numpy() / 1e3
    log(f"  K1 {tag} inside the pyramid launch, us: prologue {d[0]:.2f}; "
        "per step (window axis): phase A sums + phase B commit: " + "; ".join(
            f"{w} {'xy'[s % 2]}: {d[1 + 2 * s]:.2f} + {d[2 + 2 * s]:.2f}"
            for s, w in enumerate(np.repeat(windows, 2))))
    pre_blur_us = float(d.sum())

    # the engine's launch: the pyramid with the blur as its last phase
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    before = (KS.counts.kernel, KB.counts.fused, KB.counts.kernel)
    field, blurred = KS.flow_pyramid(*args, blur=True)
    check((KS.counts.kernel, KB.counts.fused, KB.counts.kernel) == (
        before[0] + 1, before[1] + 1, before[2]),
        "the pyramid with its blur took more than one launch")
    want = KS.flow_pyramid_plain(*args)
    e_fused = max_err([field, blurred], [want, KB.blur_flow_plain(want)])
    log(f"  K1 + K3 {tag} pyramid and blur in one launch: "
        f"max_abs_err={e_fused}")
    stamps = torch.zeros((10, 3 + 2 * steps), dtype=torch.int64, device=dev)
    for row in stamps:
        KS.flow_pyramid(*args, timeline=row, blur=True)
    d = stamps.diff(dim=1).median(dim=0).values.cpu().numpy() / 1e3
    blur_us = float(d[-1])
    log(f"  K1 + K3 {tag} inside the launch, us: before the blur "
        f"{d[:-1].sum():.2f} (without the blur phase {pre_blur_us:.2f}), "
        f"the blur phase {blur_us:.2f}")
    # the pyramid reads each f1 sample its candidates reach once (at most
    # steps * radius * lh * lw a plane) and the probe, and writes the
    # field; each radius-16 step does ~35 integer operations a candidate
    # (three |differences|, shifts, the offset and neighbour biases,
    # mirrored coordinates)
    item = np.dtype(dt).itemsize
    cand = steps * 16 * lh * lw
    nbytes = (sum(min(p.numel(), cand) for p in (f1y, f1u, f1v)) * item
              + 3 * lh * lw * item + 2 * lh * lw * 4)
    return dict(max_abs_err=max(err, e, e_fused),
                device_ms=device_ms(lambda: KS.flow_pyramid(*args)),
                ms=cuda_ms(lambda: KS.flow_pyramid(*args), 20),
                plain_ms=cuda_ms(lambda: KS.flow_pyramid_plain(*args), 3),
                bound=bound(nbytes, 35 * cand),
                blur_phase_ms=blur_us / 1e3,
                fused_device_ms=device_ms(lambda: KS.flow_pyramid(
                    *args, blur=True)),
                fused_ms=cuda_ms(lambda: KS.flow_pyramid(*args, blur=True),
                                 20))


def k1_bound(geom, radius: int, item: int):
    """(bound_ms, bound_by) of one 4K pyramid at `radius`: each f1 sample
    its candidates reach read once (at most steps * radius * lh * lw a
    plane), the probe read and the field written once; ~35 integer
    operations a candidate (three |differences|, shifts, the offset and
    neighbour biases, mirrored coordinates)."""
    lh, lw = geom.low_h, geom.low_w
    cand = 2 * geom.iterations * radius * lh * lw
    planes = (H4K * W4K, H4K * W4K // 4, H4K * W4K // 4)
    nbytes = (sum(min(n, cand) for n in planes) * item
              + 3 * lh * lw * item + 2 * lh * lw * 4)
    return bound(nbytes, 35 * cand)


def phase_k1_radii(dev, rng, geom):
    """K1 at search radius 5, 8, 24 and 64 (16: phase_flow_step), each on
    the instantiation the engine's default layer buckets give it (5, 8
    and 16 layers; 16-layer chunks above 16), with the blur phase as the
    engine launches it, 8-bit and P010 (luma_shift 8): bit-exact with the
    plain pyramid and its blur; device ms, kernel ms, plain ms and the
    bound of each, and the us of its window sums (phase A) and commits
    (phase B) from the kernel's timeline.  Returns {(radius, item):
    entry}."""
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    out = {}
    windows = geom.window_schedule()
    steps = 2 * geom.iterations
    for dt, luma_shift in ((np.uint8, 0), (np.uint16, 8)):
        f1y, _, f1u, f1v = random_planes(rng, dev, dt)
        f2y, _, f2u, f2v = random_planes(rng, dev, dt)
        probe = F.subsampled_f2(geom, f2y, f2u, f2v)
        item = np.dtype(dt).itemsize
        for radius in (5, 8, 16, 24, 64):
            args = (f1y, f1u, f1v, *probe, radius, 8, 6, windows,
                    F.FIRST_NEIGHBOR_ITERATION, geom.res_scalar,
                    geom.height, geom.stride, luma_shift)
            before = (KS.counts.kernel, KB.counts.fused)
            got = KS.flow_pyramid(*args, blur=True)
            check((KS.counts.kernel, KB.counts.fused) == (before[0] + 1,
                                                          before[1] + 1),
                  "the pyramid with its blur took more than one launch")
            want = KS.flow_pyramid_plain(*args)
            e = max_err(got, [want, KB.blur_flow_plain(want)])
            stamps = torch.zeros((10, 2 + 2 * steps), dtype=torch.int64,
                                 device=dev)
            for row in stamps:
                KS.flow_pyramid(*args, timeline=row)
            d = stamps.diff(dim=1).median(dim=0).values.cpu().numpy() / 1e3
            r = dict(max_abs_err=e, layers=KS.kernel_layers(radius),
                     blocks_per_sm=KS.blocks_per_sm(item, radius=radius,
                                                    layers=radius),
                     device_ms=device_ms(lambda: KS.flow_pyramid(
                         *args, blur=True)),
                     ms=cuda_ms(lambda: KS.flow_pyramid(*args, blur=True),
                                10),
                     plain_ms=cuda_ms(lambda: KS.flow_pyramid_plain(*args),
                                      2, 1),
                     phase_a_us=float(d[1::2].sum()),
                     phase_b_us=float(d[2::2].sum()),
                     bound=k1_bound(geom, radius, item))
            log(f"  K1 + K3 {np.dtype(dt).name} radius {radius} "
                f"({r['layers']} layers a chunk, {r['blocks_per_sm']} "
                f"blocks an SM): max_abs_err={e}, device {r['device_ms']:.4f}"
                f" ms, kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); "
                f"phase A {r['phase_a_us']:.2f} us, phase B "
                f"{r['phase_b_us']:.2f} us")
            out[(radius, item)] = r
    return out


def subpel_bound(geom, item: int):
    """(bound_ms, bound_by) of S1 on a 4K field: the offset read and the
    field written once, the probe read once, the f1 samples the nine
    probes of every low-res pixel touch read once (at most 9 x lh x lw a
    plane); ~360 integer operations a low-res pixel (27 mirrored
    coordinates and addresses, 27 |differences|, 9 x 16 window adds, the
    fit)."""
    n = geom.low_h * geom.low_w
    touched = sum(min(p, 9 * n) for p in (H4K * W4K, H4K * W4K // 4,
                                          H4K * W4K // 4))
    return bound(4 * n * 4 + 3 * n * item + touched * item, 360 * n)


def phase_subpel(dev, rng, geom):
    """S1 (the sub-pel refinement) at 4K against its plain version, 8-bit
    and P010: as two phases of K1's launch (``flow_pyramid(...,
    subpel=True)``, radius 5, 16 and 24: the field equal to the pyramid's
    without them, the blurred 1/64-pel field equal to the plain refinement
    and blur of that field; the phases' us from the kernel's timeline),
    and the standalone entry on a committed pyramid field and on a field
    of wild offsets (probes past every edge); timed on the pyramid
    field."""
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.ops.cuda import subpel as KP
    lh, lw = geom.low_h, geom.low_w
    windows = geom.window_schedule()
    steps = 2 * geom.iterations
    res = {}
    err = 0
    for dt, luma_shift in ((np.uint8, 0), (np.uint16, 8)):
        tag = np.dtype(dt).name
        f1y, _, f1u, f1v = random_planes(rng, dev, dt)
        f2y, _, f2u, f2v = random_planes(rng, dev, dt)
        probe = F.subsampled_f2(geom, f2y, f2u, f2v)
        sub = (f1y, f1u, f1v, *probe, geom.res_scalar, geom.height,
               geom.stride, luma_shift)
        for radius in (5, 16, 24):
            args = (f1y, f1u, f1v, *probe, radius, 8, 6, windows,
                    F.FIRST_NEIGHBOR_ITERATION, geom.res_scalar,
                    geom.height, geom.stride, luma_shift)
            before = (KS.counts.kernel, KP.counts.kernel, KP.counts.fused,
                      KB.counts.kernel, KB.counts.fused)
            field, b64 = KS.flow_pyramid(*args, subpel=True)
            after = (KS.counts.kernel, KP.counts.kernel, KP.counts.fused,
                     KB.counts.kernel, KB.counts.fused)
            check([a - b for a, b in zip(after, before)] == [1, 0, 1, 0, 1],
                  f"the pyramid with S1's phases launched {after} after "
                  f"{before}")
            want = KS.flow_pyramid(*args)
            e = max_err([field, b64], [want, KB.blur_flow_plain(
                KP.subpel_refine_plain(want, *sub))])
            log(f"  K1 + S1 + K3 {tag} radius {radius}, one launch: "
                f"max_abs_err={e} against the pyramid, subpel_refine_plain "
                f"and blur_flow_plain")
            err = max(err, e)
        # inside the radius-16 launch: S1's two phases and the blur phase
        args = (f1y, f1u, f1v, *probe, 16, 8, 6, windows,
                F.FIRST_NEIGHBOR_ITERATION, geom.res_scalar, geom.height,
                geom.stride, luma_shift)
        stamps = torch.zeros((10, 5 + 2 * steps), dtype=torch.int64,
                             device=dev)
        for row in stamps:
            KS.flow_pyramid(*args, timeline=row, subpel=True)
        d = stamps.diff(dim=1).median(dim=0).values.cpu().numpy() / 1e3
        phases_us = (float(d[-3]), float(d[-2]), float(d[-1]))
        log(f"  K1 + S1 + K3 {tag} inside the launch, us: the steps "
            f"{d[:-3].sum():.2f}, S1's probe phase {phases_us[0]:.2f}, its "
            f"fit phase {phases_us[1]:.2f}, the blur phase "
            f"{phases_us[2]:.2f}")
        field = KS.flow_pyramid(*args)
        wild = torch.from_numpy(rng.integers(-400, 401, (2, lh, lw)).astype(
            np.int32)).to(dev)
        for name, offset in (("pyramid", field), ("wild", wild)):
            before = KP.counts.kernel
            got = KP.subpel_refine(offset, *sub)
            check(KP.counts.kernel == before + 1, "the standalone S1 took "
                  "other than one launch")
            want = KP.subpel_refine_plain(offset, *sub)
            e = max_abs_err(got, want)
            refined = int(((got - (offset << 6)) != 0).any(0).sum())
            log(f"  S1 standalone {tag} {name} field: max_abs_err={e}, "
                f"{refined} of {lh * lw} pixels refined")
            err = max(err, e)
        item = np.dtype(dt).itemsize
        res[item] = dict(
            device_ms=device_ms(lambda: KP.subpel_refine(field, *sub)),
            ms=cuda_ms(lambda: KP.subpel_refine(field, *sub), 20),
            plain_ms=cuda_ms(lambda: KP.subpel_refine_plain(field, *sub),
                             5),
            bound=subpel_bound(geom, item),
            phases_ms=(phases_us[0] + phases_us[1]) / 1e3,
            k1_subpel_device_ms=device_ms(lambda: KS.flow_pyramid(
                *args, subpel=True)),
            k1_blur_device_ms=device_ms(lambda: KS.flow_pyramid(
                *args, blur=True)))
        r = res[item]
        log(f"  S1 {tag}: phases in K1's launch {r['phases_ms']:.4f} ms "
            f"(timeline); K1 with them {r['k1_subpel_device_ms']:.4f} "
            f"device ms against {r['k1_blur_device_ms']:.4f} with the blur "
            f"phase alone; standalone kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return dict(res[1], max_abs_err=err, p010=res[2])


def warp_bound(n: int, item: int, rs: int):
    """Bytes and operations of n blended 4K outputs (luma + chroma): the
    two source frames read once, the outputs written once; per output
    sample ~6 scalar operations (the two weighted products, the add and
    shift, the level map, the pack), and per flow cell and position ~30
    (four products, four roundings, the edge tests) -- the displacement
    depends on the cell alone (a luma cell is 2^rs x 2^rs samples, a
    chroma cell 2^rs rows of 2^(rs+1) interleaved samples)."""
    out = n * (H4K + H4K // 2) * W4K
    cells = n * ((H4K >> rs) * (W4K >> rs)
                 + ((H4K // 2) >> rs) * (W4K >> (rs + 1)))
    nbytes = 2 * (H4K + H4K // 2) * W4K * item + out * item
    return bound(nbytes, 6 * out + 30 * cells)


def q1_bound(item: int, occlusion: bool, frac: bool, rs: int,
             flow_ints: int):
    """Bytes and operations of one bilinear blended 4K position (Q1): the
    two source frames and the flow (and the sub-pel field) read once, the
    output written once; per output sample ~28 scalar operations (for each
    direction the three products and two sums of a row of taps twice and
    once more across the rows, the float blend's two conversions, three
    products, two sums, floor and conversion, the level map) and ~21 more
    with the occlusion correction (both samples rounded, the ramp, the
    mix); per flow cell ~40 (four flow loads, the back-projection, four
    products and roundings, the tap offsets and weights) and ~8 more with
    the sub-pel field -- the cell's work is shared by its samples."""
    out = (H4K + H4K // 2) * W4K
    cells = ((H4K >> rs) * (W4K >> rs)
             + ((H4K // 2) >> rs) * (W4K >> (rs + 1)))
    ops = (28 + 21 * occlusion) * out + (40 + 8 * frac) * cells
    return bound(3 * out * item + 4 * flow_ints, ops)


def phase_kernels(dev):
    """Phase 3: every kernel vs its plain version at the 4K shapes."""
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops import warp as W
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blend_levels as KG
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_bilinear as KQ
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KD

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
    radii = phase_k1_radii(dev, rng, geom)
    results["flow_step"]["radii"] = radii
    results["flow_step"]["max_abs_err"] = max(
        [results["flow_step"]["max_abs_err"]]
        + [r["max_abs_err"] for r in radii.values()])
    results["subpel_refine"] = phase_subpel(dev, rng, geom)

    # K3 on its own (the public ops/flow.blur_flow; the engine's path
    # blurs inside K1's launch, held above), on a field of flows and on
    # one whose sums wrap mod 2^32
    off = torch.from_numpy(rng.integers(-300, 301, (2, lh, lw)).astype(
        np.int32)).to(dev)
    wide = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (2, lh, lw))
                            .astype(np.int32)).to(dev)
    e = max(max_abs_err(KB.blur_flow(f), KB.blur_flow_plain(f))
            for f in (off, wide))
    log(f"  K3 standalone (2, {lh}, {lw}): max_abs_err={e}")
    k1 = results["flow_step"]
    results["blur_flow"] = dict(
        max_abs_err=max(e, k1["max_abs_err"]),
        device_ms=device_ms(lambda: KB.blur_flow(off)),
        ms=cuda_ms(lambda: KB.blur_flow(off), 50),
        plain_ms=cuda_ms(lambda: KB.blur_flow_plain(off), 20),
        # the field read and written once; per output 16 adds (8 along
        # the row, 8 down the column) and the truncating division
        bound=bound(2 * off.numel() * 4, 20 * off.numel()),
        fused_phase_ms=k1["blur_phase_ms"])
    log(f"  K3: the blur phase inside K1's launch "
        f"{k1['blur_phase_ms']:.4f} ms (8-bit), "
        f"{k1['p010']['blur_phase_ms']:.4f} ms (P010); the pyramid with "
        f"its blur {k1['fused_ms']:.4f} ms (device "
        f"{k1['fused_device_ms']:.4f} ms), without {k1['ms']:.4f} ms "
        f"(device {k1['device_ms']:.4f} ms)")

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
    # edge and odd-chroma cases: flows that push cells past every edge of
    # the frame, and odd flows (odd chroma displacements in both
    # directions at t = 0.4, where both weigh), at t in {0, 0.4, 1}
    far = torch.from_numpy(np.stack([
        block_field(rng, lh, lw, 8, 12, 400), block_field(rng, lh, lw, 8,
                                                          12, 400)])).to(dev)
    odd = torch.from_numpy(2 * np.stack([
        block_field(rng, lh, lw, 8, 12, 48), block_field(rng, lh, lw, 8, 12,
                                                         48)]) + 1).to(dev)
    t3 = torch.tensor([0.0, 0.4, 1.0], dtype=torch.float32, device=dev)
    k2 = {}
    for dt, ss, levels in ((np.uint8, 0, (0, 255)),
                           (np.uint16, 8, W.level_ints(16, 235))):
        (f1y, f1uv, _, _), (f2y, f2uv, _, _) = frames[dt]
        check(KW.vector_path((f1y, f1uv, f2y, f2uv), geom.actual_width),
              "the 4K planes do not take K2's 16-byte path")
        err = 0
        for name, flow in (("edge", far), ("odd", odd)):
            args = (f1y, f1uv, f2y, f2uv, flow, t3, rs, geom.actual_width,
                    ss, levels)
            e = max_err(KW.pair_blend(*args), KW.pair_blend_plain(*args))
            log(f"  K2 N=3 {W4K}x{H4K} scale_shift={ss} levels={levels} "
                f"{name} flow: max_abs_err={e}")
            err = max(err, e)
        # every position count of a pair (a block loops over them)
        for n in range(1, 5):
            args = (*warp_args(dt), ts[:n], rs, geom.actual_width, ss,
                    levels)
            e = max_err(KW.pair_blend(*args), KW.pair_blend_plain(*args))
            log(f"  K2 N={n} {W4K}x{H4K} scale_shift={ss} levels={levels}: "
                f"max_abs_err={e}")
            err = max(err, e)
        # rows of 3844 samples: off the 16-byte grid, the per-sample path
        hi = np.iinfo(dt).max + 1
        odd_pitch = [torch.from_numpy(rng.integers(0, hi, (r, 3844)).astype(
            dt)).to(dev) for r in (H4K, H4K // 2, H4K, H4K // 2)]
        check(not KW.vector_path(odd_pitch, 3844),
              "the pitch-3844 planes take K2's 16-byte path")
        args = (*odd_pitch, blurred, t3, rs, 3844, ss, levels)
        e = max_err(KW.pair_blend(*args), KW.pair_blend_plain(*args))
        log(f"  K2 N=3 3844x{H4K} (per sample) scale_shift={ss} "
            f"levels={levels}: max_abs_err={e}")
        err = max(err, e)
        del odd_pitch
        args = (*warp_args(dt), ts, rs, geom.actual_width, ss, levels)
        e = max_err(KW.pair_blend(*args), KW.pair_blend_plain(*args))
        log(f"  K2 N=5 {W4K}x{H4K} scale_shift={ss} levels={levels}: "
            f"max_abs_err={e}")
        k2[ss] = dict(max_abs_err=max(err, e),
                      device_ms=device_ms(lambda: KW.pair_blend(*args)),
                      ms=cuda_ms(lambda: KW.pair_blend(*args), 20),
                      plain_ms=cuda_ms(lambda: KW.pair_blend_plain(*args),
                                       5),
                      bound=warp_bound(5, np.dtype(dt).itemsize, rs))
    # the per-position slope: N = 1..5 at 8 bits, one launch each
    args = (*warp_args(np.uint8), ts, rs, geom.actual_width)
    slope = {n: device_ms(lambda n=n: KW.pair_blend(*args[:5], ts[:n],
                                                     *args[6:]))
             for n in range(1, 6)}
    log("  K2 8-bit device ms by positions: "
        + ", ".join(f"N={n} {v:.4f}" for n, v in slope.items()))
    results["pair_blend"] = dict(k2[0], max_abs_err=max(
        k2[0]["max_abs_err"], k2[8]["max_abs_err"]), p010=k2[8],
        p010_device_ms=k2[8]["device_ms"], n_device_ms=slope)

    # K4: one blend position, 8-bit and P010, default and TV levels, on
    # the block, edge and odd flows; timed at t = 0.4 on the block flow
    flows = (("block", blurred), ("edge", far), ("odd", odd))
    k4 = {}
    err = 0
    for dt, ss in ((np.uint8, 0), (np.uint16, 8)):
        for levels in ((0, 255), W.level_ints(16, 235)):
            for name, flow in flows:
                e = 0
                for t in (0.0, 0.4, 1.0):
                    tt = torch.tensor(t, dtype=torch.float32, device=dev)
                    args = (*warp_args(dt)[:4], flow, tt, rs,
                            geom.actual_width, ss, levels)
                    got = KF.fused_blend(*args)
                    check(KW.vector_path((*args[:4], *got),
                                         geom.actual_width),
                          "the 4K planes do not take K4's 16-byte path")
                    e = max(e, max_err(got, KF.fused_blend_plain(*args)))
                log(f"  K4 {W4K}x{H4K} scale_shift={ss} levels={levels} "
                    f"{name} flow, t in (0, 0.4, 1): max_abs_err={e}")
                err = max(err, e)
            tt = torch.tensor(0.4, dtype=torch.float32, device=dev)
            args = (*warp_args(dt), tt, rs, geom.actual_width, ss, levels)
            k4[(ss, levels)] = dict(
                device_ms=device_ms(lambda: KF.fused_blend(*args)),
                ms=cuda_ms(lambda: KF.fused_blend(*args), 20),
                plain_ms=cuda_ms(lambda: KF.fused_blend_plain(*args), 5),
                bound=warp_bound(1, np.dtype(dt).itemsize, rs))
    main = k4[(8, W.level_ints(16, 235))]
    results["fused_blend"] = dict(
        main, max_abs_err=err,
        nv12=k4[(0, (0, 255))],
        nv12_device_ms=k4[(0, (0, 255))]["device_ms"])
    for key, r in sorted(k4.items()):
        log(f"  K4 scale_shift={key[0]} levels={key[1]} t=0.4: kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")

    # K5: one direction at one position, 8-bit and P010, both directions,
    # on the block, edge and odd flows; P010 rows of 65535 pass through
    # uncapped
    for dt in (np.uint8, np.uint16):
        for plane in (frames[dt][0][0], frames[dt][1][0]):
            host = plane.cpu().numpy()      # CUDA does not fill uint16
            host[:4] = np.iinfo(dt).max
            plane.copy_(torch.from_numpy(host))
    k5 = {}
    err = 0
    for dt in (np.uint8, np.uint16):
        for direction in (12, 21):
            for name, flow in flows:
                e = 0
                for t in (0.0, 0.4, 1.0):
                    tt = torch.tensor(t, dtype=torch.float32, device=dev)
                    args = (*warp_args(dt)[:4], flow, tt, direction, rs,
                            geom.actual_width)
                    got = KD.sample_dir(*args)
                    src = args[:2] if direction == 12 else args[2:4]
                    check(KW.vector_path((*src, *got), geom.actual_width),
                          "the 4K planes do not take K5's 16-byte path")
                    e = max(e, max_err(got, KD.sample_dir_plain(*args)))
                    if name == "block":
                        top = int(got[0].to(torch.int32).max())
                        check(top == np.iinfo(dt).max,
                              f"K5 {np.dtype(dt).name}: the top sample came "
                              f"out as {top}")
                log(f"  K5 {W4K}x{H4K} {np.dtype(dt).name} direction="
                    f"{direction} {name} flow, t in (0, 0.4, 1): "
                    f"max_abs_err={e}")
                err = max(err, e)
        tt = torch.tensor(0.4, dtype=torch.float32, device=dev)
        args = (*warp_args(dt), tt, 12, rs, geom.actual_width)
        item = np.dtype(dt).itemsize
        out = (H4K + H4K // 2) * W4K
        k5[item] = dict(
            device_ms=device_ms(lambda: KD.sample_dir(*args)),
            ms=cuda_ms(lambda: KD.sample_dir(*args), 20),
            plain_ms=cuda_ms(lambda: KD.sample_dir_plain(*args), 5),
            # one plane pair written, as many source samples read, the
            # flow read once; ~15 scalar operations per sample (two
            # products, two roundings, two mirrors, the flow and source
            # addresses)
            bound=bound(2 * out * item + blurred.numel() * 4, 15 * out))
    results["sample_dir"] = dict(k5[1], max_abs_err=err, p010=k5[2])

    # G1: the blend and levels of one position over K5's two directions,
    # 8-bit and P010, default and TV levels, t in {0, 0.4, 1}; the raw
    # samples hold rows of 0 and of the top value (the P010 planes' top
    # rows are 65535 since K5's check above)
    g1 = {}
    err = 0
    for dt, ss in ((np.uint8, 0), (np.uint16, 8)):
        for levels in ((0, 255), W.level_ints(16, 235)):
            e = 0
            for t in (0.0, 1.0, 0.4):      # timed at the last
                tt = torch.tensor(t, dtype=torch.float32, device=dev)
                s12 = KD.sample_dir(*warp_args(dt), tt, 12, rs,
                                    geom.actual_width)
                s21 = KD.sample_dir(*warp_args(dt), tt, 21, rs,
                                    geom.actual_width)
                # CUDA does not fill uint16: a converting copy
                s21[0][4:6].copy_(torch.zeros((2, geom.actual_width),
                                              dtype=torch.int32))
                args = (*s12, *s21, tt, ss, levels)
                got = KG.blend_levels(*args)
                check(KW.vector_path((*s12, *s21, *got), geom.actual_width),
                      "the 4K planes do not take G1's 16-byte path")
                e = max(e, max_err(got, KG.blend_levels_plain(*args)))
            log(f"  G1 {W4K}x{H4K} scale_shift={ss} levels={levels}, t in "
                f"(0, 1, 0.4): max_abs_err={e}")
            err = max(err, e)
            item = np.dtype(dt).itemsize
            out = (H4K + H4K // 2) * W4K
            g1[(ss, levels)] = dict(
                device_ms=device_ms(lambda: KG.blend_levels(*args)),
                ms=cuda_ms(lambda: KG.blend_levels(*args), 20),
                plain_ms=cuda_ms(lambda: KG.blend_levels_plain(*args), 5),
                # two sample planes read and one written once; per sample
                # ~8 scalar operations (two products, the add and shift,
                # the level map's subtract, multiply, divide and cap)
                bound=bound(3 * out * item, 8 * out))
    for key, r in sorted(g1.items()):
        log(f"  G1 scale_shift={key[0]} levels={key[1]} t=0.4: kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")
    results["blend_levels"] = dict(g1[(0, (0, 255))], max_abs_err=err,
                                   p010=g1[(8, W.level_ints(16, 235))])

    # G1's occlusion variant (hopperx): the same samples, 8-bit at the
    # default levels and P010 at (16, 235), t in {0.2, 0.5, 0.8}
    g1x = {}
    err = 0
    for dt, ss, levels in ((np.uint8, 0, (0, 255)),
                           (np.uint16, 8, W.level_ints(16, 235))):
        e = 0
        for t in (0.2, 0.8, 0.5):          # timed at the last
            tt = torch.tensor(t, dtype=torch.float32, device=dev)
            s12 = KD.sample_dir(*warp_args(dt), tt, 12, rs, W4K)
            s21 = KD.sample_dir(*warp_args(dt), tt, 21, rs, W4K)
            s21[0][4:6].copy_(torch.zeros((2, W4K), dtype=torch.int32))
            args = (*s12, *s21, tt, ss, levels, True)
            e = max(e, max_err(KG.blend_levels(*args),
                               KG.blend_levels_plain(*args)))
        log(f"  G1 occlusion {W4K}x{H4K} scale_shift={ss} levels={levels}, "
            f"t in (0.2, 0.8, 0.5): max_abs_err={e}")
        err = max(err, e)
        item = np.dtype(dt).itemsize
        out = (H4K + H4K // 2) * W4K
        g1x[ss] = dict(
            device_ms=device_ms(lambda: KG.blend_levels(*args)),
            ms=cuda_ms(lambda: KG.blend_levels(*args), 20),
            plain_ms=cuda_ms(lambda: KG.blend_levels_plain(*args), 5),
            # G1's bytes; per sample ~14 operations (G1's eight, the
            # difference, its shift, the ramp's clip and the mix)
            bound=bound(3 * out * item, 14 * out))
    results["blend_levels_occlusion"] = dict(g1x[0], max_abs_err=err,
                                             p010=g1x[8])

    # Q1: one bilinear blended position (hopperq, and hopperxq with the
    # occlusion correction), NV12 at the default levels and P010 at
    # (16, 235), t in {0.2, 0.5, 0.8}, on the random planes (rows of the
    # top value) and the block field within +-96 and the one within +-400
    # (negative displacements, cells pushed past every edge), then the
    # same with a random sub-pel field (subpel_flow: the kFrac
    # instantiation); each launch on the 16-byte runs held against the
    # plain version and against the per-sample launch (vector=False), and
    # the per-sample step alone on planes whose pitch is off the 16-byte
    # grid
    frac = torch.from_numpy(rng.integers(0, 64, (2, lh, lw)).astype(
        np.int32)).to(dev)
    for fr, key in ((None, "bilinear_blend"), (frac, "bilinear_blend_frac")):
        q1 = {}
        err = 0
        what = "Q1" if fr is None else "Q1 with frac"
        for dt, ss, levels in ((np.uint8, 0, (0, 255)),
                               (np.uint16, 8, W.level_ints(16, 235))):
            for occlusion in (False, True):
                e = e_ps = 0
                for name, flow in (("block", blurred), ("edge", far)):
                    for t in (0.2, 0.8, 0.5):
                        tt = torch.tensor(t, dtype=torch.float32, device=dev)
                        args = (*warp_args(dt)[:4], flow, tt, rs, W4K, ss,
                                levels, occlusion, fr)
                        got = KQ.bilinear_blend(*args)
                        check(KW.vector_path((*args[:4], *got), W4K),
                              "the 4K planes do not take Q1's 16-byte path")
                        e = max(e, max_err(got,
                                           KQ.bilinear_blend_plain(*args)))
                        e_ps = max(e_ps, max_err(got, KQ.bilinear_blend(
                            *args, vector=False)))
                log(f"  {what} {W4K}x{H4K} scale_shift={ss} levels={levels} "
                    f"occlusion={occlusion}, block and edge flows, t in "
                    f"(0.2, 0.8, 0.5): max_abs_err={e} against the plain "
                    f"version, {e_ps} against the per-sample launch")
                err = max(err, e, e_ps)
                args = (*warp_args(dt), tt, rs, W4K, ss, levels, occlusion,
                        fr)
                item = np.dtype(dt).itemsize
                q1[(ss, occlusion)] = dict(
                    device_ms=device_ms(lambda: KQ.bilinear_blend(*args)),
                    per_sample_device_ms=device_ms(
                        lambda: KQ.bilinear_blend(*args, vector=False)),
                    ms=cuda_ms(lambda: KQ.bilinear_blend(*args), 20),
                    plain_ms=cuda_ms(lambda: KQ.bilinear_blend_plain(*args),
                                     3),
                    bound=q1_bound(item, occlusion, fr is not None, rs,
                                   blurred.numel() * (1 if fr is None
                                                      else 2)))
        # sources whose pitch (3848 samples, 8-bit) is off the 16-byte
        # grid: every run of the launch takes the per-sample step
        pitch = W4K + 8
        odd = [torch.from_numpy(rng.integers(0, 256, (rows, pitch)).astype(
            np.uint8)).to(dev) for rows in (H4K, H4K // 2) * 2]
        check(not KW.vector_path(odd, W4K), "a pitch of 3848 bytes took "
              "the 16-byte path")
        for occlusion in (False, True):
            tt = torch.tensor(0.3, dtype=torch.float32, device=dev)
            args = (*odd, blurred, tt, rs, W4K, 0, (0, 255), occlusion, fr)
            e = max_err(KQ.bilinear_blend(*args),
                        KQ.bilinear_blend_plain(*args))
            log(f"  {what} pitch {pitch} occlusion={occlusion} (per-sample "
                f"step only): max_abs_err={e}")
            err = max(err, e)
        for k_, r in sorted(q1.items()):
            log(f"  {what} scale_shift={k_[0]} occlusion={k_[1]} t=0.5: "
                f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms; "
                f"per-sample launch {r['per_sample_device_ms']:.4f} ms), "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} "
                f"ms ({r['bound'][1]})")
        if fr is None:
            results[key] = dict(q1[(0, True)], max_abs_err=err,
                                p010=q1[(8, True)], nv12=q1[(0, False)])
        else:
            results[key] = dict(q1[(0, False)], max_abs_err=err,
                                p010=q1[(8, True)], nv12=q1[(0, True)])

    results.update(phase_views_kernels(dev, rng, frames, flows, rs))
    results.update(phase_prologue_kernels(dev, rng, flows))

    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms{_device(r)}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}), max_abs_err {r['max_abs_err']}")
        for width in ("p010", "nv12"):
            if width in r:
                q = r[width]
                log(f"  {name} {width.upper()}: kernel {q['ms']:.4f} ms"
                    f"{_device(q)}, plain {q['plain_ms']:.4f} ms, bound "
                    f"{q['bound'][0]:.4f} ms ({q['bound'][1]})")
        if "over2_share" in r:      # V2: the HSV tolerance
            check(r["over2_share"] < HSV_SHARE, f"{name}: a share "
                  f"{r['over2_share']} of the samples is more than 2 from "
                  "its plain version's")
        else:
            check(r["max_abs_err"] == 0, f"{name} disagrees with its plain "
                  f"version (max_abs_err {r['max_abs_err']})")
    return results


# DEVIATIONS #11, the JAX package's HSV tolerance: under this share of the
# samples of a plane may differ by more than 2
HSV_SHARE = 0.005


def view_bound(mode: int, item: int, wa: int = W4K, pitch: int = W4K,
               flow_ints: int = 0):
    """Bytes and operations of one view at one 4K position: the output
    written once, the source samples its outputs read (a copied sample
    one, a warped sample one of each source frame, a filled one none) and
    the flow read once; per warped sample ~45 scalar operations (the cell,
    four flow loads and the back-projection, four products and two
    roundings, two mirrors and the chroma column, two addresses, the blend
    and the level map), and in mode 3 ~65 more for the colours (atan2f
    ~20, the angle, hue, sector and its select ~16, the three scaled and
    clipped channels ~18, the channel's weighted sum, shift and level map
    ~11)."""
    planes = ((H4K, 0), (H4K // 2, 1))
    warped = copied = 0
    for rows, cz in planes:
        if mode == 3:
            warped += rows * wa
        elif mode == 5:
            copied += rows * (wa >> 1)
            warped += rows * (wa - (wa >> 1))
        else:
            band = H4K >> (1 + cz)
            right = max(wa - (pitch >> 1), 0)
            warped += band * right
            copied += band * (wa - right)
    out = (H4K + H4K // 2) * wa
    ops = (45 + (65 if mode == 3 else 0)) * warped + 2 * copied
    return bound((out + copied + 2 * warped) * item + 4 * flow_ints, ops)


def hsv_diff(got, want):
    """(max |diff|, samples that differ, share of a plane's samples more
    than 2 apart at most, up to four (plane, row, column, got, want)) of
    V2's planes against its plain version's."""
    err, n, share, where = 0, 0, 0.0, []
    for plane, g, w in zip(("y", "uv"), got, want):
        g, w = g.to(torch.int32), w.to(torch.int32)
        d = (g - w).abs()
        err = max(err, int(d.max()))
        n += int((d > 0).sum())
        share = max(share, float((d > 2).float().mean()))
        for r, c in torch.nonzero(d)[:4 - len(where)].tolist():
            where.append((plane, r, c, int(g[r, c]), int(w[r, c])))
    return err, n, share, where


def phase_views_kernels(dev, rng, frames, flows, rs):
    """Phase 3, V1 and V2 (the views of modes 5/6 and 3) against their
    plain versions at 4K: 8-bit at the default levels and P010 at (16,
    235), t in {0, 0.4, 1}, the block, edge and odd flows (the P010 planes'
    top rows 65535 since K5's check), and a stride-padded frame (pitch
    3904 over a width of 3840: mode 6 splits at the stride); V1
    bit-exact, V2 within the HSV tolerance with its differing samples
    counted and placed, and on a zero flow (its integer parts alone)
    bit-exact.  Each timed at t = 0.4 on the block flow."""
    from mpv_frame_interpolator_tpu_torch.ops import warp as W
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_views as KV
    pitch = W4K + 64
    padded = {dt: [torch.from_numpy(rng.integers(
        0, np.iinfo(dt).max + 1, (rows, pitch)).astype(dt)).to(dev)
        for rows in (H4K, H4K // 2) * 2] for dt in (np.uint8, np.uint16)}
    zero = torch.zeros_like(flows[0][1])
    out = {}
    for key in ("warp_sbs", "warp_hsv"):
        err, n_diff, share, where, timed = 0, 0, 0.0, [], {}
        for dt, ss, levels in ((np.uint8, 0, (0, 255)),
                               (np.uint16, 8, W.level_ints(16, 235))):
            (f1y, f1uv, _, _), (f2y, f2uv, _, _) = frames[dt]
            cases = [(W4K, (f1y, f1uv, f2y, f2uv), name, flow)
                     for name, flow in flows]
            cases.append((W4K, padded[dt], "padded", flows[0][1]))
            for wa, planes, name, flow in cases:
                for mode in ((5, 6) if key == "warp_sbs" else (3,)):
                    e = 0
                    for t in (0.0, 1.0, 0.4):
                        tt = torch.tensor(t, dtype=torch.float32,
                                          device=dev)
                        args = (*planes, flow, tt, rs, wa, ss, levels)
                        if mode == 3:
                            got = KV.warp_hsv(*args)
                            d = hsv_diff(got, KV.warp_hsv_plain(*args))
                            e = max(e, d[0])
                            n_diff += d[1]
                            share = max(share, d[2])
                            where += d[3][:4 - len(where)]
                        else:
                            got = KV.warp_sbs(mode, *args)
                            e = max(e, max_err(
                                got, KV.warp_sbs_plain(mode, *args)))
                    log(f"  {'V2' if mode == 3 else 'V1'} mode {mode} "
                        f"{wa}x{H4K} pitch {planes[0].shape[1]} "
                        f"scale_shift={ss} levels={levels} {name} flow, t "
                        f"in (0, 1, 0.4): max_abs_err={e}")
                    err = max(err, e)
                    if name == "block" and wa == planes[0].shape[1]:
                        go = ((lambda: KV.warp_hsv(*args)) if mode == 3
                              else (lambda m=mode: KV.warp_sbs(m, *args)))
                        plain = ((lambda: KV.warp_hsv_plain(*args))
                                 if mode == 3 else
                                 (lambda m=mode: KV.warp_sbs_plain(m,
                                                                   *args)))
                        timed[(mode, ss)] = dict(
                            device_ms=device_ms(go), ms=cuda_ms(go, 20),
                            plain_ms=cuda_ms(plain, 3),
                            bound=view_bound(mode, np.dtype(dt).itemsize,
                                             flow_ints=flow.numel()))
            if key == "warp_hsv":
                # a zero flow: no colour, the blend and level maps alone
                tt = torch.tensor(0.4, dtype=torch.float32, device=dev)
                args = (f1y, f1uv, f2y, f2uv, zero, tt, rs, W4K, ss, levels)
                e = max_err(KV.warp_hsv(*args), KV.warp_hsv_plain(*args))
                log(f"  V2 {W4K}x{H4K} scale_shift={ss} levels={levels} "
                    f"zero flow: max_abs_err={e}")
                check(e == 0, f"V2's integer parts disagree with its plain "
                      f"version on a zero flow (max_abs_err {e})")
        for (mode, ss), r in sorted(timed.items()):
            log(f"  {'V2' if mode == 3 else 'V1'} mode {mode} scale_shift="
                f"{ss} t=0.4: kernel {r['ms']:.4f} ms (device "
                f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
        first = 3 if key == "warp_hsv" else 5
        out[key] = dict(timed[(first, 0)], max_abs_err=err,
                        p010=timed[(first, 8)])
        if key == "warp_sbs":
            out[key]["sbs2"] = timed[(6, 0)]
            out[key]["sbs2_p010"] = timed[(6, 8)]
        else:
            out[key].update(differing=n_diff, over2_share=share,
                            where=where)
            log(f"  V2 against its plain version: {n_diff} samples differ "
                f"over every case (max |diff| {err}); the largest share of "
                f"a plane more than 2 apart {share:.6f} (tolerance "
                f"{HSV_SHARE}); first at {where}")
    return out


def c1_bound(geom, rows: int, cols: int, item: int, n: int, scene: bool,
             probe: bool):
    """(bound_ms, bound_by) of C1 on (rows, cols) luma planes: the bytes
    the function needs, each read once -- both luma planes' samples on the
    score's grid (which holds the probe's luma samples), f2's chroma
    samples at the probe's cells (each distinct sample once), the
    positions and the count -- and each written once (the probe, the
    positions, the score, the flag, the count); ~6 operations a score cell
    and ~3 a probe cell."""
    rs, lh, lw = geom.res_scalar, geom.low_h, geom.low_w
    sh, sw = -(-rows // (1 << rs)), -(-cols // (1 << rs))
    nbytes = 4 * n * 2 + 4 + 4 + 4
    ops = 0
    if scene:
        nbytes += 2 * sh * sw * item + 4
        ops += 6 * sh * sw
    if probe:
        cy, cx = np.arange(lh) << rs, np.arange(lw) << rs
        chroma = len(np.unique(cy >> 1)) * len(np.unique(cx >> 1))
        nbytes += (0 if scene else lh * lw * item) + 2 * chroma * item
        nbytes += 3 * lh * lw * item
        ops += 3 * lh * lw
    return bound(nbytes, ops)


def c1_host_split(KC, geom, planes, ts, dev, reps: int = 400) -> dict:
    """The host's microseconds a call of C1's wrapper, by part, on one
    pair's planes with scene detection and the probe: the argument checks
    (``_check``; the card's ``_require``), the outputs' allocations
    (``_outputs``), the stream's handle, the launch (``_launch``: the
    pointers, the ctypes call, the cooperative launch), a ctypes call the
    entry refuses before launching (rows 0: the call's own cost), and the
    whole wrapper with a scratch of its caller's (the engine's) and with a
    new one a call.  Each part is timed over `reps` calls, three rounds in
    turn, and the median round kept; the card keeps up (each launch's
    ~0.005 ms is below its call's host time)."""
    from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
    y1, y2, u2, v2 = planes
    cuts = torch.zeros((), dtype=torch.int32, device=dev)
    partials = KC.scratch(dev)
    out = KC._outputs(geom, y1, ts, True, True)
    lib = _build.load()
    refused = ([t.data_ptr() for t in (y1, y2, u2, v2, ts, out.ts,
                                       *out.probe, out.score, out.cut,
                                       cuts, partials)]
               + [ts.numel(), 0] + [1] * 11
               + [28.0, _build.stream_of(y1)])
    parts = {
        "check": lambda: KC._check(geom, y1, y2, u2, v2, ts, cuts, 0,
                                   "nearest", True),
        "require": lambda: KC._require(geom, y1, y2, u2, v2, ts, cuts,
                                       partials, True),
        "allocate": lambda: KC._outputs(geom, y1, ts, True, True),
        "stream": lambda: _build.stream_of(y1),
        "launch": lambda: KC._launch(geom, y1, y2, u2, v2, ts, cuts,
                                     partials, out, 0, 28.0, "nearest",
                                     False),
        "ctypes_refused": lambda: lib.mfi_pair_prologue(*refused),
        "wrapper": lambda: KC.pair_prologue(geom, y1, y2, u2, v2, ts, cuts,
                                            partials=partials),
        "wrapper_new_scratch": lambda: KC.pair_prologue(geom, y1, y2, u2,
                                                        v2, ts, cuts),
    }
    check(lib.mfi_pair_prologue(*refused) != 0,
          "C1's entry launched with rows 0")
    rounds = {k: [] for k in parts}
    for _ in range(3):
        for name, fn in parts.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            rounds[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in rounds.items()}


def prologue_diff(got, want) -> int:
    """The largest difference between two prologues' outputs: the score's
    bits (as int32), the flag, the positions' bits and the probe bytes."""
    err = 0
    if (got.score is None) != (want.score is None) or \
            (got.probe is None) != (want.probe is None):
        return 1 << 31
    if got.score is not None:
        err = abs(got.score.view(torch.int32).item()
                  - want.score.view(torch.int32).item())
    err = max(err, abs(got.cut.item() - int(want.cut.item())),
              max_abs_err(got.ts.view(torch.int32),
                          want.ts.view(torch.int32)))
    if got.probe is not None:
        err = max(err, max_err(got.probe, want.probe))
    return err


def phase_prologue_kernels(dev, rng, flows):
    """Phase 3, C1 and V3.  C1 against its plain version: 4K NV12 and
    P010, scene detection on and off, threshold 0 (a cut) and 300 (none),
    "nearest" / "hold" with and without "repeat"; a 4K pair whose score is
    float32(28.1) against thresholds 28.1 (no cut: compared in float32)
    and 28.0; a 1086 x 1928 frame (H off the grid, stride past the width)
    with a probe grid three rows and five columns short of the score's
    grid.  Every case exact in the score's bits, the flag, the count, the
    positions and the probe bytes; the cached positions never written.
    Then C1 captured in a CUDA graph and replayed three times (the count
    one higher each replay) and two engines' C1 on two streams at once (8
    launches each), each equal to the plain version.  V3 against
    ``ops/warp.grey_planes`` at 4K NV12 and P010 on the block, edge and
    odd flows, on a flow whose magnitudes wrap int32, and at an odd width
    (a plane's last run written a sample at a time).  Each timed."""
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops.cuda import prologue as KC
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_views as KV
    geom = F.FlowGeometry.create(H4K, W4K, W4K)
    ts = torch.tensor([0.2, 0.4, 0.6, 0.8, 1.0], device=dev)
    keep = ts.clone()
    err, cases = 0, 0

    def compare(what, g, planes, shift, **kw):
        nonlocal err, cases
        cuts = [torch.zeros((), dtype=torch.int32, device=dev)
                for _ in range(2)]
        got = KC.pair_prologue(g, *planes, ts, cuts[0], bit_shift=shift,
                               **kw)
        want = KC.pair_prologue_plain(
            g, *planes, ts, cuts[1], shift, kw.get("scene_enabled", True),
            kw.get("threshold", 28.0), kw.get("cut_policy", "nearest"),
            kw.get("repeat", False), kw.get("probe", True))
        e = max(prologue_diff(got, want), abs(cuts[0].item()
                                              - cuts[1].item()))
        check(e == 0 and torch.equal(ts, keep), f"C1 {what} {kw}: differs "
              f"from its plain version (max diff {e}) or wrote the cached "
              "positions")
        err, cases = max(err, e), cases + 1
        return got, cuts[0].item()

    planes = {}
    for dt in (np.uint8, np.uint16):
        y1 = random_planes(rng, dev, dt)[0]
        y2, _, u2, v2 = random_planes(rng, dev, dt)
        planes[dt] = (y1, y2, u2, v2)
        shift = 8 if dt == np.uint16 else 0
        for scene in (True, False):
            for threshold in (0.0, 300.0):
                for policy, repeat in (("nearest", False), ("hold", False),
                                       ("nearest", True), ("hold", True)):
                    _, cut = compare("4K", geom, planes[dt], shift,
                                     scene_enabled=scene,
                                     threshold=threshold, cut_policy=policy,
                                     repeat=repeat)
                    check(cut == int(scene and threshold == 0.0),
                          f"C1 4K: {cut} cuts at threshold {threshold}")
        log(f"  C1 4K {np.dtype(dt).name}: 16 cases (scene on/off, a cut "
            f"and none, nearest/hold, repeat) equal to the plain version")
    # a score of float32(28.1): 28 on the score's grid, 29 on a tenth of it
    grid = np.full((geom.low_h, geom.low_w), 28, np.uint8)
    grid.reshape(-1)[:grid.size // 10] = 29
    y2 = np.full((H4K, W4K), 28, np.uint8)
    y2[::8, ::8] = grid
    tenth = (torch.zeros((H4K, W4K), dtype=torch.uint8, device=dev),
             torch.from_numpy(y2).to(dev), *planes[np.uint8][2:])
    for threshold, want_cut in ((28.1, 0), (28.0, 1)):
        got, cut = compare("4K score float32(28.1)", geom, tenth, 0,
                           threshold=threshold)
        check(got.score.item() == float(np.float32(28.1))
              and cut == want_cut,
              f"C1 at threshold {threshold}: score {got.score.item()!r}, "
              f"{cut} cuts")
    log(f"  C1 4K score {float(np.float32(28.1))!r} = float32(28.1): no cut "
        "at threshold 28.1, a cut at 28.0")
    # the score's grid and the probe's differ: the probe is written only
    # inside the geometry's lh x lw
    odd = F.FlowGeometry.create(1086, 1928, 1920)
    short = F.FlowGeometry(odd.height, odd.stride, odd.actual_width,
                           odd.res_scalar, odd.low_h - 3, odd.low_w - 5,
                           odd.start_window, odd.iterations)
    shapes = ((1086, 1928),) * 2 + ((543, 964),) * 2
    y1s, y2s, *uvs = [torch.from_numpy(rng.integers(0, 256, shape).astype(
        np.uint8)).to(dev) for shape in shapes]
    for g, what in ((odd, "1086x1928"), (short, "1086x1928, probe grid "
                                                "short of the score's")):
        for threshold in (0.0, 300.0):
            got, _ = compare(what, g, (y1s, y2s, *uvs), 0,
                             threshold=threshold, cut_policy="hold")
        check(tuple(got.probe[0].shape) == (g.low_h, g.low_w),
              f"C1 {what}: probe {tuple(got.probe[0].shape)}")
    log(f"  C1 1086x1928 (score grid {odd.low_h}x{odd.low_w}, probe grid "
        f"{short.low_h}x{short.low_w} too): equal")
    # graph capture and replay: the count rises by one a replay; every
    # launch shares one scratch, as an engine's pairs do
    cuts = torch.zeros((), dtype=torch.int32, device=dev)
    shared = KC.scratch(dev)
    eager = KC.pair_prologue(geom, *planes[np.uint8], ts, cuts,
                             threshold=0.0, partials=shared)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        KC.pair_prologue(geom, *planes[np.uint8], ts, cuts, threshold=0.0,
                         partials=shared)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = KC.pair_prologue(geom, *planes[np.uint8], ts, cuts,
                                    threshold=0.0, partials=shared)
    torch.cuda.synchronize()
    counted = [cuts.item()]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        e = prologue_diff(captured, eager)
        check(e == 0, f"C1 replayed differs from the eager launch ({e})")
        counted.append(cuts.item())
    check(counted == [2, 3, 4, 5], f"C1's count over three replays: "
          f"{counted}")
    log(f"  C1 in a CUDA graph, three replays: equal, the count {counted}")
    del graph, captured
    # two engines' prologues on two streams at once: a scratch a launch,
    # then a scratch a stream (an engine's own, shared by its launches)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    kws = [dict(bit_shift=0, threshold=0.0, cut_policy="nearest"),
           dict(bit_shift=8, threshold=0.0, cut_policy="hold",
                repeat=True)]
    for own in (False, True):
        counts2 = [torch.zeros((), dtype=torch.int32, device=dev)
                   for _ in range(2)]
        scratch = [KC.scratch(dev) if own else None for _ in range(2)]
        torch.cuda.synchronize()
        outs = [[], []]
        for _ in range(8):
            for i, dt in enumerate((np.uint8, np.uint16)):
                with torch.cuda.stream(streams[i]):
                    outs[i].append(KC.pair_prologue(
                        geom, *planes[dt], ts, counts2[i],
                        partials=scratch[i], **kws[i]))
        torch.cuda.synchronize()
        for i, dt in enumerate((np.uint8, np.uint16)):
            kw = kws[i]
            want = KC.pair_prologue_plain(
                geom, *planes[dt], ts, torch.zeros((), dtype=torch.int32,
                                                   device=dev),
                kw["bit_shift"], True, 0.0, kw["cut_policy"],
                kw.get("repeat", False), True)
            e = max(prologue_diff(g, want) for g in outs[i])
            check(e == 0 and counts2[i].item() == 8,
                  f"C1 on stream {i} (own scratch {own}): max diff {e}, "
                  f"count {counts2[i].item()}")
        log(f"  C1 on two streams at once (NV12 nearest, P010 hold + "
            f"repeat), 8 launches each, "
            f"{'a scratch a stream' if own else 'a scratch a launch'}: "
            f"equal, each count 8")
        del outs

    timed = {}
    for dt in (np.uint8, np.uint16):
        args = (geom, *planes[dt], ts)
        shift = 8 if dt == np.uint16 else 0
        cuts = torch.zeros((), dtype=torch.int32, device=dev)

        def go():
            return KC.pair_prologue(*args, cuts, bit_shift=shift)

        def plain():
            return KC.pair_prologue_plain(*args, cuts, shift, True, 28.0,
                                          "nearest", False, True)

        timed[dt] = dict(device_ms=device_ms(go), ms=cuda_ms(go, 50),
                         plain_ms=cuda_ms(plain, 20),
                         bound=c1_bound(geom, H4K, W4K,
                                        np.dtype(dt).itemsize, 5, True,
                                        True))
    out = {"pair_prologue": dict(timed[np.uint8], max_abs_err=err,
                                 cases=cases, p010=timed[np.uint16])}
    split = c1_host_split(KC, geom, planes[np.uint8], ts, dev)
    log("  C1's wrapper on the host, us a call (4K NV12, scene detection "
        "and the probe; median of 3 rounds of 400 calls): " + ", ".join(
            f"{k} {v:.2f}" for k, v in split.items()))

    # V3
    err = 0
    wrap = flows[0][1].clone()
    wrap[0, 0, :8] = (1 << 30) + (1 << 29)
    wrap[1, -1, -8:] = -(1 << 30)
    gt = {}
    for dt, ss in ((torch.uint8, 0), (torch.uint16, 8)):
        for name, flow in (*flows, ("wrapping", wrap)):
            args = (flow, geom.res_scalar, H4K, W4K, ss, dt)
            e = max_err(KV.warp_grey(*args), KV.warp_grey_plain(*args))
            log(f"  V3 {W4K}x{H4K} scale_shift={ss} {name} flow: "
                f"max_abs_err={e}")
            err = max(err, e)
        args = (flows[0][1], geom.res_scalar, H4K, W4K - 2, ss, dt)
        e = max_err(KV.warp_grey(*args), KV.warp_grey_plain(*args))
        log(f"  V3 {W4K - 2}x{H4K} scale_shift={ss} (rows off the 16-byte "
            f"grid): max_abs_err={e}")
        err = max(err, e)
        args = (flows[0][1], geom.res_scalar, H4K, W4K, ss, dt)
        item = 2 if ss else 1
        gt[ss] = dict(
            device_ms=device_ms(lambda: KV.warp_grey(*args)),
            ms=cuda_ms(lambda: KV.warp_grey(*args), 50),
            plain_ms=cuda_ms(lambda: KV.warp_grey_plain(*args), 20),
            bound=bound((H4K + H4K // 2) * W4K * item
                        + 4 * flows[0][1].numel(), 8 * H4K * W4K))
    out["warp_grey"] = dict(gt[0], max_abs_err=err, p010=gt[8])
    for name, r in out.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}); P010 kernel "
            f"{r['p010']['ms']:.4f} ms (device "
            f"{r['p010']['device_ms']:.4f} ms), plain "
            f"{r['p010']['plain_ms']:.4f} ms, bound "
            f"{r['p010']['bound'][0]:.5f} ms")
    return out


def phase_probes(dev, smi: str):
    """Phase 3b: P1 and P2 through their entry points (their counters set
    to 0 just before and read just after; P1's is one launch), then each
    timed against its plain version on the same card inputs: P1's every
    entry bit-exact at its default shifts and at shifts that wrap, sit on
    the 16-byte grid and leave it, with the device time of a launch that
    does nothing beside its own."""
    from mpv_frame_interpolator_tpu_torch.tools import dma_probe as DP
    from mpv_frame_interpolator_tpu_torch.tools import pack_probe as PP
    results = {}
    for name, mod in (("pack_probe", PP), ("dma_probe", DP)):
        log(f"  python -m mpv_frame_interpolator_tpu_torch.tools.{name}:")
        mod.counts.reset()
        # P2's verdicts must stay the H100's (dma_probe.H100_VERDICTS)
        rc = mod.main(["--expect-h100"] if mod is DP else [])
        launches, plain = mod.counts.kernel, mod.counts.plain
        check(rc == 0, f"{name} failed (exit code {rc})")
        check(launches > 0 and plain == 0,
              f"{name}: {launches} launches, {plain} plain calls")
        results[name] = dict(launches=launches)
    check(results["pack_probe"]["launches"] == 1,
          f"pack_probe: {results['pack_probe']['launches']} launches for "
          "every probe, not 1")

    x = PP.make_inputs(0, dev)
    entries = range(len(PP.PROBES))
    got = PP.run_all(x)
    want = [PP.plain_at(i, x) for i in entries]
    check(all(g.dtype == w.dtype and g.shape == w.shape
              for g, w in zip(got, want)),
          "pack_probe: an output's shape or dtype is not its plain version's")
    err = max_err(got, want)
    for shifts in ((0, 0), (16, 4), (17, 1), (PP.C - 1, PP.R - 1)):
        err = max(err, max_err(PP.run_all(x, *shifts),
                               [PP.plain_at(i, x, *shifts) for i in entries]))
    # every input read once, every output written once
    nbytes = sum(t.numel() for t in x.values()) + sum(
        t.numel() * t.element_size() for t in got)
    floor = launch_floor_ms()
    results["pack_probe"].update(
        max_abs_err=err,
        device_ms=device_ms(lambda: PP.run_all(x)),
        ms=cuda_ms(lambda: PP.run_all(x), 20),
        plain_ms=cuda_ms(lambda: [PP.plain_at(i, x) for i in entries], 20),
        bound=bound(nbytes, 0))
    log(f"  pack_probe: {nbytes} bytes moved; one launch that does nothing "
        f"(torch.cuda._sleep(0)) takes {floor:.4f} device ms on {smi}")

    # the cases that run in this process and are OK, each through its
    # mechanism
    runs = []
    for case in DP.CASES:
        for mech in DP.MECHANISMS:
            if not DP.in_child(mech, case[0], case[2]) \
                    and DP.run_case(mech, *case, dev) == "OK":
                runs.append((DP.cp_async_window if mech == "cp.async"
                             else DP.tma_window,
                             DP.source(case[0], dev), *case[1:]))
    got = [fn(src, *w) for fn, src, *w in runs]
    want = [DP.window_plain(src, *w) for _, src, *w in runs]
    nbytes = 2 * sum(t.numel() * t.element_size() for t in got)
    results["dma_probe"].update(
        max_abs_err=max_err(got, want),
        device_ms=device_ms(lambda: [fn(src, *w) for fn, src, *w in runs],
                            len(runs)),
        ms=cuda_ms(lambda: [fn(src, *w) for fn, src, *w in runs], 20),
        plain_ms=cuda_ms(lambda: [DP.window_plain(src, *w)
                                  for _, src, *w in runs], 20),
        # one PyTorch call a case computes the same function: the slice
        # copy (which is also the plain version)
        library_ms=cuda_ms(lambda: [src[dy:dy + r, dx:dx + c].clone()
                                    for _, src, dy, dx, r, c in runs], 20),
        # the same copies' own device time, beside the probe's device_ms
        library_device_ms=device_ms(lambda: [
            src[dy:dy + r, dx:dx + c].clone()
            for _, src, dy, dx, r, c in runs], len(runs)),
        bound=bound(nbytes, 0))
    for name, r in results.items():
        log(f"  {name}: kernels {r['ms']:.4f} ms (device {r['device_ms']:.4f} "
            f"ms), plain {r['plain_ms']:.4f} ms, "
            + (f"library {r['library_ms']:.4f} ms (device "
               f"{r['library_device_ms']:.4f} ms), " if "library_ms" in r
               else "")
            + f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"max_abs_err {r['max_abs_err']}, launches {r['launches']}")
        check(r["max_abs_err"] == 0, f"{name} disagrees with its plain "
              "version")
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


def same_frame(a, b) -> bool:
    return np.array_equal(a.y, b.y) and np.array_equal(a.uv, b.uv)


def near_frame(a, b) -> bool:
    """Mode 3's tolerance, the JAX package's own for its float colour
    math: under 0.5% of the samples of each plane differ by more than 2."""
    return all(np.mean(np.abs(p.astype(int) - q.astype(int)) > 2) < 0.005
               for p, q in ((a.y, b.y), (a.uv, b.uv)))


def phase_reference(dev):
    """Phase 4: the engine on the card against the engine on the CPU (the
    plain versions, which the CPU tests hold bit-exact against the JAX
    package) on small clips: every output frame and pts equal; each
    case's launch counters set to 0 just before it and read just after:
    no flow kernel for blend and repeat, K1 once a pair otherwise, K5
    twice and G1 once an output for hopperx's blend, Q1 once an output
    for hopperq's and hopperxq's."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)

    # (clip, width, height, radius, display fps, P010, sampler, levels,
    # output mode, model): res scalars 0 and 1, a width that is not a
    # multiple of a warp, scene cuts, 8-bit and P010, every sampler,
    # levels that round half to even, modes 0-6, every model family
    tv = (16.5, 235.0)
    dl = (0, 255)
    cases = [c + ("hopper",) for c in [
        ("gradient_pan", 320, 180, 5, 120.0, False, "pair", dl, 2),
        ("moving_box", 640, 360, 16, 120.0, False, "pair", dl, 2),
        ("moving_box", 202, 118, 16, 60.0, False, "pair", dl, 2),
        ("scene_cut", 320, 180, 16, 60.0, False, "pair", dl, 2),
        ("moving_box", 202, 118, 16, 120.0, True, "fused", tv, 2),
        ("scene_cut", 320, 180, 16, 60.0, True, "pair", tv, 2),
        ("scene_cut", 320, 180, 16, 60.0, True, "fused", tv, 2),
        ("moving_box", 202, 118, 16, 120.0, False, "pair", dl, 0),
        ("scene_cut", 320, 180, 16, 60.0, True, "pallas", tv, 0),
        ("scene_cut", 320, 180, 16, 60.0, False, "pallas", dl, 1),
        ("moving_box", 202, 118, 16, 120.0, True, "pair", tv, 1),
        ("scene_cut", 320, 180, 16, 60.0, False, "pair", tv, 4),
        ("moving_box", 202, 118, 16, 120.0, True, "pallas", dl, 4),
        ("scene_cut", 320, 180, 16, 60.0, False, "pallas", tv, 2),
        ("moving_box", 202, 118, 16, 120.0, True, "pallas", tv, 2),
        ("gradient_pan", 320, 180, 5, 60.0, False, "pair", dl, 3),
        ("scene_cut", 320, 180, 16, 60.0, True, "pallas", tv, 3)]]
    # every model in mode 2 under its default sampler, NV12 and P010 at
    # TV levels; hopperx and hopperq under "fused" and "pallas"; modes 5
    # and 6 with hopper and blend
    for model in ("hopperx", "hopperq", "hopperxq", "blend", "repeat"):
        cases.append(("scene_cut", 202, 118, 16, 60.0, False, "pair", dl, 2,
                      model))
        cases.append(("moving_box", 202, 118, 16, 120.0, True, "pair", tv,
                      2, model))
    for model in ("hopperx", "hopperq"):
        cases.append(("gradient_pan", 202, 118, 5, 60.0, False, "fused", tv,
                      2, model))
        cases.append(("scene_cut", 202, 118, 16, 60.0, True, "pallas", dl,
                      2, model))
    for mode in (5, 6):
        cases.append(("moving_box", 202, 118, 16, 60.0, False, "pair", dl,
                      mode, "hopper"))
        cases.append(("scene_cut", 202, 118, 16, 60.0, True, "pair", tv,
                      mode, "blend"))
    # the auto-quality path: radii above 16, the sub-pel flow of each
    # family kind, and the ladder's rungs pinned (res scalars 1 and 2 of
    # a 202 x 544 frame where level 0 runs 2; level 3 the blend family)
    cases += [
        ("scene_cut", 202, 118, 24, 60.0, False, "pair", dl, 2, "hopper",
         {}),
        ("moving_box", 202, 118, 64, 120.0, True, "fused", tv, 2, "hopper",
         {}),
        ("scene_cut", 202, 118, 8, 60.0, False, "pair", dl, 2, "hopperq",
         {"subpel_flow": True}),
        ("moving_box", 202, 118, 16, 120.0, True, "pair", tv, 2,
         "hopperxq", {"subpel_flow": True}),
        ("scene_cut", 202, 118, 5, 60.0, True, "pair", tv, 2, "hopper",
         {"subpel_flow": True}),
        ("moving_box", 202, 544, 5, 60.0, False, "pair", dl, 2, "hopper",
         {"level": 1}),
        ("scene_cut", 202, 544, 5, 60.0, True, "fused", tv, 2, "hopper",
         {"level": 2}),
        ("moving_box", 202, 544, 5, 60.0, False, "pair", dl, 2, "hopper",
         {"level": 3})]
    # the cut folded by C1 and K1's blur phase: the "hold" policy (modes 2
    # and 4) and the repeat family under P010 on clips with a cut
    cases += [
        ("scene_cut", 202, 118, 16, 60.0, False, "pair", dl, 2, "hopper",
         {"cut_policy": "hold"}),
        ("scene_cut", 202, 118, 16, 60.0, True, "fused", tv, 2, "hopper",
         {"cut_policy": "hold"}),
        ("scene_cut", 202, 118, 16, 60.0, True, "pair", tv, 4, "hopper",
         {"cut_policy": "hold"}),
        ("scene_cut", 202, 118, 16, 60.0, True, "fused", tv, 2, "repeat",
         {})]
    counts = kernel_counts()
    for case in cases:
        name, w, h, radius, display, p010, sampling, levels, mode, model = \
            case[:10]
        shown = case[10] if len(case) > 10 else {}
        extra = dict(shown)
        level = extra.pop("level", 0)
        t0 = time.perf_counter()
        engines = [InterpolationEngine(EngineConfig(
            display_fps=display, frame_output_mode=mode, auto_quality=False,
            initial_search_radius=radius, warp_sampling=sampling,
            black_level=levels[0], white_level=levels[1], model=model,
            device=d, **extra))
            for d in ("cpu", str(dev))]
        for e in engines:
            e.quality.level = level
        n = pairs = 0
        what = (f"mode {mode} {model} {name} {w}x{h} "
                f"{'P010' if p010 else 'NV12'} {sampling} levels {levels} "
                f"radius {radius}"
                + "".join(f" {k}={v}" for k, v in shown.items()))
        for c in counts.values():
            c.reset()
        for frame in synthetic_frames(name, w, h, 7, p010):
            outs = [e.push(frame) for e in engines]
            check(len(outs[0]) == len(outs[1]),
                  f"{what}: output counts differ on the card and the CPU")
            # a passed-through source frame keeps its host planes
            warped = sum(isinstance(o.device_planes()[0], torch.Tensor)
                         for o in outs[1])
            pairs += warped > 0
            n += warped
            for a, b in zip(*outs):
                fa, fb = a.to_video_frame(), b.to_video_frame()
                same = same_frame if mode != 3 else near_frame
                check(a.pts == b.pts and same(fa, fb),
                      f"{what}: output at pts {a.pts} differs between the "
                      "card and the CPU")
                check(fb.y.shape == (h, w) and fb.uv.shape == (h // 2, w),
                      f"{what}: output planes {fb.y.shape} {fb.uv.shape}")
                check(fb.y.dtype == (np.uint16 if p010 else np.uint8),
                      f"{what}: output dtype {fb.y.dtype}")
        launches = {k: c.kernel for k, c in counts.items()}
        flow = 0 if model in ("blend", "repeat") or level == 3 else pairs
        blended = mode == 2
        subpel = extra.get("subpel_flow", False)
        # S1 and the blur run as phases of K1's launch, never on their own
        check(launches["subpel_refine"] == launches["blur_flow"] == 0
              and counts["subpel_refine"].fused == (flow if subpel else 0)
              and counts["blur_flow"].fused == flow,
              f"{what}: S1 and the standalone K3 launched "
              f"{launches['subpel_refine']} and {launches['blur_flow']} "
              f"times, S1's and K3's phases ran "
              f"{counts['subpel_refine'].fused} and "
              f"{counts['blur_flow'].fused} times for {pairs} pairs")
        check(launches["flow_step"] == flow,
              f"{what}: K1 launched {launches['flow_step']} times for "
              f"{pairs} pairs")
        if blended and model == "hopperx":
            check(launches["sample_dir"] == 2 * n
                  and launches["blend_levels"] == n,
                  f"{what}: K5 and G1 launched {launches['sample_dir']} and "
                  f"{launches['blend_levels']} times for {n} outputs")
        bilinear = n if blended and model in ("hopperq", "hopperxq") \
            and level != 3 else 0
        check(launches["bilinear_blend"] == bilinear,
              f"{what}: Q1 launched {launches['bilinear_blend']} times for "
              f"{n} outputs")
        # the views: mode 3 V2 once an output and no K5 or G1, modes 5 and
        # 6 V1 once an output, under any sampler and model
        views = (n if mode == 3 else 0, n if mode in (5, 6) else 0)
        check((launches["warp_hsv"], launches["warp_sbs"]) == views,
              f"{what}: V2 and V1 launched {launches['warp_hsv']} and "
              f"{launches['warp_sbs']} times for {n} outputs")
        # C1 once a pair, whatever the model and mode; V3 once a pair in
        # mode 4
        check(launches["pair_prologue"] == pairs
              and launches["warp_grey"] == (pairs if mode == 4 else 0),
              f"{what}: C1 and V3 launched {launches['pair_prologue']} and "
              f"{launches['warp_grey']} times for {pairs} pairs")
        if mode in (3, 4, 5, 6):
            check(launches["sample_dir"] == launches["blend_levels"] == 0,
                  f"{what}: K5 and G1 launched {launches['sample_dir']} "
                  f"and {launches['blend_levels']} times")
        cuts = [e.scene_cuts() for e in engines]
        check(cuts[0] == cuts[1], f"{what}: scene cuts differ: {cuts}")
        if name != "gradient_pan":
            check((cuts[1] > 0) == (name == "scene_cut"),
                  f"{what}: {cuts[1]} scene cuts")
        log(f"  {what} -> {display:g} fps: {n} warped outputs equal over "
            f"{pairs} pairs, scene cuts {cuts[1]}, launches "
            f"{ {k: v for k, v in launches.items() if v} } "
            f"({time.perf_counter() - t0:.1f} s)")


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
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blend_levels as KG
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.ops.cuda import prologue as KC
    from mpv_frame_interpolator_tpu_torch.ops.cuda import subpel as KP
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_bilinear as KQ
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KD
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_views as KV
    return {"flow_step": KS.counts, "blur_flow": KB.counts,
            "pair_blend": KW.counts, "fused_blend": KF.counts,
            "sample_dir": KD.counts, "blend_levels": KG.counts,
            "bilinear_blend": KQ.counts, "subpel_refine": KP.counts,
            "warp_sbs": KV.sbs_counts, "warp_hsv": KV.hsv_counts,
            "warp_grey": KV.grey_counts, "pair_prologue": KC.counts}


def run_cli(dev, frames: int, extra, auto_quality: bool = False,
            stats_out=None):
    """The port's CLI at 4K 24 -> 120, radius 16, y4m sink, with every
    launch counter set to 0 just before and read just after; checks the
    outputs, that no plain version ran, that the blur ran inside each
    pair's K1 launch and never on its own, and that the views of modes 3,
    5 and 6 ran their kernel once an output and nowhere else.  Returns the
    launches of each kernel, "blur_fused" the blurs run inside K1's
    launches; `stats_out`, a dict, gets the run's --dump-stats.  The
    auto-quality controller is off unless `auto_quality`."""
    from mpv_frame_interpolator_tpu_torch import cli
    counts = kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.y4m")
        stats_path = os.path.join(tmp, "stats.json")
        # --cache no: `--cache auto` would spool the synthetic clip (it
        # cannot seek), a 4K frame written to a temporary file each
        argv = ["synthetic:moving_box", "--width", str(W4K), "--height",
                str(H4K), "--fps", "24", "--frames", str(frames),
                "--display-fps", "120", "--search-radius", "16",
                *([] if auto_quality else ["--no-auto-quality"]),
                "--untimed", "--cache", "no",
                "--device", str(dev), "-o", out, "--dump-stats", stats_path,
                *extra]
        for c in counts.values():
            c.reset()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launches = {k: c.kernel for k, c in counts.items()}
        launches["blur_fused"] = counts["blur_flow"].fused
        launches["subpel_fused"] = counts["subpel_refine"].fused
        plain = {k: c.plain for k, c in counts.items()}
        with open(stats_path) as fh:
            stats = json.load(fh)
        if stats_out is not None:
            stats_out.update(stats)
        y4m = (*y4m_frames(out), os.path.getsize(out))
    check(rc == 0, f"cli returned {rc}")
    check(stats["engine_failures"] == 0,
          f"{stats['engine_failures']} engine failures (fail-open)")
    # the first source frame passes through (in mode 6 it is interpolated,
    # paired with itself); at 24 -> 120 every later one gives the 5
    # outputs of its pair
    mode = extra[extra.index("--mode") + 1] if "--mode" in extra else "blend"
    expected = 5 * frames if mode == "sbs2" else 1 + 5 * (frames - 1)
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
    pairs = frames - 1 + (mode == "sbs2")
    warped = expected if mode == "sbs2" else expected - 1
    views = (warped if mode == "hsv" else 0,
             warped if mode in ("sbs1", "sbs2") else 0)
    check((launches["warp_hsv"], launches["warp_sbs"]) == views,
          f"V2 and V1 launched {launches['warp_hsv']} and "
          f"{launches['warp_sbs']} times in mode {mode}, not {views}")
    # C1 once a pair on every path, V3 once a pair in mode 4
    check(launches["pair_prologue"] == pairs
          and launches["warp_grey"] == (pairs if mode == "grey" else 0),
          f"C1 and V3 launched {launches['pair_prologue']} and "
          f"{launches['warp_grey']} times for {pairs} pairs in mode {mode}")
    # the blur is K1's last phase; under --subpel-flow S1's two phases run
    # in the same launch before it: no standalone S1 or K3
    subpel = "--subpel-flow" in extra
    check(launches["flow_step"] == pairs
          and launches["blur_fused"] == pairs
          and launches["subpel_fused"] == (pairs if subpel else 0)
          and launches["blur_flow"] == launches["subpel_refine"] == 0,
          f"K1 and its blur phase launched {launches['flow_step']} and "
          f"{launches['blur_fused']} times for {pairs} pairs, S1's phases "
          f"{launches['subpel_fused']} times, K3 on its own "
          f"{launches['blur_flow']} times, S1 "
          f"{launches['subpel_refine']} times (subpel_flow {subpel})")
    model = extra[extra.index("--model") + 1] if "--model" in extra \
        else "hopper"
    blends = 5 * pairs if "pallas" in extra or model == "hopperx" else 0
    check(launches["blend_levels"] == blends,
          f"G1 launched {launches['blend_levels']} times, not {blends}")
    bilinear = 5 * pairs if model in ("hopperq", "hopperxq") else 0
    check(launches["bilinear_blend"] == bilinear,
          f"Q1 launched {launches['bilinear_blend']} times, not {bilinear}")
    return launches


def phase_main_path(dev):
    """Phase 5: the 8-bit main path, CLI at 4K 24 -> 120, radius 16."""
    frames = 8
    launches = run_cli(dev, frames, [])
    check(launches["pair_blend"] > 0,
          f"K2 never launched on the main path: {launches}")
    check(launches["fused_blend"] == 0 and launches["sample_dir"] == 0,
          f"K4 or K5 ran on the pair sampler's path: {launches}")
    return launches


def phase_p010_path(dev):
    """Phase 6: P010 with TV levels on the fused sampler, CLI at 4K."""
    launches = run_cli(dev, 4, ["--p010", "--warp-sampling", "fused",
                                "--black-level", "16", "--white-level",
                                "235"])
    check(launches["fused_blend"] > 0,
          f"K4 never launched on the P010 fused path: {launches}")
    check(launches["pair_blend"] == 0 and launches["sample_dir"] == 0,
          f"K2 or K5 ran on the fused sampler's path: {launches}")
    return launches


def phase_warp12_path(dev):
    """Phase 7: output mode 0 (warp12), CLI at 4K 24 -> 120, radius 16."""
    launches = run_cli(dev, 6, ["--mode", "warp12"])
    check(launches["pair_blend"] == 0 and launches["fused_blend"] == 0,
          f"K2 or K4 ran on the warp12 path: {launches}")
    check(launches["sample_dir"] == 5 * (6 - 1),
          f"K5 launched {launches['sample_dir']} times for 25 outputs")
    return launches


def phase_pallas_path(dev):
    """Phase 8: mode 2 under the "pallas" sampler, CLI at 4K: K5 twice
    and G1 once an output (G1's count is checked by run_cli)."""
    frames = 4
    launches = run_cli(dev, frames, ["--warp-sampling", "pallas"])
    outputs = 5 * (frames - 1)
    check(launches["sample_dir"] == 2 * outputs,
          f"K5 launched {launches['sample_dir']} times for {outputs} "
          "blended outputs, not twice each")
    check(launches["pair_blend"] == 0 and launches["fused_blend"] == 0,
          f"the pallas path's launches: {launches}")
    return launches


def phase_hopperxq_path(dev):
    """Phase 9: model hopperxq (1/64-pel bilinear blend with occlusion),
    CLI at 4K 24 -> 120, radius 16: K1 once a pair and Q1 once an output
    (both checked by run_cli), and no other warp kernel."""
    launches = run_cli(dev, 4, ["--model", "hopperxq"])
    check(launches["bilinear_blend"] == 5 * 3 and launches["flow_step"] == 3,
          f"the hopperxq path's launches: {launches}")
    check(launches["pair_blend"] == launches["fused_blend"]
          == launches["sample_dir"] == 0,
          f"a nearest sampler ran on the hopperxq path: {launches}")
    return launches


def phase_hopperx_path(dev):
    """Phase 10: model hopperx (occlusion-aware blend), CLI at 4K: K5
    twice and G1 (its occlusion variant) once an output."""
    frames = 3
    launches = run_cli(dev, frames, ["--model", "hopperx"])
    outputs = 5 * (frames - 1)
    check(launches["sample_dir"] == 2 * outputs
          and launches["pair_blend"] == launches["fused_blend"] == 0,
          f"the hopperx path's launches: {launches}")
    return launches


def phase_subpel_path(dev):
    """Phase 11: model hopperq with the measured sub-pel flow, CLI at 4K
    24 -> 120, radius 16: K1 once a pair with S1's phases and the blur
    phase inside it, no standalone S1 or K3, Q1 (with the sub-pel field)
    once an output (all checked by run_cli)."""
    frames = 4
    launches = run_cli(dev, frames, ["--model", "hopperq", "--subpel-flow"])
    pairs = frames - 1
    log(f"  launches a pair: K1 {launches['flow_step'] / pairs:g} (S1's "
        f"phases {launches['subpel_fused'] / pairs:g}, blur phase "
        f"{launches['blur_fused'] / pairs:g}), S1 standalone "
        f"{launches['subpel_refine'] / pairs:g}, K3 standalone "
        f"{launches['blur_flow'] / pairs:g}, Q1 "
        f"{launches['bilinear_blend'] / pairs:g}")
    check(launches["pair_blend"] == launches["fused_blend"]
          == launches["sample_dir"] == 0,
          f"a nearest sampler ran on the sub-pel hopperq path: {launches}")
    return launches


def _same_outputs(a, b, pts_tol: float = 0.0) -> bool:
    """Whether two engines' outputs of one pair are equal, on the card
    (their pts within `pts_tol`: an engine that starts mid-stream sums
    its output pts from another origin)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        for p, q in zip(x.device_planes(), y.device_planes()):
            if p.dtype == torch.uint16:
                p, q = p.view(torch.int16), q.view(torch.int16)
            if abs(x.pts - y.pts) > pts_tol or not torch.equal(p, q):
                return False
    return True


def phase_ladder(dev):
    """Phase 12: the auto-quality ladder on the card at 4K 24 -> 120.  An
    engine with auto-quality on, radius 16 and the default ladder ((2, 2),
    (3, 4), (3, 4, blend)) is fed over-budget durations (the source frame
    time) until it has walked the radius 16 -> 5 and then levels 1 -> 2 ->
    3, then durations far under budget until it has unwound to level 0 and
    radius 16.  Every pair's outputs must equal those of a static engine
    configured at the geometry and model of the level it ran (level 0 at
    its radius).  Then each level's device ms a pair and K1's launches a
    pair (the blend rung must launch none), the counters set to 0 just
    before and read just after."""
    from torch.profiler import ProfilerActivity, profile
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    from mpv_frame_interpolator_tpu_torch.profile_pair import self_device_us

    def make(**kw):
        return InterpolationEngine(EngineConfig(
            display_fps=120.0, measure_timing=False, device=str(dev), **kw))

    dyn = make(auto_quality=True, initial_search_radius=16)
    rungs = dyn.config.degrade_rungs
    base = F.FlowGeometry.create(H4K, W4K, W4K)
    statics = [make(auto_quality=False, initial_search_radius=16)]
    for d_iter, div, model in rungs:
        statics.append(make(auto_quality=False, initial_search_radius=5,
                            max_calc_res=max(270 // div, 64),
                            num_iterations=max(base.iterations - d_iter, 1),
                            model=model or "hopper", degrade_rungs=()))
    frames = [dyn.stage(f) for f in synthetic_frames("moving_box", W4K, H4K,
                                                     32)]
    sft = None
    walk = []
    down = True
    compared = [0] * len(statics)
    for f in frames:
        if sft is not None:
            dyn._last_calc_duration = sft if down else sft / 100
        outs = dyn.push(f)
        sft = dyn.cadence.source_frame_time
        radius, level = dyn.quality.search_radius, dyn.quality.level
        statics[0].quality.search_radius = radius
        ref = [e.push(f) for e in statics]
        if outs and isinstance(outs[0].device_planes()[0], torch.Tensor):
            check(_same_outputs(outs, ref[level]),
                  f"ladder: level {level} radius {radius}: the outputs "
                  "differ from the static engine's at that rung")
            compared[level] += 1
        walk.append((radius, level))
        if level == len(rungs):
            down = False
    torch.cuda.synchronize()
    log(f"  (radius, level) after each push: {walk}")
    radii_down = [r for r, lvl in walk if lvl == 0]
    check(walk[-1] == (16, 0), f"ladder did not recover: ends at "
          f"{walk[-1]}")
    peak = walk.index((5, len(rungs)))
    path = [w for i, w in enumerate(walk[:peak + 1])
            if i == 0 or w != walk[i - 1]]
    check(path == [(r, 0) for r in range(16, 4, -1)]
          + [(5, lvl) for lvl in range(1, len(rungs) + 1)],
          f"ladder walked down {path}")
    back = [w for i, w in enumerate(walk[peak:])
            if i == 0 or w != walk[peak + i - 1]]
    check(back == [(5, lvl) for lvl in range(len(rungs), -1, -1)]
          + [(r, 0) for r in range(6, 17)],
          f"ladder walked back {back}")
    check(all(compared), f"pairs compared a level: {compared}")
    log(f"  walked 16 -> 5, levels 1 -> {len(rungs)} and back; pairs equal "
        f"to the static engine at each level: {compared} (radii at level 0:"
        f" {sorted(set(radii_down))})")

    counts = kernel_counts()
    per_level = {}
    for level, radius in ((0, 16), (0, 5), (1, 5), (2, 5), (3, 5)):
        e = make(auto_quality=False, initial_search_radius=radius)
        e.quality.level = level
        for f in frames[:4]:
            e.push(f)
        torch.cuda.synchronize()
        for c in counts.values():
            c.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for f in frames[4:10]:
                e.push(f)
            torch.cuda.synchronize()
        pairs = 6
        dev_ms = sum(self_device_us(x) for x in prof.key_averages()) / 1e3
        k1 = counts["flow_step"].kernel
        geom = e._geoms[level]
        model = e._model_for(level, e._knobs())
        log(f"  level {level} radius {radius} ({model}, "
            f"calc {geom.low_h}x{geom.low_w} rs {geom.res_scalar}, "
            f"{geom.iterations} iterations): device "
            f"{dev_ms / pairs:.4f} ms a pair, K1 {k1 / pairs:g} a pair, "
            f"launches {({k: c.kernel for k, c in counts.items() if c.kernel})}")
        check(k1 == (0 if model == "blend" else pairs),
              f"level {level}: K1 launched {k1} times in {pairs} pairs")
        check(not any(c.plain for c in counts.values()),
              f"level {level}: a plain version ran")
        per_level[(level, radius)] = dict(device_ms=dev_ms / pairs,
                                          k1_per_pair=k1 / pairs)
    return per_level


def phase_engine_rate(dev, p010: bool = False, sampling: str = "pair",
                      mode: int = 2):
    """Steady-state engine throughput at 4K 24 -> 120, radius 16, frames
    pre-staged on the card, each pair synchronised (no sink).  On the
    pair sampler in mode 2, K2 must be one device launch a pair (both
    planes, every position): pairs pushed under torch.profiler."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    levels = (16, 235) if p010 else (0, 255)
    eng = InterpolationEngine(EngineConfig(
        display_fps=120.0, frame_output_mode=mode, auto_quality=False,
        initial_search_radius=16,
        warp_sampling=sampling, black_level=levels[0],
        white_level=levels[1], device=str(dev)))
    k2_rows = sampling == "pair" and mode == 2
    # a K2 trace takes 2 pairs, after 2 untraced, and up to 4 retakes
    staged = [eng.stage(f) for f in synthetic_frames(
        "moving_box", W4K, H4K, 24 if k2_rows else 12, p010)]
    staged, more = staged[:12], iter(staged[12:])
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
    log(f"  engine mode {mode} {'P010' if p010 else 'NV12'} {sampling} "
        f"levels "
        f"{levels}: {pairs} pairs, {n} outputs in {dt * 1e3:.1f} ms = "
        f"{dt / pairs * 1e3:.3f} ms/pair wall, {n / dt:.1f} out-fps")
    if k2_rows:
        rows = kernel_rows(lambda: [eng.push(next(more)) for _ in range(2)],
                           expect=4)
        k2 = {k: v for k, v in rows.items() if "pair_blend_kernel" in k}
        launches = sum(c for c, _ in k2.values())
        log(f"  K2 on 2 pairs of the engine: {launches} device launches, "
            f"{sum(us for _, us in k2.values()) / 2e3:.4f} device ms a pair")
        check(launches == 2, f"K2 took {launches} device launches for 2 "
              f"pairs, not one a pair: {rows}")


OUR_KERNELS = ("pyramid_kernel", "pair_blend_kernel", "fused_blend_kernel",
               "blur_kernel", "sample_dir_kernel", "blend_levels_kernel",
               "bilinear_blend_kernel", "slice_kernel", "warp_sbs_kernel",
               "warp_hsv_kernel", "warp_grey_kernel", "pair_prologue_kernel")


def write_y4m(path: str, frames, width: int, height: int,
              p010: bool = False):
    from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MWriter
    with open(path, "wb") as fh:
        w = Y4MWriter(fh, width, height, 24.0, "p010" if p010 else "nv12")
        for f in frames:
            w.write(f)


def same_bytes(a: str, b: str) -> bool:
    """Whether two files hold the same bytes (read 16 MB at a time)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def phase_player(dev):
    """Phase 13: the player at 4K.  A 24-frame 4K NV12 y4m file runs
    through the CLI (24 -> 120, radius 16, y4m sink) three ways: with the
    prefetcher's staged uploads (page-locked reads, the copy stream), with
    --no-stage-uploads, and with --group 8 (push_many, CUDA graph
    replays).  The three outputs must be byte-equal, no engine failure
    counted, no plain version run, and K1 launched once a pair (grouped:
    once a pair of each replay and of each graph's warm-up); prints each
    run's wall split a pair, out-fps and calc ms a pair.  Returns the
    launches of the staged run."""
    from mpv_frame_interpolator_tpu_torch import cli
    counts = kernel_counts()
    n = 24
    pairs = n - 1
    expected = 1 + 5 * pairs
    equal = {}
    staged_launches = None
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        t0 = time.perf_counter()
        write_y4m(src, synthetic_frames("moving_box", W4K, H4K, n), W4K,
                  H4K)
        log(f"  source: {n} frames of {W4K}x{H4K} NV12, "
            f"{os.path.getsize(src)} bytes, written in "
            f"{time.perf_counter() - t0:.1f} s")
        ref = os.path.join(tmp, "ref.y4m")
        for name, extra in (("staged uploads", []),
                            ("no staged uploads", ["--no-stage-uploads"]),
                            ("--group 8", ["--group", "8"])):
            out = ref if not extra else os.path.join(tmp, "out.y4m")
            stats_path = os.path.join(tmp, "stats.json")
            argv = [src, "--display-fps", "120", "--search-radius", "16",
                    "--no-auto-quality", "--untimed", "--frames", "0",
                    "--device", str(dev), "-o", out, "--dump-stats",
                    stats_path, *extra]
            for c in counts.values():
                c.reset()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t0
            launches = {k: c.kernel for k, c in counts.items()}
            plain = {k: c.plain for k, c in counts.items()}
            with open(stats_path) as fh:
                stats = json.load(fh)
            frames = y4m_frames(out)
            if out != ref:
                equal[name] = same_bytes(out, ref)
                os.remove(out)
            check(rc == 0, f"{name}: cli returned {rc}")
            check(stats["engine_failures"] == 0,
                  f"{name}: {stats['engine_failures']} engine failures")
            check(stats["frames_out"] == expected and frames[2] == expected,
                  f"{name}: {stats['frames_out']} outputs, the y4m holds "
                  f"{frames[2]}, the cadence expects {expected}")
            check(not any(plain.values()),
                  f"{name}: a plain version ran: {plain}")
            graphs = stats["graphs"]
            if graphs:
                k1 = sum(g["key"][3] * (g["replays"] + 1) for g in graphs)
                total = sum(g["kernel_launches"] * (g["replays"] + 1)
                            for g in graphs)
                check(launches["flow_step"] == k1
                      and sum(launches.values()) == total,
                      f"{name}: launches {launches} against the graphs' "
                      f"{graphs}")
            else:
                check(launches["flow_step"] == pairs
                      and launches["pair_blend"] == pairs,
                      f"{name}: K1 {launches['flow_step']} and K2 "
                      f"{launches['pair_blend']} launches for {pairs} "
                      f"pairs")
            if not extra:
                staged_launches = launches
            w = stats["wall"]
            pair = stats["stats"].get("source_frame_time", {})
            log(f"  {name}: {stats['frames_in']} source -> "
                f"{stats['frames_out']} frames in {wall:.2f} s = "
                f"{stats['frames_out'] / wall:.1f} out-fps (cli "
                f"{stats['seconds']:.2f} s); calc ms a pair mean "
                f"{pair.get('mean', 0) * 1e3:.3f} over "
                f"{pair.get('count', 0)}; engine failures "
                f"{stats['engine_failures']}, underruns {stats['underruns']}")
            captures = sum(g["capture_s"] for g in graphs)
            log(f"    wall split, ms a pair: source read "
                f"{w['read'] / pairs * 1e3:.3f} (reader thread), upload "
                f"{w['upload_device'] / pairs * 1e3:.3f} (copy-stream "
                f"events; reader thread's stage calls "
                f"{w['stage'] / pairs * 1e3:.3f}), engine "
                f"{w['engine'] / pairs * 1e3:.3f} (of it graph captures "
                f"{captures / pairs * 1e3:.3f}), download "
                f"{w['download'] / pairs * 1e3:.3f}, y4m write "
                f"{w['write'] / pairs * 1e3:.3f}; launches {launches}")
            if graphs:
                log(f"    graphs: {graphs}; group stats "
                    f"{stats['group_stats']}")
    log(f"  the same bytes as the staged run's: {equal}")
    check(all(equal.values()),
          f"the three runs wrote different bytes: {equal}")
    return staged_launches


def _run_engine(e, frames, group: int, keep: bool = True):
    """push (group 1) or push_many the frames; the outputs, or none when
    not `keep` (each chunk's outputs dropped as a sink would drop them,
    so their memory goes back to the allocator's cache)."""
    outs = []
    step = 1 if group == 1 else group
    for i in range(0, len(frames), step):
        chunk = frames[i:i + step]
        got = (e.push(chunk[0]) if group == 1
               else e.push_many(chunk, group_size=group))
        if keep:
            outs += got
    return outs


def phase_grouped_engine(dev, p010: bool = False, sampling: str = "pair"):
    """Phase 14: the grouped engine at 4K 24 -> 120, radius 16, frames
    staged on the card: push (group 1) and push_many in groups of 4 and 8
    (one CUDA graph replay a group).  Each group size first runs warm
    pairs and a window of 32 pairs keeping every output: the grouped
    outputs must equal push's, bit for bit.  Then a fresh engine, after
    the same warm pairs (each group size's graph captured), runs two
    windows of 32 pairs timed on the host clock to a synchronise (engine
    wall; outputs dropped as a sink would), and a third under
    torch.profiler (device ms, busy share, kernel rows).  The launches a
    pair counted by the wrappers (grouped: each graph's captured launches
    times its replays) and the profiler's rows of the port's kernels a
    pair must equal push's.  Under push the kernel launches a pair are
    C1, K1 and the warp's (3 on the 8-bit "pair" path: C1, K1, K2; 7 on
    P010 "fused": C1, K1, five K4), and the pair's device rows (printed)
    are those kernels and the read-back of the previous pair's cut score
    alone: no tensor op.  Returns {group: numbers}."""
    from torch.profiler import ProfilerActivity, profile
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    from mpv_frame_interpolator_tpu_torch.profile_pair import self_device_us
    levels = (16, 235) if p010 else (0, 255)

    def make():
        return InterpolationEngine(EngineConfig(
            display_fps=120.0, auto_quality=False, initial_search_radius=16,
            warp_sampling=sampling, black_level=levels[0],
            white_level=levels[1], device=str(dev)))

    pairs = 32
    base = make()
    frames = [base.stage(f) for f in synthetic_frames(
        "moving_box", W4K, H4K, 1 + 16 + 3 * pairs, p010)]
    warm = frames[:17]
    windows = [frames[17 + i * pairs:17 + (i + 1) * pairs] for i in range(3)]
    counts = kernel_counts()
    what = f"{'P010' if p010 else 'NV12'} {sampling}"
    ref = None
    results = {}
    for group in (1, 4, 8):
        e = make()
        _run_engine(e, warm, group)
        outs = _run_engine(e, windows[0], group)
        torch.cuda.synchronize()
        if ref is None:
            ref = outs
        else:
            check(len(ref) == len(outs) and all(
                _same_outputs([x], [y]) for x, y in zip(ref, outs)),
                f"{what} group {group}: outputs differ from push's")
        del outs

        e = make()
        _run_engine(e, warm, group, keep=False)
        torch.cuda.synchronize()
        walls = []
        for n, window in enumerate(windows[:2]):
            if n == 1:
                for c in counts.values():
                    c.reset()
                before = dict(e.group_stats)
            t0 = time.perf_counter()
            _run_engine(e, window, group, keep=False)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / pairs * 1e3)
        launches = sum(c.kernel for c in counts.values())
        host = {k: e.group_stats[k] - before[k] for k in before}
        check(not any(c.plain for c in counts.values()),
              f"{what} group {group}: a plain version ran")
        for attempt in range(3):
            # a trace now and then drops device rows: one that counts a
            # fraction of a kernel a pair (push) or differs from push's
            # is taken again, on a new engine warmed the same way
            if attempt:
                e = make()
                _run_engine(e, warm, group, keep=False)
                torch.cuda.synchronize()
            # opened with spin kernels (left out of the rows): a trace this
            # late in the script loses its first device records
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                spin_opening()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _run_engine(e, windows[2], group, keep=False)
                torch.cuda.synchronize()
                pwall = time.perf_counter() - t0
            rows = [(ev.key, ev.count, self_device_us(ev))
                    for ev in prof.key_averages()
                    if self_device_us(ev) > 0 and "spin" not in ev.key]
            dev_ms = sum(r[2] for r in rows) / 1e3 / pairs
            kernel_rows = sum(r[1] for r in rows
                              if any(k in r[0] for k in OUR_KERNELS)) / pairs
            if (kernel_rows == round(kernel_rows) if group == 1
                    else kernel_rows == push_counts[1]):
                break
            log(f"  {what} group {group}: the trace counted {kernel_rows} "
                f"kernel rows a pair; taken again")
        check(dev_ms > 0, f"{what} group {group}: no device rows")
        if group == 1:
            push_counts = (launches, kernel_rows)
            host_launches = sum(r[1] for r in rows) / pairs
            host_what = "every device op enqueued from Python"
            device_rows = {k[:70]: [round(c / pairs, 3),
                                    round(us / 1e3 / pairs, 5)]
                           for k, c, us in sorted(rows, key=lambda r: -r[2])}
            log(f"  {what} push: the device rows of a pair (count, ms) "
                f"{json.dumps(device_rows)}")
            other = {k: c / pairs for k, c, _ in rows
                     if not any(n in k for n in OUR_KERNELS)}
            want = 3 if sampling == "pair" else 7
            check(launches / pairs == want and kernel_rows == want,
                  f"{what} push: {launches / pairs} kernel launches and "
                  f"{kernel_rows} kernel rows a pair, not {want}")
            check(all("Memcpy DtoH" in k and c == 1
                      for k, c in other.items()),
                  f"{what} push: device rows other than the port's kernels "
                  f"and the score's read-back: {other}")
        else:
            check((launches, kernel_rows) == push_counts,
                  f"{what} group {group}: {launches} launches and "
                  f"{kernel_rows} profiler kernel rows a pair, push "
                  f"{push_counts}")
            host_launches = (host["replays"] + host["copies"]) / pairs
            host_what = (f"graph launches {host['replays'] / pairs:.3f} + "
                         f"copies {host['copies'] / pairs:.3f}")
        wall = min(walls)
        results[group] = dict(device_ms=dev_ms, wall_ms=walls,
                              busy=dev_ms / wall,
                              busy_profiled=dev_ms / (pwall / pairs * 1e3),
                              host_launches=host_launches,
                              kernel_launches=launches / pairs)
        if group == 1:
            results[group]["device_rows"] = device_rows
        graphs = [(g["key"][3], g["bytes"], round(g["capture_s"], 3))
                  for g in e.graph_stats()]
        log(f"  {what} group {group}: device {dev_ms:.4f} ms a pair "
            f"(profiler), engine wall {walls[0]:.4f} / {walls[1]:.4f} ms a "
            f"pair (two windows), device / engine wall {dev_ms / wall:.3f} "
            f"(busy share under the profiler "
            f"{dev_ms / (pwall / pairs * 1e3):.3f}, its wall "
            f"{pwall / pairs * 1e3:.4f} ms a pair); host launches a pair "
            f"{host_launches:.3f} ({host_what}); kernel launches a pair "
            f"{launches / pairs:.3f} (profiler kernel rows "
            f"{kernel_rows:.3f}); graphs (k, bytes, capture s) {graphs}")
    return results


def phase_player_commands(dev):
    """Phase 15: seek, loop and end on the card.  A 64x48 y4m clip of 12
    frames through the pipeline on the card and on the CPU: a seek back to
    frame 3 after the 7th output and one loop (staged uploads, page-locked
    reads on the card), and the CLI with --loop 1 --end 0.4: the card's
    frames, pts and bytes equal the CPU's, no engine failure, the card
    runs no plain version."""
    from mpv_frame_interpolator_tpu_torch import cli
    from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool
    from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MReader
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    from mpv_frame_interpolator_tpu_torch.pipeline.player import Pipeline
    counts = kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "clip.y4m")
        write_y4m(src, synthetic_frames("moving_box", 64, 48, 12), 64, 48)
        runs = {}
        for device in ("cpu", str(dev)):
            for c in counts.values():
                c.reset()
            frames = []
            pipe_ref = []

            class Sink:
                def write(self, out):
                    f = out.to_video_frame()
                    frames.append((out.pts, np.array(f.y), np.array(f.uv)))
                    if len(frames) == 7:
                        pipe_ref[0].seek(3 / 24.0)

                def close(self):
                    pass

            engine = InterpolationEngine(EngineConfig(
                display_fps=60.0, auto_quality=False,
                initial_search_radius=8, device=device))
            with open(src, "rb") as fh:
                pipe = Pipeline(Y4MReader(fh, pool=PinnedPool(8, device)),
                                engine, Sink(), present=None)
                pipe_ref.append(pipe)
                pipe.loop = 1
                pipe.run()
            check(pipe.engine_failures() == 0,
                  f"{device}: {pipe.engine_failures()} engine failures")
            out = os.path.join(tmp, f"out-{device}.y4m")
            check(cli.main([src, "--device", device, "--untimed",
                            "--no-auto-quality", "--loop", "1", "--end",
                            "0.4", "--frames", "0", "-o", out]) == 0,
                  f"{device}: cli --loop 1 --end 0.4 failed")
            with open(out, "rb") as fh:
                cli_bytes = fh.read()
            if device != "cpu":
                check(not any(c.plain for c in counts.values()),
                      "a plain version ran on the card")
                check(counts["flow_step"].kernel > 0,
                      "K1 never launched on the card")
            runs[device] = (frames, pipe.seeks, pipe.frames_in, cli_bytes)
        (a, sa, na, ca), (b, sb, nb, cb) = runs.values()
        check((sa, na) == (sb, nb) == (2, na) and len(a) == len(b) > 0,
              f"seeks / frames in: CPU {(sa, na)}, card {(sb, nb)}")
        check(all(p == q and np.array_equal(y1, y2)
                  and np.array_equal(u1, u2)
                  for (p, y1, u1), (q, y2, u2) in zip(a, b)),
              "seek + loop: the card's frames differ from the CPU's")
        check(ca == cb and ca.count(b"FRAME") > 0,
              "--loop 1 --end 0.4: the card's bytes differ from the CPU's")
        log(f"  seek + loop: {len(b)} frames, {sb} seeks, {nb} source "
            f"frames, equal to the CPU; --loop 1 --end 0.4: "
            f"{cb.count(b'FRAME')} frames, {len(cb)} bytes, equal")


def write_containers(tmp: str, frames, width: int, height: int):
    """One clip written three ways with the port's writers: y4m,
    Matroska V_UNCOMPRESSED (I420 payloads) and FFV1 Matroska (the
    native encoder).  Returns {kind: path} and the native FFV1 encode ms
    of each frame."""
    from mpv_frame_interpolator_tpu_torch import native
    from mpv_frame_interpolator_tpu_torch.io.mkv import MKVWriter
    lib = native.load()
    paths = {k: os.path.join(tmp, f"in.{k}") for k in
             ("y4m", "raw.mkv", "ffv1.mkv")}
    write_y4m(paths["y4m"], frames, width, height)
    enc = lib.ffv1_enc_create(width, height, 8)
    encode_ms = []
    with open(paths["raw.mkv"], "wb") as raw, \
            open(paths["ffv1.mkv"], "wb") as ffv1:
        wr = MKVWriter(raw, width, height, 24.0,
                       codec_id="V_UNCOMPRESSED")
        wf = MKVWriter(ffv1, width, height, 24.0, codec_id="V_FFV1")
        for i, f in enumerate(frames):
            y = f.y.tobytes()
            u = np.ascontiguousarray(f.uv[:, 0::2]).tobytes()
            v = np.ascontiguousarray(f.uv[:, 1::2]).tobytes()
            wr.add(y + u + v, pts=i / 24.0)
            t0 = time.perf_counter()
            pkt = lib.ffv1_encode(enc, y, u, v, True)
            encode_ms.append((time.perf_counter() - t0) * 1e3)
            wf.add(pkt, pts=i / 24.0)
        wr.close()
        wf.close()
    return paths, encode_ms


def run_source_cli(dev, argv, pairs_expected=None):
    """The port's CLI with every launch counter set to 0 just before and
    read just after: (stats, launches).  Checks no engine failure, no
    plain version (on the card), K1 (and K2) once a pair and the
    cadence's output count (24 -> 120: 5 outputs a pair after the
    first frame)."""
    from mpv_frame_interpolator_tpu_torch import cli
    counts = kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        stats_path = os.path.join(tmp, "stats.json")
        for c in counts.values():
            c.reset()
        t0 = time.perf_counter()
        rc = cli.main([*argv, "--device", str(dev), "--dump-stats",
                       stats_path])
        wall = time.perf_counter() - t0
        launches = {k: c.kernel for k, c in counts.items()}
        plain = {k: c.plain for k, c in counts.items()}
        with open(stats_path) as fh:
            stats = json.load(fh)
    stats["wall_s"] = wall
    name = " ".join(a for a in argv if not a.startswith("/"))
    check(rc == 0, f"{name}: cli returned {rc}")
    check(stats["engine_failures"] == 0,
          f"{name}: {stats['engine_failures']} engine failures")
    pairs = stats["frames_in"] - 1
    if pairs_expected is not None:
        check(pairs == pairs_expected,
              f"{name}: {stats['frames_in']} source frames, expected "
              f"{pairs_expected + 1}")
    check(stats["frames_out"] == 1 + 5 * pairs,
          f"{name}: {stats['frames_out']} outputs, the cadence expects "
          f"{1 + 5 * pairs}")
    if torch.device(dev).type == "cuda":
        check(not any(plain.values()), f"{name}: a plain version ran: "
              f"{plain}")
        check(launches["flow_step"] == pairs
              and launches["pair_blend"] == pairs,
              f"{name}: K1 {launches['flow_step']} and K2 "
              f"{launches['pair_blend']} launches for {pairs} pairs")
    return stats, launches


def phase_sources_sinks(dev):
    """Phase 16: the CLI's sources and sinks on the card.  An 8-frame 4K
    NV12 clip written as y4m, raw Matroska and FFV1 Matroska runs through
    the CLI at 24 -> 120, radius 16: y4m through the Python reader (the
    reference) and the native ring, raw MKV through the Python reader
    and the native indexed ring, FFV1 MKV in with FFV1 MKV out; every
    output equals the reference frame for frame (the FFV1 output decoded
    by the native decoder).  Then small clips on the card against the
    CPU, byte for byte: a playlist (y4m + FFV1 MKV) under --cache yes,
    --play-direction backward, --start at the third frame, a --vf chain
    and Ut Video in Matroska through the VfW codec id.  Prints each 4K
    run's out-fps and wall split a pair and the native FFV1 ms of one 4K
    frame."""
    from mpv_frame_interpolator_tpu_torch import native
    from mpv_frame_interpolator_tpu_torch.io import ffv1, utvideo
    from mpv_frame_interpolator_tpu_torch.io.mkv import MKVReader, MKVWriter
    from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MReader
    n = 8
    pairs = n - 1
    common = ["--display-fps", "120", "--search-radius", "16",
              "--no-auto-quality", "--untimed", "--frames", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        frames = synthetic_frames("moving_box", W4K, H4K, n)
        paths, encode_ms = write_containers(tmp, frames, W4K, H4K)
        log(f"  sources: {n} frames of {W4K}x{H4K} NV12 as y4m "
            f"({os.path.getsize(paths['y4m'])} bytes), raw MKV "
            f"({os.path.getsize(paths['raw.mkv'])} bytes) and FFV1 MKV "
            f"({os.path.getsize(paths['ffv1.mkv'])} bytes), written in "
            f"{time.perf_counter() - t0:.1f} s")
        # one 4K frame through the native FFV1 codec, alone
        lib = native.load()
        f0 = frames[n // 2]
        planes = (f0.y.tobytes(),
                  np.ascontiguousarray(f0.uv[:, 0::2]).tobytes(),
                  np.ascontiguousarray(f0.uv[:, 1::2]).tobytes())
        enc = lib.ffv1_enc_create(W4K, H4K, 8)
        dec = ffv1.FFV1Decoder(W4K, H4K)
        enc_ms, dec_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            pkt = lib.ffv1_encode(enc, *planes, True)
            t1 = time.perf_counter()
            got = dec.decode(pkt)
            t2 = time.perf_counter()
            enc_ms.append((t1 - t0) * 1e3)
            dec_ms.append((t2 - t1) * 1e3)
        check(all(np.array_equal(g.reshape(-1), np.frombuffer(p, np.uint8))
                  for g, p in zip(got, planes)),
              "the native FFV1 round trip of a 4K frame is not lossless")
        log(f"  native FFV1, one {W4K}x{H4K} 8-bit 4:2:0 frame on the "
            f"host: encode {statistics.median(enc_ms):.1f} ms, decode "
            f"{statistics.median(dec_ms):.1f} ms (median of 3; "
            f"{len(pkt)} bytes, {len(pkt) / sum(map(len, planes)):.3f} "
            f"of raw); writing the source: "
            f"{statistics.median(encode_ms):.1f} ms a frame")
        del frames
        ref = os.path.join(tmp, "ref.y4m")
        runs = (("y4m, --ingest python (reference)", paths["y4m"],
                 ["--ingest", "python"], ref),
                ("y4m, --ingest native", paths["y4m"],
                 ["--ingest", "native"], None),
                ("raw MKV, --ingest python", paths["raw.mkv"],
                 ["--ingest", "python"], None),
                ("raw MKV, --ingest native", paths["raw.mkv"],
                 ["--ingest", "native"], None),
                ("FFV1 MKV in, FFV1 MKV out", paths["ffv1.mkv"], [],
                 os.path.join(tmp, "out.mkv")))
        equal = {}
        for name, src, extra, out in runs:
            out = out or os.path.join(tmp, "out.y4m")
            stats, launches = run_source_cli(
                dev, [src, *common, *extra, "-o", out], pairs)
            w = stats["wall"]
            log(f"  {name}: {stats['frames_in']} source -> "
                f"{stats['frames_out']} frames in {stats['wall_s']:.2f} s "
                f"= {stats['frames_out'] / stats['wall_s']:.1f} out-fps; "
                f"wall split, ms a pair: read and decode "
                f"{w['read'] / pairs * 1e3:.3f} (reader thread), upload "
                f"{w['upload_device'] / pairs * 1e3:.3f} (copy-stream "
                f"events; stage calls {w['stage'] / pairs * 1e3:.3f}), "
                f"engine {w['engine'] / pairs * 1e3:.3f}, download "
                f"{w['download'] / pairs * 1e3:.3f}, "
                f"{'encode' if out.endswith('.mkv') else 'y4m write'} "
                f"{w['write'] / pairs * 1e3:.3f}; launches {launches}")
            if out == ref:
                continue
            if out.endswith(".mkv"):
                with open(ref, "rb") as fh:
                    want = Y4MReader(fh, device="cpu")
                    got = MKVReader(out)
                    frames_seen = 0
                    same = True
                    for a, b in zip(want, got):
                        same &= same_frame(a, b)
                        frames_seen += 1
                        a.recycle()
                    same &= (frames_seen == got.n_frames()
                             == 1 + 5 * pairs)
                    got.close()
                equal[name] = same
            else:
                equal[name] = same_bytes(out, ref)
            os.remove(out)
        log(f"  the same frames as the reference run's: {equal}")
        check(all(equal.values()),
              f"a 4K source run differs from the reference: {equal}")

    # small clips: the card against the CPU, byte for byte
    w, h = 64, 48
    small = ["--display-fps", "120", "--no-auto-quality", "--untimed",
             "--frames", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        a = os.path.join(tmp, "a.y4m")
        write_y4m(a, synthetic_frames("moving_box", w, h, 6), w, h)
        b_frames = synthetic_frames("gradient_pan", w, h, 5)
        paths, _ = write_containers(tmp, b_frames, w, h)
        tall = os.path.join(tmp, "tall.y4m")
        write_y4m(tall, synthetic_frames("moving_box", w, 64, 6), w, 64)
        # Ut Video in Matroska through the VfW codec id: a 40-byte
        # BITMAPINFOHEADER (biSize, width, height, planes, bit count,
        # fourcc, image size, then zeros) and the codec's extradata
        ut = os.path.join(tmp, "ut.mkv")
        bih = b"".join(v.to_bytes(k, "little") for v, k in (
            (40 + 16, 4), (w, 4), (h, 4), (1, 2), (24, 2))) + b"ULY0" \
            + (w * h * 3).to_bytes(4, "little") + bytes(16)
        with open(ut, "wb") as fh:
            mw = MKVWriter(fh, w, h, 24.0, codec_id="V_MS/VFW/FOURCC",
                           codec_private=bih + utvideo.make_extradata(3))
            for i, f in enumerate(b_frames):
                mw.add(utvideo.encode_frame(
                    [f.y, np.ascontiguousarray(f.uv[:, 0::2]),
                     np.ascontiguousarray(f.uv[:, 1::2])], slices=3,
                    pred=utvideo.PRED_MEDIAN), pts=i / 24.0)
            mw.close()
        cases = (("playlist y4m + FFV1 MKV, --cache yes",
                  [a, paths["ffv1.mkv"], "--cache", "yes"], 11),
                 ("--play-direction backward",
                  [a, "--play-direction", "backward"], 6),
                 ("--start at the third frame",
                  [a, "--start", str(2 / 24.0)], 4),
                 ("--vf crop=64:48:0:8,vflip",
                  [tall, "--vf", "crop=64:48:0:8,vflip"], 6),
                 ("Ut Video in MKV (VfW)", [ut], 5))
        same = {}
        for name, argv, frames_in in cases:
            outs = []
            for device in ("cpu", dev):
                out = os.path.join(tmp, f"out-{torch.device(device).type}"
                                   ".y4m")
                stats, launches = run_source_cli(
                    device, [*argv, *small, "-o", out], frames_in - 1)
                with open(out, "rb") as fh:
                    outs.append(fh.read())
            same[name] = outs[0] == outs[1] and outs[0].count(b"FRAME") \
                == stats["frames_out"]
            log(f"  {name}: {stats['frames_in']} source -> "
                f"{stats['frames_out']} frames, the card's bytes equal "
                f"the CPU's: {same[name]}; launches on the card "
                f"{launches}")
        check(all(same.values()),
              f"a small source run on the card differs from the CPU: "
              f"{same}")


# the property script of phase 17: (source-frame index, [(property,
# value)]) set through api.Player just before that frame; eight frames
# between changes, so push_many's groups of 4 and 8 fall between them
CONTROL_SCRIPT = [
    (8, [("frame-output-mode", 0)]),
    (16, [("frame-output-mode", 3), ("black-level", 16),
          ("white-level", 235)]),
    (24, [("frame-output-mode", 2), ("delta-scalar", 4),
          ("neighbor-bias-scalar", 2), ("search-radius", 5)]),
    (32, [("search-radius", 16), ("model", "hopperx")]),
    (40, [("model", "hopper"), ("scene-threshold", 0.0)]),
    (48, [("max-calc-res", 135), ("scene-threshold", 28.0)]),
    (56, [("max-calc-res", 270)]),
]
CONTROL_FRAMES = 64
# the properties whose change shows in the outputs of any clip
VISIBLE = ("frame-output-mode", "black-level", "white-level",
           "scene-threshold")


def _static_config(player, dev):
    """The EngineConfig of a fresh engine at the player's live settings."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import EngineConfig
    g = player.get_property
    return EngineConfig(
        display_fps=120.0, auto_quality=False, measure_timing=False,
        frame_output_mode=g("frame-output-mode"),
        black_level=g("black-level"), white_level=g("white-level"),
        delta_scalar=g("delta-scalar"),
        neighbor_bias_scalar=g("neighbor-bias-scalar"),
        initial_search_radius=g("search-radius"), model=g("model"),
        max_calc_res=g("max-calc-res"),
        scene_detection=g("scene-detection"),
        scene_threshold=g("scene-threshold"), device=str(dev))


def _interpolated(outs) -> bool:
    """Whether a push's outputs are interpolated (on the engine's device),
    not a source frame passed through (host planes)."""
    return bool(outs) and isinstance(outs[0].device_planes()[0],
                                     torch.Tensor)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def control_script_push(dev, frames, stats_log: str):
    """Check 1: the script through api.Player (push).  Each segment of
    constant settings is held against a fresh engine built at them and
    fed from the frame before the segment (the flow anchor; after a
    max-calc-res change the engine derives its geometry again and starts
    anew from the segment's first frame, as the fresh one does): every
    interpolated output equal; the first pair after each change equal to
    the new settings' engine and, where the change shows in the picture,
    different from the old settings' engine.  Returns the outputs a
    frame, the host ms of each push (synchronised) and the pairs each
    change took to land."""
    from mpv_frame_interpolator_tpu_torch.api import Player
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    player = Player(EngineConfig(
        display_fps=120.0, auto_quality=False, initial_search_radius=16,
        stats_log_path=stats_log, device=str(dev)))
    changes = dict(CONTROL_SCRIPT)
    outs, ms = [], []
    static = old = None
    landed, differs, compared = [], [], 0
    for i, f in enumerate(frames):
        before = None
        if i == 0 or i in changes:
            for name, value in changes.get(i, []):
                player.set_property(name, value)
            old = static
            static = InterpolationEngine(_static_config(player, dev))
            regeom = any(n == "max-calc-res" for n, _ in changes.get(i, []))
            if i > 0 and not regeom:
                static.push(frames[i - 1])
            first = i
        _sync(dev)
        t0 = time.perf_counter()
        got = player.feed(f)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        want = static.push(f)
        outs.append(got)
        if old is not None:
            before = old.push(f)
            if i > first:
                old = None
        if not _interpolated(got):
            check(not _interpolated(want),
                  f"frame {i}: passed through, the static engine did not")
            continue
        check(_same_outputs(got, want, 1e-9),
              f"frame {i}: the outputs differ from a fresh engine at its "
              f"settings {changes.get(first, '(initial)')}")
        compared += 1
        if first > 0 and i == next(j for j in range(first, i + 1)
                                   if _interpolated(outs[j])):
            # the change's first pair: as the new settings; against the
            # old settings' pair where the change shows in any picture (a
            # mode, the levels, the cut threshold: the clip's small
            # motion can leave the flow's knobs without a visible effect)
            landed.append(i)
            if any(n in VISIBLE for n, _ in changes[first]):
                differs.append(_interpolated(before)
                               and not _same_outputs(got, before, 1e-9))
    player.engine.flush()
    with open(stats_log) as fh:
        lines = fh.read().splitlines()
    timed = player.engine.stats.count("source_frame_time")
    check(len(lines) == timed > 0 and all(float(x) > 0 for x in lines),
          f"the stats log holds {len(lines)} lines for {timed} timed pairs")
    check(len(landed) == len(CONTROL_SCRIPT) and len(differs) == 5
          and all(differs), f"changes landed at {landed}; against the old "
          f"settings the first pair differed: {differs}")
    return outs, ms, landed, compared, timed


def control_script_groups(dev, frames, ref, group: int):
    """Check 2: the same script under push_many, a call per group with
    the changes between calls; every output equal to push's.  Returns
    (host ms of each call, synchronised, and whether it captured)."""
    from mpv_frame_interpolator_tpu_torch.api import Player
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import EngineConfig
    player = Player(EngineConfig(
        display_fps=120.0, auto_quality=False, initial_search_radius=16,
        measure_timing=False, device=str(dev)))
    e = player.engine
    changes = dict(CONTROL_SCRIPT)
    calls = []
    got = []
    for a in range(0, len(frames), group):
        for name, value in changes.get(a, []):
            player.set_property(name, value)
        captures = e.group_stats["captures"]
        _sync(dev)
        t0 = time.perf_counter()
        got += e.push_many(frames[a:a + group], group_size=group)
        _sync(dev)
        calls.append(((time.perf_counter() - t0) * 1e3,
                      e.group_stats["captures"] > captures))
    flat = [o for outs in ref for o in outs]
    check(len(got) == len(flat), f"push_many group {group}: {len(got)} "
          f"outputs, push {len(flat)}")
    for j, (x, y) in enumerate(zip(got, flat)):
        check(x.pts == y.pts and (
            not isinstance(y.device_planes()[0], torch.Tensor)
            or _same_outputs([x], [y])),
            f"push_many group {group}: output {j} differs from push's")
    return calls, e.group_stats


def control_calc_with_polling(dev, frames):
    """Calc ms a pair (the engine's CUDA events) of the same pairs without
    and then with an IPC client and the applet's status reader polling
    every millisecond."""
    from mpv_frame_interpolator_tpu_torch.api import Player
    from mpv_frame_interpolator_tpu_torch.control.applet import AppletServer
    from mpv_frame_interpolator_tpu_torch.control.applet_client import (
        read_status)
    from mpv_frame_interpolator_tpu_torch.control.ipc import IPCServer
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import EngineConfig
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for polled in (False, True):
            player = Player(EngineConfig(
                display_fps=120.0, auto_quality=False,
                initial_search_radius=16, device=str(dev)))
            stop = threading.Event()
            threads, servers = [], []
            if polled:
                sock = os.path.join(tmp, "ipc.sock")
                fifo = os.path.join(tmp, "hr")
                servers = [IPCServer(sock, player),
                           AppletServer(fifo, player.engine, period=0.001)]
                for s in servers:
                    s.start()

                def ipc_poll():
                    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    c.connect(sock)
                    f = c.makefile("rwb")
                    while not stop.is_set():
                        for name in ("ofc-time", "total-time", "calc-res"):
                            f.write(json.dumps({"command": [
                                "get_property", name]}).encode() + b"\n")
                            f.flush()
                            f.readline()
                        time.sleep(0.001)
                    c.close()

                def applet_poll():
                    while not stop.is_set():
                        read_status(fifo)

                threads = [threading.Thread(target=ipc_poll),
                           threading.Thread(target=applet_poll)]
                for t in threads:
                    t.start()
            try:
                for f in frames:
                    player.feed(f)
                player.engine.flush()
            finally:
                stop.set()
                for t in threads:
                    t.join(60)
                for s in servers:
                    s.stop()
            s = player.engine.stats.summary()["source_frame_time"]
            result[polled] = (s["mean"] * 1e3, s["count"])
    return result


def control_cli(dev, tmp, frames_n: int):
    """Check 3: the CLI on a 4K y4m file with --ipc-server, --applet-fifo,
    --profile-dir and --save-position-on-quit, a client thread reading
    properties, pausing and resuming, taking a screenshot, sending an
    applet code and quit-watch-later; then a second run of the file
    resumes at the saved position and writes the bytes of a --start run
    there.  Returns what the client read and the trace's kernel rows."""
    from mpv_frame_interpolator_tpu_torch import cli
    from mpv_frame_interpolator_tpu_torch.control.applet_client import (
        read_status, send_code)
    from mpv_frame_interpolator_tpu_torch.pipeline import resume
    from mpv_frame_interpolator_tpu_torch.utils.png import decode_png
    src = os.path.join(tmp, "in.y4m")
    w, h = (W4K, H4K) if torch.device(dev).type == "cuda" else (64, 48)
    write_y4m(src, synthetic_frames("moving_box", w, h, frames_n), w, h)
    sock, fifo = os.path.join(tmp, "ipc.sock"), os.path.join(tmp, "hr")
    shot, prof = os.path.join(tmp, "shot.png"), os.path.join(tmp, "prof")
    seen, errors = {}, []

    def client():
        f = None

        def rpc(*cmd):
            seen["last"] = cmd
            f.write(json.dumps({"command": list(cmd)}).encode() + b"\n")
            f.flush()
            r = json.loads(f.readline())
            check(r["error"] == "success", f"IPC {cmd}: {r}")
            return r.get("data")

        try:
            deadline = time.monotonic() + 120
            while not os.path.exists(sock):
                check(time.monotonic() < deadline, "no IPC socket")
                time.sleep(0.01)
            c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            c.connect(sock)
            f = c.makefile("rwb")

            rpc("get_property", "ofc-time")         # asks for the split
            while rpc("get_property", "time-pos") < 0.25:
                check(time.monotonic() < deadline, "playback never began")
                time.sleep(0.005)
            rpc("set_property", "pause", True)
            seen["paused"] = rpc("get_property", "pause")
            seen["properties"] = len(rpc("property-list"))
            for name in ("ofc-time", "warp-time", "total-time", "calc-res"):
                seen[name] = rpc("get_property", name)
            seen["screenshot"] = rpc("screenshot", shot)
            seen["last"] = "applet"
            send_code(fifo, 4)                      # mode 2: as it is
            seen["status"] = read_status(fifo).splitlines()[:2]
            rpc("set_property", "pause", False)
            seen["quit"] = rpc("quit-watch-later")
            c.close()
        except BaseException as e:  # noqa: BLE001 - check() exits; below
            errors.append(e)
            if f is not None:       # never leave the run paused
                for cmd in (("set_property", "pause", False), ("quit",)):
                    try:
                        rpc(*cmd)
                    except BaseException:   # noqa: BLE001
                        pass

    common = [src, "--display-fps", "120", "--search-radius", "16",
              "--no-auto-quality", "--untimed", "--frames", "0",
              "--device", str(dev)]
    stats_path = os.path.join(tmp, "stats.json")
    out = os.path.join(tmp, "out.y4m")
    t = threading.Thread(target=client)
    t.start()
    t0 = time.perf_counter()
    rc = cli.main([*common, "-o", out, "--ipc-server", sock,
                   "--applet-fifo", fifo, "--profile-dir", prof,
                   "--save-position-on-quit", "--dump-stats", stats_path])
    wall = time.perf_counter() - t0
    t.join(60)
    check(not t.is_alive() and not errors,
          f"the client, at {seen.get('last')}: {errors!r}")
    check(rc == 0, f"cli with the control surfaces returned {rc}")
    with open(stats_path) as fh:
        stats = json.load(fh)
    check(stats["engine_failures"] == 0 and stats["control_failures"] == 0,
          f"{stats['engine_failures']} engine and "
          f"{stats['control_failures']} control failures")
    fw, fh_, n = y4m_frames(out)
    check((fw, fh_) == (w, h) and n == stats["frames_out"] > 0,
          f"the y4m holds {n} {fw}x{fh_} frames of {stats['frames_out']}")
    check(stats["frames_in"] < frames_n, "quit-watch-later did not stop "
          f"playback ({stats['frames_in']} of {frames_n} frames)")
    with open(shot, "rb") as fh:
        img = decode_png(fh.read())
    check(img.shape == (h, w, 3), f"screenshot {img.shape}")
    check(seen["paused"] is True and seen["properties"] == 28,
          f"pause / property-list: {seen}")
    check(all(seen[k] > 0 for k in ("ofc-time", "warp-time", "total-time")),
          f"telemetry: {seen}")
    check(seen["calc-res"] == ("480x270" if w == W4K else f"{w}x{h}"),
          f"calc-res {seen['calc-res']}")
    check(seen["status"][0] == "Search Radius: 16",
          f"applet status {seen['status']}")
    state = resume.load(src)
    check(state is not None and state["start"] > 0.2
          and state["frame-output-mode"] == 2,
          f"watch-later state {state}")
    rows = {}
    with open(os.path.join(prof, "trace.json")) as fh:
        for ev in json.load(fh)["traceEvents"]:
            if ev.get("cat") == "kernel":
                name = ev.get("name", "")
                for k in OUR_KERNELS:
                    if k in name:
                        rows[k] = rows.get(k, 0) + 1
    if torch.device(dev).type == "cuda":
        check(rows.get("pyramid_kernel", 0) > 0
              and rows.get("pair_blend_kernel", 0) > 0,
              f"the trace's kernel rows: {rows}")
    # the second run resumes; a --start run at that position
    outs = []
    for extra in ([], ["--no-resume", "--start", str(state["start"])]):
        path = os.path.join(tmp, f"resumed{len(outs)}.y4m")
        check(cli.main([*common, *extra, "-o", path]) == 0,
              f"cli {extra} failed")
        outs.append(path)
    check(same_bytes(*outs) and y4m_frames(outs[0])[2] > 0,
          "the resumed run differs from the --start run")
    resumed = y4m_frames(outs[0])[2]
    return dict(seen, wall=wall, frames_in=stats["frames_in"],
                frames_out=stats["frames_out"], start=state["start"],
                resumed_frames=resumed, trace_rows=rows)


def control_profiles(dev, tmp):
    """Check 4: --config examples/mfi.conf --profile=baseline-3 and -4
    (the profiles at 4K), 3 source frames of a synthetic clip: the bytes of
    the same runs with the flags written out."""
    from mpv_frame_interpolator_tpu_torch import cli
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "mfi.conf")
    flags = {"baseline-3": ["--width", "3840", "--height", "2160", "--fps",
                            "24", "--display-fps", "120", "--ingest",
                            "native"],
             "baseline-4": ["--width", "3840", "--height", "2160", "--fps",
                            "24", "--display-fps", "60", "--p010", "--mode",
                            "hsv"]}
    done = {}
    for name, written in flags.items():
        outs = []
        for argv in (["--config", conf, f"--profile={name}"],
                     ["--no-config", "--untimed", "--scene-threshold", "28",
                      *written]):
            out = os.path.join(tmp, f"{name}-{len(outs)}.y4m")
            check(cli.main(["synthetic:moving_box", "--frames", "3",
                            "--device", str(dev), *argv, "-o", out]) == 0,
                  f"{name}: cli {argv} failed")
            outs.append(out)
        info = y4m_frames(outs[0])
        check(info[:2] == (W4K, H4K) and info[2] > 1,
              f"{name}: the y4m is {info}")
        check(same_bytes(*outs),
              f"{name}: the profile's bytes differ from the flags'")
        done[name] = info[2]
        for p in outs:
            os.remove(p)
    return done


def phase_control(dev):
    """Phase 17: the control surfaces on the card at 4K 24 -> 120, radius
    16 (checks 1-4 above), with the watch-later directory in a temporary
    one.  Prints how many pairs a set_property took to land, the ms of
    the first pair after each kind of change against a steady pair, and
    the calc ms a pair with the IPC and applet threads polling against
    without them."""
    from mpv_frame_interpolator_tpu_torch.pipeline import resume
    on_card = torch.device(dev).type == "cuda"
    # off the card (a rehearsal) 160 rows: both max-calc-res values
    # still give different geometries there
    w, h = (W4K, H4K) if on_card else (64, 160)
    counts = kernel_counts()
    saved_dir = resume.DEFAULT_DIR
    with tempfile.TemporaryDirectory() as tmp:
        resume.DEFAULT_DIR = os.path.join(tmp, "watch_later")
        try:
            t0 = time.perf_counter()
            host = synthetic_frames("moving_box", w, h, CONTROL_FRAMES)
            frames = [f for f in host]
            log(f"  {CONTROL_FRAMES} frames of {w}x{h} made in "
                f"{time.perf_counter() - t0:.1f} s")
            for c in counts.values():
                c.reset()
            outs, ms, landed, compared, timed = control_script_push(
                dev, frames, os.path.join(tmp, "pairs.log"))
            launches = {k: c.kernel for k, c in counts.items() if c.kernel}
            check(not on_card or not any(c.plain for c in counts.values()),
                  "a plain version ran in the property script")
            log(f"  check 1: {compared} interpolated pushes equal a fresh "
                f"engine at their settings; each of the {len(landed)} "
                f"changes took effect at the next pair (frames {landed}; 0 "
                f"pairs passed), which differed from the old settings' "
                f"pair wherever the change shows; stats log {timed} lines, "
                f"one a timed pair; "
                f"launches {launches}")
            firsts = {}
            for idx, items in CONTROL_SCRIPT:
                names = {n for n, _ in items}
                j = idx + 1 if "max-calc-res" in names else idx
                kind = ("geometry derived again" if "max-calc-res" in names
                        else "model switched" if "model" in names
                        else "mode and knobs")
                firsts.setdefault(kind, []).append(round(ms[j], 3))
            steady = [m for i, m in enumerate(ms)
                      if i > 2 and all(i not in (k, k + 1)
                                       for k, _ in CONTROL_SCRIPT)]
            log(f"  host ms of a push, synchronised: steady median "
                f"{statistics.median(steady):.3f}; first pair after a "
                f"change: {firsts}")
            for group in (4, 8):
                calls, gstats = control_script_groups(dev, frames, outs,
                                                       group)
                cap = [m for m, c in calls if c]
                rep = [m for m, c in calls if not c]
                log(f"  check 2: push_many groups of {group} equal push "
                    f"across the changes; {gstats}; host ms a group "
                    f"with a capture: median "
                    f"{statistics.median(cap) if cap else 0:.3f} "
                    f"({len(cap)}), replayed: median "
                    f"{statistics.median(rep) if rep else 0:.3f} "
                    f"({len(rep)})")
                check(not on_card or gstats["captures"] >= len(
                    CONTROL_SCRIPT), f"captures: {gstats}")
            polled = control_calc_with_polling(dev, frames[:24])
            log(f"  calc ms a pair (CUDA events), mean over "
                f"{polled[False][1]} / {polled[True][1]} pairs: "
                f"{polled[False][0]:.4f} without, {polled[True][0]:.4f} "
                f"with the IPC and applet threads polling")
            del outs, frames, host
            t1 = time.perf_counter()
            cli_run = control_cli(dev, tmp, 24)
            log(f"  check 3: {cli_run} ({time.perf_counter() - t1:.1f} s)")
            if on_card:
                t1 = time.perf_counter()
                profiles = control_profiles(dev, tmp)
                log(f"  check 4: --config examples/mfi.conf profiles "
                    f"equal their flags: {profiles} frames "
                    f"({time.perf_counter() - t1:.1f} s)")
        finally:
            resume.DEFAULT_DIR = saved_dir


def slice_bound(geom, radius: int, n: int, item: int):
    """(bound_ms, bound_by) of one rank's layer slices of a 4K pyramid:
    K1's work (k1_bound) for n of its radius' layers, and each slice's
    (min, layer) pair written once a window."""
    lh, lw = geom.low_h, geom.low_w
    cand = 2 * geom.iterations * n * lh * lw
    planes = (H4K * W4K, H4K * W4K // 4, H4K * W4K // 4)
    windows = sum(2 * -(-lh // w) * -(-lw // w)
                  for w in geom.window_schedule())
    nbytes = (sum(min(p, cand) for p in planes) * item + 3 * lh * lw * item
              + 2 * lh * lw * 4 + 2 * windows * 4)
    return bound(nbytes, 35 * cand)


def phase_layer_slice(dev, rng, geom):
    """K1's layer slice at 4K, radius 16, against its plain version (the
    plain composition on the card, ``layer_slice_step_plain``): slices of
    4 and 8 layers (and all 16) at every window of the pyramid and window
    1, both axes, the neighbour bias where the pyramid has it, 8-bit and
    P010, each launch first committing the previous case's pairs of two
    ranks; then one rank's launches of a pair (2 x iterations steps and
    the commit that ends the pyramid) timed at each slice width, with its
    device rows: one slice kernel a launch and nothing else.  Returns the
    entry of the kernels line (the 16-layer slices, world size 1) with the
    others under `slices`."""
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    lh, lw, rs = geom.low_h, geom.low_w, geom.res_scalar
    steps = KS.pyramid_steps(geom.window_schedule(),
                             F.FIRST_NEIGHBOR_ITERATION)
    err = 0
    timed = {}
    for dt, luma_shift in ((np.uint8, 0), (np.uint16, 8)):
        f1y, _, f1u, f1v = random_planes(rng, dev, dt)
        f2y, _, f2u, f2v = random_planes(rng, dev, dt)
        planes = (f1y, f1u, f1v, *F.subsampled_f2(geom, f2y, f2u, f2v))
        start = torch.from_numpy(np.stack([
            block_field(rng, lh, lw, 8, 6, 64),
            block_field(rng, lh, lw, 8, 6, 64)])).to(dev)
        scalars = (16, 8, 6, rs, geom.height, geom.stride, luma_shift)
        for n in (4, 8, 16):
            e = 0
            field, plain = start.clone(), start.clone()
            sums = torch.zeros((2, KS.slice_sums_words(
                lh, lw, n, geom.window_schedule())), dtype=torch.int32,
                device=dev)
            gathered = prev = None
            k = 0
            # window 1 after the pyramid's steps
            for z0 in range(0, 16, n):
                for step in steps + ((1, 0, True),):
                    got = KS.flow_layer_slice(
                        *planes, field, gathered, prev, step, z0, n,
                        *scalars, sums=(sums[k & 1], sums[~k & 1]))
                    k += 1
                    want = KS.layer_slice_step_plain(
                        *planes, plain, gathered, prev, step, z0, n,
                        *scalars)
                    e = max(e, max_err([got, field], [want, plain]))
                    # two ranks' pairs for the next launch to commit: these
                    # and the same layers with other minima
                    other = got.clone()
                    other[0] = torch.from_numpy(rng.integers(
                        -2 ** 31, 2 ** 31, tuple(got[0].shape)).astype(
                            np.int32)).to(dev)
                    gathered, prev = torch.stack((got, other)), step[:2]
            log(f"  K1 layer slice {np.dtype(dt).name} n={n}: every slice "
                f"of radius 16 at every step and window 1, each launch "
                f"committing two ranks' pairs: max_abs_err={e}")
            err = max(err, e)
            if dt == np.uint16:
                continue

            def reset(field=field):
                field.zero_()

            def pair(launch=KS.flow_layer_slice, n=n, field=field,
                     timelines=None):
                """One rank's launches of a pair on `field`, from a zero
                field after reset(), on ping-pong sums (the plain version
                takes none); each launch's timeline into `timelines`."""
                gathered = prev = None
                for k, step in enumerate(steps + (None,)):
                    kw = {} if launch is KS.layer_slice_step_plain else dict(
                        sums=(sums[k & 1], sums[~k & 1]),
                        timeline=None if timelines is None else timelines[k])
                    if step is None:
                        kw.pop("sums", None)
                        launch(*planes, field, gathered, prev, None, 0, n,
                               *scalars, **kw)
                        break
                    gathered = launch(*planes, field, gathered, prev, step,
                                      0, n, *scalars, **kw)[None]
                    prev = step[:2]

            reset()
            before = KS.slice_counts.kernel
            pair()
            launched = KS.slice_counts.kernel - before
            # the device time: the trace's rows of every launch of a pair
            rows = kernel_rows(pair, len(steps) + 1, reset)
            traced = sum(c for c, _ in rows.values())
            timed[n] = dict(ms=cuda_ms(lambda: (reset(), pair()), 10),
                            plain_ms=cuda_ms(lambda: (reset(), pair(
                                KS.layer_slice_step_plain)), 2, 1),
                            bound=slice_bound(geom, 16, n, 1),
                            rows=rows, device_ms=sum(
                                us for _, us in rows.values()) / 1e3)
            r = timed[n]
            # inside the launches (median of 5 pairs): the start of the
            # sums (the commit is inside them), the sums, the minima of the
            # windows of 16 and up
            stamps = torch.zeros((5, len(steps) + 1, 4), dtype=torch.int64,
                                 device=dev)
            for t in stamps:
                reset()
                pair(timelines=t)
            t = stamps.cpu().numpy().astype(np.float64)[:, :-1] / 1e3
            phases = [float(np.median(x.sum(1))) for x in (
                t[..., 1] - t[..., 0], t[..., 2] - t[..., 1],
                np.where(t[..., 3] > 0, t[..., 3] - t[..., 2], 0))]
            r["phases_us"] = phases
            log(f"  K1 layer slice n={n} inside one rank's {len(steps)} "
                f"launches of a pair, us (timelines): start {phases[0]:.2f}, "
                f"sums with the commit {phases[1]:.2f}, minima "
                f"{phases[2]:.2f}")
            check(launched == len(steps) + 1 == traced
                  and all("slice_kernel" in k for k in rows),
                  f"one rank's launches of a pair: {launched} slice "
                  f"launches for {len(steps)} steps and the commit, device "
                  f"rows {rows}")
            log(f"  K1 layer slice n={n}, one rank's {len(steps)} launches "
                f"of a pair and the commit: kernel {r['ms']:.4f} ms (device "
                f"{r['device_ms']:.4f} ms; {launched} launches, {traced} "
                f"slice-kernel rows traced and no other row), plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
                f"({r['bound'][1]})")
    return dict(timed[16], max_abs_err=err, slices=timed)


def profile_sharded_flow(dev, planes) -> dict:
    """The layer-sharded flow at world size 1 on nccl, in this process: a
    4K pair's slice launches (the counter), its device rows (one slice
    kernel a step and one commit, the gathers, the blur; no memset), its
    device ms, and its ms a pair on the wall clock (10 pairs, a
    synchronise after each)."""
    import torch.distributed as dist
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.parallel import sharding
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tmp, "store"), rank=0, world_size=1)
        try:
            geom = F.FlowGeometry.create(H4K, W4K, W4K)
            fn = sharding.sharded_flow(geom, 16, None, 0, dev)
            t = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                 for p in planes]
            steps = 2 * geom.iterations
            before = KS.slice_counts.kernel
            fn(*t)
            launches = KS.slice_counts.kernel - before
            # a slice, a copy and a collective a step, the commit, the blur
            rows = kernel_rows(lambda: fn(*t), 3 * steps + 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn(*t)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e2
        finally:
            dist.destroy_process_group()
    return dict(rows=rows, wall_ms=wall_ms, launches=launches,
                device_ms=sum(us for _, us in rows.values()) / 1e3)


def phase_row_band(dev, rng, geom):
    """K2's row band at 4K against its plain version and against K2's
    whole planes: 1, 2 and 4 bands, NV12 at the default levels and P010
    at 16/235, one position (the sharded warp's), three and five, on a
    block flow, and at three positions on flows that push cells past
    every edge and on odd flows (odd chroma displacements); timed at each
    band count on one position.  Returns the kernels-line entry (one band,
    the whole frame) with the others under `bands`."""
    from mpv_frame_interpolator_tpu_torch.ops import warp as W
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
    lh, lw, rs = geom.low_h, geom.low_w, geom.res_scalar
    blurred = torch.from_numpy(np.stack([
        block_field(rng, lh, lw, 8, 12, 96),
        block_field(rng, lh, lw, 8, 12, 96)])).to(dev)
    far = torch.from_numpy(np.stack([
        block_field(rng, lh, lw, 8, 12, 400),
        block_field(rng, lh, lw, 8, 12, 400)])).to(dev)
    odd = torch.from_numpy(2 * np.stack([
        block_field(rng, lh, lw, 8, 12, 48),
        block_field(rng, lh, lw, 8, 12, 48)]) + 1).to(dev)
    cases = (("block", [0.4], blurred), ("block", [0.0, 0.4, 1.0], blurred),
             ("block", [0.0, 0.2, 0.4, 0.6, 0.8], blurred),
             ("edge", [0.0, 0.4, 1.0], far), ("odd", [0.0, 0.4, 1.0], odd))
    err = 0
    timed = {}
    for dt, ss, levels in ((np.uint8, 0, (0, 255)),
                           (np.uint16, 8, W.level_ints(16, 235))):
        f1y, f1uv, _, _ = random_planes(rng, dev, dt)
        f2y, f2uv, _, _ = random_planes(rng, dev, dt)
        for name, ts, flow in cases:
            tt = torch.tensor(ts, dtype=torch.float32, device=dev)
            args = (f1y, f1uv, f2y, f2uv, flow, tt, rs, W4K)
            whole = KW.pair_blend(*args, ss, levels)
            for parts in (1, 2, 4):
                bands = [KW.pair_blend_rows(*args, r0, r1, ss, levels)
                         for r0, r1 in KW.band_rows(H4K, parts)]
                e = max(max_err(b, KW.pair_blend_rows_plain(
                    *args, r0, r1, ss, levels))
                    for b, (r0, r1) in zip(bands, KW.band_rows(H4K, parts)))
                e = max(e, max_err([torch.cat([b[0] for b in bands], 1),
                                    torch.cat([b[1] for b in bands], 1)],
                                   whole))
                log(f"  K2 row band {np.dtype(dt).name} levels={levels} "
                    f"N={len(ts)} {name} flow {parts} bands: "
                    f"max_abs_err={e}")
                err = max(err, e)
                if dt != np.uint8 or len(ts) != 1:
                    continue
                r0, r1 = KW.band_rows(H4K, parts)[0]
                a = (*args, r0, r1, ss, levels)
                wb = warp_bound(1, 1, rs)
                # ten launches a trace: a profiler trace can drop the
                # rows of a lone short launch
                timed[parts] = dict(
                    device_ms=device_ms(lambda: [
                        KW.pair_blend_rows(*a) for _ in range(10)]) / 10,
                    ms=cuda_ms(lambda: KW.pair_blend_rows(*a), 20),
                    plain_ms=cuda_ms(lambda: KW.pair_blend_rows_plain(*a),
                                     3),
                    bound=(wb[0] * (r1 - r0) / H4K, wb[1]))
                r = timed[parts]
                log(f"  K2 row band rows [{r0}, {r1}) of {parts} bands, "
                    f"one position: kernel {r['ms']:.4f} ms (device "
                    f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} "
                    f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return dict(timed[1], max_abs_err=err, bands=timed,
                bands_device_ms={k: v["device_ms"] for k, v in timed.items()})


def _warm_then_timed(run, warm, timed) -> tuple:
    """run(warm), then run(timed) on the wall clock up to its last output
    finished: (every output, the timed run's outputs, its seconds).  The
    warm half pays each new engine's and stream's first allocations."""
    outs = run(warm)
    for o in outs:
        o.block()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    more = run(timed)
    for o in more:
        o.block()
    return outs + more, len(more), time.perf_counter() - t0


def _equal_lists(a, b) -> bool:
    """Whether two runs' outputs are equal: pts, and planes compared on
    the card (a passthrough's host planes on the host), each output
    waited for on the stream that made it."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.pts != y.pts:
            return False
        for p, q in zip(x.block().device_planes(), y.block().device_planes()):
            if not isinstance(p, torch.Tensor) or \
                    not isinstance(q, torch.Tensor):
                p, q = (t.cpu().numpy() if isinstance(t, torch.Tensor)
                        else t for t in (p, q))
                if not np.array_equal(p, q):
                    return False
                continue
            if p.dtype == torch.uint16:
                p, q = p.view(torch.int16), q.view(torch.int16)
            if not torch.equal(p, q):
                return False
    return True


def phase_parallel(dev):
    """Phase 18: the last modules on the card.  Parity (FULL_CASES in
    every mode, 28 rows against the oracle copy), the two launch modes,
    chip time on captured graphs beside the profiler's device ms, the pair
    pool, the multi-stream engine and the farm against single engines,
    the sharded step at world sizes 1 (nccl), 2 and 4 (gloo, every rank on
    this card) at 4K, and the dry run on 4 ranks.  Returns (kernel
    entries, the world-1 sharded step's launches)."""
    from torch.profiler import ProfilerActivity, profile
    from mpv_frame_interpolator_tpu_torch.io import synthetic as PS
    from mpv_frame_interpolator_tpu_torch.ops import flow as F
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
    from mpv_frame_interpolator_tpu_torch.parallel import dryrun
    from mpv_frame_interpolator_tpu_torch.parallel.batch import (
        PairParallelPool)
    from mpv_frame_interpolator_tpu_torch.parallel.farm import StreamFarm
    from mpv_frame_interpolator_tpu_torch.parallel.streams import (
        MultiStreamEngine)
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine)
    from mpv_frame_interpolator_tpu_torch.profile_pair import self_device_us
    from mpv_frame_interpolator_tpu_torch.utils import parity
    from mpv_frame_interpolator_tpu_torch.utils.chiptime import (
        chip_pair_seconds)
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    rows = parity.run_parity(parity.FULL_CASES, tuple(parity.MODE_NAMES),
                             device=str(dev))
    bad = [name for name, ok in rows if not ok]
    log(f"  parity: {len(rows) - len(bad)}/{len(rows)} bit-exact against "
        f"the oracle copy ({time.perf_counter() - t0:.1f} s)")
    check(len(rows) == 28 and not bad, f"parity rows failed: {bad}")

    rng = np.random.default_rng(SEED + 18)
    geom = F.FlowGeometry.create(H4K, W4K, W4K)
    results = {"flow_layer_slice": phase_layer_slice(dev, rng, geom),
               "pair_blend_rows": phase_row_band(dev, rng, geom)}
    for name, r in results.items():
        check(r["max_abs_err"] == 0, f"{name} disagrees with its plain "
              f"version (max_abs_err {r['max_abs_err']})")

    # chip time on captured graphs, beside the profiler's device time of
    # pushed pairs of the same clip (gradient_pan, 5 outputs a pair)
    t0 = time.perf_counter()
    chip_ms = chip_pair_seconds(W4K, H4K, 5, 16, k1=4, k2=16,
                                repeats=3) * 1e3
    eng = InterpolationEngine(EngineConfig(
        display_fps=120.0, auto_quality=False, initial_search_radius=16,
        device=str(dev)))
    clip = [eng.stage(f) for f in PS.gradient_pan(
        PS.SyntheticConfig(width=W4K, height=H4K), 12, vx=3, vy=1)]
    for f in clip[:4]:
        eng.push(f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in clip[4:]:
            eng.push(f)
        torch.cuda.synchronize()
    prof_ms = sum(self_device_us(e) for e in prof.key_averages()) / 1e3 / 8
    log(f"  chip time: {chip_ms:.4f} ms a pair from graphs of 4 and 16 "
        f"pairs; profiler device time of 8 pushed pairs {prof_ms:.4f} ms a "
        f"pair (ratio {chip_ms / prof_ms:.3f}; "
        f"{time.perf_counter() - t0:.1f} s)")

    # the pool, the streams and the farm at 4K 24 -> 120, radius 16: 10
    # frames a stream, the first 5 warm each path (its engines' and
    # streams' first allocations), the last 5 timed
    settings = dict(display_fps=120.0, auto_quality=False,
                    measure_timing=False, initial_search_radius=16,
                    device=str(dev))
    config = EngineConfig(**settings)
    p010_config = EngineConfig(black_level=16, white_level=235, **settings)
    # streams 0-3 NV12, stream 4 P010 (the farm's fourth)
    srcs = [list(PS.moving_box(PS.SyntheticConfig(
        width=W4K, height=H4K, seed=SEED + k,
        pixfmt="p010" if k == 4 else "nv12"), 10)) for k in range(5)]
    warm, timed = range(5), range(5, 10)

    def push_all(e, k):
        return lambda steps: [o for i in steps for o in e.push(srcs[k][i])]

    singles = []
    for k in range(5):
        e = InterpolationEngine(p010_config if k == 4 else config)
        outs, n, sec = _warm_then_timed(push_all(e, k), warm, timed)
        singles.append(outs)
        if k == 0:
            single_fps = n / sec
    pool = PairParallelPool(config, devices=(dev, dev))
    outs, n, sec = _warm_then_timed(
        lambda steps: list(pool.run(srcs[0][i] for i in steps)), warm, timed)
    check(_equal_lists(outs, singles[0]), "the pair pool's outputs differ "
          "from a single engine's")
    check(pool.pairs_per_slot() == [5, 4], f"the pool's slots ran "
          f"{pool.pairs_per_slot()} pairs")
    log(f"  pair pool on (cuda:0, cuda:0): {len(outs)} outputs equal to "
        f"one engine's; {n / sec:.1f} out-fps against {single_fps:.1f} for "
        f"one engine")
    for batch in (False, True):
        ms = MultiStreamEngine(config, n_streams=4, batch_dispatch=batch)
        got = [[] for _ in range(4)]

        def run_ms(steps, ms=ms, got=got):
            new = []
            for i in steps:
                for k, o in ms.push_batch([s[i] for s in srcs[:4]]).items():
                    got[k].extend(o)
                    new.extend(o)
            return new

        _, n, sec = _warm_then_timed(run_ms, warm, timed)
        check(all(_equal_lists(g, w) for g, w in zip(got, singles)),
              f"the multi-stream engine (batch_dispatch={batch}) differs "
              f"from single engines")
        log(f"  multi-stream engine, 4 NV12 streams, batch_dispatch={batch}:"
            f" outputs equal to single engines; {n / sec:.1f} out-fps in "
            f"all against {single_fps:.1f} for one engine")
    farm = StreamFarm(n_streams=4, configs=[config] * 3 + [p010_config])
    farm_srcs = srcs[:3] + srcs[4:]
    got = [[] for _ in range(4)]

    def run_farm(steps):
        new = []
        for i in steps:
            for k in range(4):
                farm.submit(k, farm_srcs[k][i])
        for k, batches in farm.drain_all(timeout=300).items():
            for b in batches:
                got[k].extend(b)
                new.extend(b)
        return new

    try:
        _, n, sec = _warm_then_timed(run_farm, warm, timed)
    finally:
        farm.close()
    check(all(_equal_lists(g, w) for g, w in zip(got, singles[:3]
                                                  + singles[4:])),
          "the stream farm's outputs differ from single engines")
    log(f"  stream farm, 4 streams (one P010 at 16/235) on 4 CUDA streams: "
        f"outputs equal to single engines; {n / sec:.1f} out-fps in all "
        f"against {single_fps:.1f} for one engine")

    # the sharded step at 4K: world 1 on nccl in this process (its
    # launches counted here), 2 and 4 on gloo (a process a rank)
    f1, f2 = list(PS.moving_box(PS.SyntheticConfig(width=W4K, height=H4K,
                                                   seed=SEED), 2))
    planes = (f1.y, f1.uv[:, 0::2], f1.uv[:, 1::2],
              f2.y, f2.uv[:, 0::2], f2.uv[:, 1::2])
    steps = 2 * geom.iterations
    prof = profile_sharded_flow(dev, planes)
    rows = prof["rows"]
    memsets = [k for k in rows if "memset" in k.lower()]
    log(f"  sharded flow at 4K, 1 rank on nccl: {prof['wall_ms']:.3f} ms a "
        f"pair (wall), device {prof['device_ms']:.4f} ms, "
        f"{prof['launches']} slice launches; device rows "
        + "; ".join(f"{k[:48]} x{c} {us:.1f} us" for k, (c, us)
                    in sorted(rows.items(), key=lambda kv: -kv[1][1])))
    check(prof["launches"] == steps + 1 and not memsets
          and not any("slice_sums" in k or "slice_min" in k for k in rows),
          f"the sharded flow launched {prof['launches']} slices for "
          f"{steps} steps, device rows {list(rows)}")
    results["flow_layer_slice"]["sharded_flow"] = prof
    launches = None
    for world, backend in ((1, "nccl"), (2, "gloo"), (4, "gloo")):
        t0 = time.perf_counter()
        KS.slice_counts.reset()
        KW.rows_counts.reset()
        res = dryrun.run_sharded(world, planes, 16, (2,), 0.4, str(dev),
                                 backend, reps=5 if world == 1 else 2,
                                 arrays=False)
        if world == 1:
            launches = {"flow_layer_slice": KS.slice_counts.kernel,
                        "pair_blend_rows": KW.rows_counts.kernel}
        check(res["equal"], f"the sharded step on {world} ranks ({backend})"
              " differs from the single-device path")
        log(f"  sharded step at 4K, {world} rank(s) on {backend}: offset and "
            f"outputs equal to the single-device path; ms a pair by rank "
            f"{[round(m, 3) for m in res['ms_by_rank']]} "
            f"({time.perf_counter() - t0:.1f} s: every rank started, joined "
            f"and done at {', '.join(f'{x:.1f}' for x in res['seconds'])}"
            f" s)")
    # world 1: the checked step and 5 timed steps, each 2 x iterations
    # slice launches, the commit that ends the pyramid and one band
    check(launches == {"flow_layer_slice": 6 * (steps + 1),
                       "pair_blend_rows": 6},
          f"the world-1 sharded step launched {launches}")
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(4, device=str(dev), backend="gloo")
    log(f"  dryrun_multichip(4) on gloo took "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return results, launches


# each stage of the quality report on the card: its launches (the blur
# and S1 as phases of K1's launch), four blend positions a column
QUALITY_LAUNCHES = {
    "flow": {"flow_step": 1, "blur_phase": 1},
    "flow+subpel": {"flow_step": 1, "subpel_phase": 1, "blur_phase": 1},
    "blend (no flow)": {"pair_blend": 4},
    "hopper": {"pair_blend": 4},
    "hopperx": {"sample_dir": 8, "blend_levels": 4},
    "hopperq": {"bilinear_blend": 4},
    "hopperxq": {"bilinear_blend": 4},
    "hopperq+subpel": {"bilinear_blend": 4},
    "hopperxq+subpel": {"bilinear_blend": 4},
}


def phase_last_tools(dev):
    """Phase 19: the last modules on the card.  (1) The quality report
    (``tools/quality_report``, 256x128 sine pans at 6 and 2.5 px a frame,
    radius 10, every family) with the kernels and with their plain
    versions (the CPU, in this process): every rendered luma plane byte
    for byte and every PSNR the same float, each stage's launches on the
    card -- the flow K1 once with its blur phase, the sub-pel flow K1 once
    with S1's phases and the blur phase, blend (a zero field) and hopper
    K2 once a position, hopperx K5 twice and G1's occlusion variant once,
    hopperq and hopperxq Q1 once, with the sub-pel field in the +subpel
    columns -- and no plain version on the card; the table printed.  (2)
    The degrade ladder (``tools/degrade_ladder``) at 4K: its nine rungs'
    ms a pair after the card's name and power limit, the blend rung
    launching no K1.  (3) The examples at their own sizes: ``embed``
    (Player, hopperq, 640x360) writes as many y4m frames as it reports,
    ``serving_farm`` (4 streams at 640x360) returns that many a stream."""
    from mpv_frame_interpolator_tpu_torch.examples import embed, serving_farm
    from mpv_frame_interpolator_tpu_torch.tools import degrade_ladder
    from mpv_frame_interpolator_tpu_torch.tools import quality_report as QR
    t_phase = time.perf_counter()

    counters = kernel_counts()
    for c in counters.values():
        c.reset()
    card = QR.run(str(dev))
    launched = {k: (c.kernel, getattr(c, "fused", 0))
                for k, c in counters.items()}
    plain = sum(c.plain for c in counters.values())
    cpu = QR.run("cpu", quiet=True)
    for a, b in zip(card, cpu):
        check(a.planes.keys() == b.planes.keys(), "quality report: planes")
        bad = [k for k in a.planes if not np.array_equal(a.planes[k],
                                                         b.planes[k])]
        check(not bad, f"quality report at shift {a.shift}: the card's "
              f"planes differ from the plain versions' at {bad}")
        check(a.rows == b.rows, f"quality report at shift {a.shift}: PSNR "
              f"{a.rows} on the card, {b.rows} plain")
        check(a.launches == QUALITY_LAUNCHES, f"quality report at shift "
              f"{a.shift}: launches {a.launches}")
    log(f"  quality report: the card's planes and PSNRs equal the plain "
        f"versions' at both shifts; launches a shift {card[0].launches}; "
        f"counters over both {launched}, plain calls {plain}")
    check(plain == 0, f"the quality report on the card ran {plain} plain "
          "versions")
    log(f"  means: " + "; ".join(
        f"shift {r.shift}: " + ", ".join(f"{n} {v:.1f}" for n, v
                                        in r.mean().items()) for r in card))

    t0 = time.perf_counter()
    rungs = degrade_ladder.run(W4K, H4K)
    check(len(rungs) == 9 and all(r["seconds"] > 0 for r in rungs),
          f"the degrade ladder ran {len(rungs)} rungs")
    check(rungs[-1]["model"] == "blend" and rungs[-1]["flow_launches"] == 0
          and all(r["flow_launches"] > 0 for r in rungs[:-1]),
          f"K1 launches by rung {[r['flow_launches'] for r in rungs]}")
    log(f"  degrade ladder at 4K ({time.perf_counter() - t0:.1f} s), ms a "
        f"pair: " + json.dumps({r["tag"]: round(r["seconds"] * 1e3, 4)
                                for r in rungs}))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "embed.y4m")
        n = embed.run(out, str(dev))
        w, h, frames = y4m_frames(out)
    check((w, h, frames) == (640, 360, n) and n > 24,
          f"embed wrote {frames} {w}x{h} frames, reported {n}")
    farm = serving_farm.run(str(dev))
    counts = [len(farm[k]) for k in sorted(farm)]
    check(counts == [n] * serving_farm.N_STREAMS,
          f"serving farm frames by stream {counts}, embed's cadence {n}")
    log(f"  examples: embed wrote {n} frames, the serving farm returned "
        f"{counts} ({time.perf_counter() - t0:.1f} s)")
    log(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return {"quality": [r.mean() for r in card],
            "ladder_ms": {r["tag"]: r["seconds"] * 1e3 for r in rungs}}


# the real-time bar at 24 fps: a source frame's time over 1.4
BAR_MS = 1e3 / 24.0 / 1.4

VIEWS = {"hsv": "warp_hsv", "sbs1": "warp_sbs", "sbs2": "warp_sbs",
         "grey": "warp_grey"}


def phase_views(dev):
    """Phase 20: the views of modes 3, 5, 6 and 4 at 4K 24 -> 120, radius
    16, ``--cache no``.  Each mode through the CLI (4 frames): K1 once a
    pair (mode 6 pairs its first frame with itself), V2 (hsv) or V1 (sbs1,
    sbs2) once an output or V3 (grey) once a pair, no other warp kernel
    and no plain version
    (run_cli's checks and the ones here); then the mode's device ms a
    pair on the profile_pair path (10 pairs after 3 warm, the trace opened
    with spin kernels) and its calc ms a pair from the CLI run, each under
    the real-time bar; then 24 frames through the CLI with the
    auto-quality controller on, which must end at radius 16 and level 0.
    Returns (each mode's launches, each mode's figures)."""
    from mpv_frame_interpolator_tpu_torch import profile_pair as PP
    t_phase = time.perf_counter()
    launches, figures = {}, {}
    for mode, view in VIEWS.items():
        stats = {}
        got = run_cli(dev, 4, ["--mode", mode], stats_out=stats)
        others = {k: got[k] for k in ("pair_blend", "fused_blend",
                                      "sample_dir", "blend_levels",
                                      "bilinear_blend", "warp_sbs",
                                      "warp_hsv", "warp_grey") if k != view}
        check(got[view] > 0 and not any(others.values()),
              f"mode {mode}: {view} launched {got[view]} times, the other "
              f"warp kernels {others}")
        launches[mode] = got
        calc = stats["stats"]["source_frame_time"]
        r = PP.profile(["--mode", mode], opening=spin_opening)
        pairs = r["pairs"]
        rows = {name: (count / pairs, us / 1e3 / pairs)
                for name, count, us in r["rows"]}
        view_rows = [v for k, v in rows.items() if f"{view}_kernel" in k]
        k1_rows = [v for k, v in rows.items() if "pyramid_kernel" in k]
        fig = dict(device_ms=r["device_ms"] / pairs,
                   busy_share=r["device_ms"] / (r["wall"] * 1e3),
                   wall_ms=r["wall"] * 1e3 / pairs,
                   view_ms=sum(us for _, us in view_rows),
                   view_launches=sum(c for c, _ in view_rows),
                   k1_ms=sum(us for _, us in k1_rows),
                   launches=sum(c for c, _ in rows.values()),
                   calc_ms_mean=calc["mean"] * 1e3,
                   calc_ms_p50=calc["p50"] * 1e3,
                   calc_ms_p99=calc["p99"] * 1e3)
        del r
        log(f"  mode {mode}: device {fig['device_ms']:.4f} ms a pair "
            f"({fig['launches']:g} device rows a pair; {view} "
            f"{fig['view_launches']:g} x = {fig['view_ms']:.4f} ms, K1 "
            f"{fig['k1_ms']:.4f} ms), busy share {fig['busy_share']:.3f} "
            f"of {fig['wall_ms']:.3f} ms under the profiler; calc (CLI) "
            f"mean {fig['calc_ms_mean']:.3f} / p50 {fig['calc_ms_p50']:.3f} "
            f"/ p99 {fig['calc_ms_p99']:.3f} ms a pair; the bar "
            f"{BAR_MS:.2f} ms")
        log("    rows a pair: " + json.dumps(
            {k[:60]: [round(c, 2), round(us, 4)] for k, (c, us)
             in sorted(rows.items(), key=lambda kv: -kv[1][1])}))
        check(fig["device_ms"] < BAR_MS and fig["calc_ms_p50"] < BAR_MS,
              f"mode {mode}: {fig['device_ms']:.3f} device ms and "
              f"{fig['calc_ms_p50']:.3f} calc ms a pair against the "
              f"{BAR_MS:.2f} ms bar")
        figures[mode] = fig
    for mode in VIEWS:
        stats = {}
        t0 = time.perf_counter()
        run_cli(dev, 24, ["--mode", mode], auto_quality=True,
                stats_out=stats)
        calc = stats["stats"]["source_frame_time"]
        log(f"  mode {mode}, 24 frames with auto-quality: radius "
            f"{stats['search_radius']}, level {stats['level']}, calc p99 "
            f"{calc['p99'] * 1e3:.3f} ms ({time.perf_counter() - t0:.1f} s)")
        check((stats["search_radius"], stats["level"]) == (16, 0),
              f"mode {mode} with auto-quality ended at radius "
              f"{stats['search_radius']}, level {stats['level']}")
        figures[mode]["auto_calc_ms_p99"] = calc["p99"] * 1e3
    log(f"  phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return launches, figures


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
        if "Used" in line or "Compiling" in line or "spill" in line:
            log(f"  {line.strip()}")
    # K1's main-path instantiations (5, 8 and 16 layers, no chunk loop,
    # no S1 phases, both sample types): 64 registers at most, no spills
    wanted = [f"pyramid_kernelI{t}Li{layers}ELb0ELb0E" for t in "ht"
              for layers in (5, 8, 16)]
    main = {k: v for k, v in ptxas_report(_build.build_log()).items()
            if any(w in k for w in wanted)}
    log(f"  K1 main-path instantiations (registers, spilled bytes): "
        f"{sorted(main.values())}")
    check(len(main) == 6 and all(r <= 64 and not sp
                                 for r, sp in main.values()),
          f"K1's main-path instantiations: {main}")
    # K2 (one kernel for the whole frame and the band, both planes) and
    # K4 share blend_run: every instantiation without spills
    warps = {k: v for k, v in ptxas_report(_build.build_log()).items()
             if "pair_blend_kernel" in k or "fused_blend_kernel" in k}
    log(f"  K2 / K4 instantiations (registers, spilled bytes): "
        f"{sorted(warps.values())}")
    check(any("pair_blend_kernel" in k for k in warps)
          and any("fused_blend_kernel" in k for k in warps)
          and not any(sp for _, sp in warps.values()),
          f"K2 and K4's instantiations: {warps}")
    # the native host library (readers, codecs), built here so that no
    # CLI run below pays for it
    from mpv_frame_interpolator_tpu_torch import native
    t0 = time.perf_counter()
    native.load()
    log(f"phase 2: built the native host library {native.build()} in "
        f"{time.perf_counter() - t0:.1f} s")
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    log(f"  K1 pyramid_kernel resident blocks an SM: "
        f"{KS.blocks_per_sm(1)} (uint8), {KS.blocks_per_sm(2)} (uint16); "
        f"with S1's phases {KS.blocks_per_sm(1, subpel=True)} / "
        f"{KS.blocks_per_sm(2, subpel=True)}, at radius 5 "
        f"{KS.blocks_per_sm(1, 5, 5, True)}, at radius 24 "
        f"{KS.blocks_per_sm(1, 24, 24, True)}")
    for sample in (1, 2):
        for layers, radius in ((5, 5), (8, 8), (16, 16), (24, 24)):
            check(KS.blocks_per_sm(sample, layers, radius) >= 4,
                  f"K1 ({layers} layers, radius {radius}, {sample}-byte "
                  f"samples) holds fewer than 4 blocks an SM")

    log("phase 3: kernels vs plain versions at 4K shapes")
    results = phase_kernels(dev)
    log("phase 3b: toolchain probes P1 and P2")
    probes = phase_probes(dev, smi)
    log("phase 4: engine on the card vs engine on the CPU, small clips")
    phase_reference(dev)
    log("phase 5: main path end to end (cli, 4K 24->120, radius 16)")
    main_launches = phase_main_path(dev)
    phase_engine_rate(dev)
    log("phase 6: P010 fused path end to end (cli, 4K 24->120, radius 16, "
        "levels 16/235)")
    p010_launches = phase_p010_path(dev)
    phase_engine_rate(dev, p010=True, sampling="fused")
    log("phase 7: output mode 0 end to end (cli --mode warp12, 4K 24->120, "
        "radius 16)")
    warp12_launches = phase_warp12_path(dev)
    phase_engine_rate(dev, mode=0)
    log("phase 8: blended output on the pallas sampler (cli "
        "--warp-sampling pallas, 4K 24->120, radius 16)")
    pallas_launches = phase_pallas_path(dev)
    log("phase 9: model hopperxq end to end (cli --model hopperxq, 4K "
        "24->120, radius 16)")
    hopperxq_launches = phase_hopperxq_path(dev)
    log("phase 10: model hopperx end to end (cli --model hopperx, 4K "
        "24->120, radius 16)")
    hopperx_launches = phase_hopperx_path(dev)
    log("phase 11: model hopperq with the sub-pel flow end to end (cli "
        "--model hopperq --subpel-flow, 4K 24->120, radius 16)")
    subpel_launches = phase_subpel_path(dev)
    log("phase 12: the auto-quality ladder on the card (engine, 4K "
        "24->120, radius 16 -> 5, levels 0 -> 3 -> 0)")
    phase_ladder(dev)
    log("phase 13: the player at 4K (cli on a 24-frame 4K y4m file, 24->120,"
        " radius 16: staged uploads, unstaged, --group 8)")
    player_launches = phase_player(dev)
    log("phase 14: the grouped engine at 4K (push, push_many in groups of 4 "
        "and 8 from captured CUDA graphs)")
    grouped = {"NV12 pair": phase_grouped_engine(dev),
               "P010 fused": phase_grouped_engine(dev, p010=True,
                                                  sampling="fused")}
    log("phase 15: seek, loop and end on the card against the CPU")
    phase_player_commands(dev)
    log("phase 16: the CLI's sources and sinks on the card (4K y4m, raw "
        "MKV and FFV1 MKV in, FFV1 MKV out; small clips against the CPU)")
    t0 = time.perf_counter()
    phase_sources_sinks(dev)
    log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
    log("phase 17: the control surfaces on the card (api.Player property "
        "script against fresh engines, push_many across changes, the CLI "
        "with IPC, applet, trace and resume, config profiles)")
    t0 = time.perf_counter()
    phase_control(dev)
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s")
    log("phase 18: the last modules on the card (parity against the "
        "oracle copy, K1's layer slice and K2's row band, chip time on "
        "graphs, pair pool, multi-stream engine, stream farm, the sharded "
        "step at world sizes 1, 2 and 4, the dry run on 4 ranks)")
    parallel_results, sharded_launches = phase_parallel(dev)
    results.update(parallel_results)
    log("phase 19: the last tools on the card (the quality report with the "
        "kernels against the plain versions, the degrade ladder at 4K, the "
        "embed and serving-farm examples)")
    phase_last_tools(dev)
    log("phase 20: the views of modes 3, 5, 6 and 4 end to end (cli --mode "
        "hsv|sbs1|sbs2|grey, 4K 24->120, radius 16; device and calc ms a "
        "pair against the bar; auto-quality keeps radius 16, level 0)")
    views_launches, views = phase_views(dev)

    # each kernel's launches on the path it serves: K1-K3 on the 8-bit
    # main path (K3 as the blur phase of K1's launches), K4 on the P010
    # fused path, K5 on the warp12 path, G1 on the pallas path, its
    # occlusion variant on the hopperx path, Q1 on the hopperxq path, the
    # probes through their own entry points
    pallas = "mpv_frame_interpolator_tpu/ops/pallas/"
    results.update(probes)
    sources = {
        "flow_step": ("flow_step.cu", pallas + "flow_step.py:350",
                      main_launches["flow_step"]),
        "blur_flow": ("blur_tile.cuh", pallas + "blur.py:41",
                      main_launches["blur_fused"]
                      + main_launches["blur_flow"]),
        "pair_blend": ("warp_pair.cu", pallas + "warp_pair.py:189",
                       main_launches["pair_blend"]),
        "fused_blend": ("warp_fused.cu", pallas + "warp_fused.py:188",
                        p010_launches["fused_blend"]),
        "sample_dir": ("warp_sample.cu", pallas + "warp_sample.py:128",
                       warp12_launches["sample_dir"]),
        # not a TPU kernel: the XLA fusion of _blend_fix and the level maps
        "blend_levels": ("blend_levels.cu",
                         "mpv_frame_interpolator_tpu/ops/warp.py:700",
                         pallas_launches["blend_levels"]),
        # not TPU kernels: G1's occlusion variant replaces the XLA ops of
        # _occlusion_adjust with the blend, Q1 the XLA 1/64-pel sampler
        # _bilinear_all_planes with the blend, occlusion and levels
        "blend_levels_occlusion": ("blend_levels.cu",
                                   "mpv_frame_interpolator_tpu/ops/"
                                   "warp.py:103",
                                   hopperx_launches["blend_levels"]),
        "bilinear_blend": ("warp_bilinear.cu",
                           "mpv_frame_interpolator_tpu/ops/warp.py:521",
                           hopperxq_launches["bilinear_blend"]),
        # not TPU kernels either: Q1 with the sub-pel field replaces the
        # XLA gathers of _warp_sample's bilinear branch with its FX fields,
        # S1 the XLA function subpel_refine
        "bilinear_blend_frac": ("warp_bilinear.cu",
                                "mpv_frame_interpolator_tpu/ops/warp.py:1021",
                                subpel_launches["bilinear_blend"]),
        # S1 runs as two phases of K1's launch on the sub-pel path, as K3
        # runs as its blur phase on every path
        "subpel_refine": ("subpel_tile.cuh",
                          "mpv_frame_interpolator_tpu/ops/flow.py:833",
                          subpel_launches["subpel_fused"]
                          + subpel_launches["subpel_refine"]),
        # launch modes of K1 and K2 for the sharded step (phase 18, world
        # size 1): they replace the XLA layer sums of the JAX package's
        # shard_map body and its GSPMD row sharding
        "flow_layer_slice": ("flow_slice.cu",
                             "mpv_frame_interpolator_tpu/parallel/"
                             "sharding.py:60",
                             sharded_launches["flow_layer_slice"]),
        "pair_blend_rows": ("warp_pair.cu",
                            "mpv_frame_interpolator_tpu/parallel/"
                            "sharding.py:165",
                            sharded_launches["pair_blend_rows"]),
        # not TPU kernels: V1 and V2 replace the XLA gathers of the side-by-
        # side views and the float colour ops of the HSV view (phase 20)
        "warp_sbs": ("warp_views.cu",
                     "mpv_frame_interpolator_tpu/ops/warp.py:1178",
                     views_launches["sbs1"]["warp_sbs"]
                     + views_launches["sbs2"]["warp_sbs"]),
        "warp_hsv": ("warp_views.cu",
                     "mpv_frame_interpolator_tpu/ops/warp.py:785",
                     views_launches["hsv"]["warp_hsv"]),
        # not TPU kernels: C1 replaces the XLA code of the JAX source step
        # around the flow (the cut score, the cut, the folded positions,
        # the f2 probe) on the 8-bit main path, V3 the XLA grey view of
        # mode 4 (phase 20)
        "pair_prologue": ("pair_prologue.cu",
                          "mpv_frame_interpolator_tpu/pipeline/scene.py:19",
                          main_launches["pair_prologue"]),
        "warp_grey": ("warp_views.cu",
                      "mpv_frame_interpolator_tpu/ops/warp.py:945",
                      views_launches["grey"]["warp_grey"]),
        "pack_probe": ("pack_probe.cu", "tools/pallas_pack_probe.py:22",
                       probes["pack_probe"]["launches"]),
        "dma_probe": ("dma_probe.cu", "tools/pallas_dma_probe.py:22",
                      probes["dma_probe"]["launches"])}
    kernels = []
    for name, (src, replaces, launches) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpv_frame_interpolator_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            # no single PyTorch call computes K1-K5, G1, Q1 or P1 (mod
            # 2^32 window sums with an unsigned argmin, mirrored nearest
            # gathers with the fixed-point blend, a symmetric-pad integer
            # blur truncated toward zero, a nearest sample at a mirrored
            # coordinate rounded half away from zero -- grid_sample rounds
            # half to even and reflects otherwise -- the fixed-point blend
            # followed by integer level maps, 1/64-pel fixed-point
            # bilinear taps under mirror_edge2's clamp -- grid_sample's
            # bilinear mode weighs in float and reflects without it -- a
            # set of probes, nine windowed SAD probes and an integer
            # quadratic fit, V1's and V2's views, C1's strided score with
            # its float32 reciprocal and fold, V3's clamped magnitude);
            # P2's is the slice copy
            "library_ms": r.get("library_ms"),
            "device_ms": r.get("device_ms"),
            # K2 under P010 and at N = 1..5, the band at 1, 2 and 4
            # bands, K4 at 8 bits
            # V2: its samples that differ from the plain version, and the
            # largest share of a plane more than 2 apart (the tolerance)
            **{k: r[k] for k in ("p010_device_ms", "n_device_ms",
                                 "bands_device_ms", "nv12_device_ms",
                                 "differing", "over2_share")
               if k in r}})
    log(f"launches on the 8-bit main path {main_launches}, on the P010 "
        f"fused path {p010_launches}, on the warp12 path {warp12_launches}, "
        f"on the pallas blend path {pallas_launches}, on the hopperxq path "
        f"{hopperxq_launches}, on the hopperx path {hopperx_launches}, on "
        f"the sub-pel hopperq path {subpel_launches}")
    log(f"launches on the staged 4K player run {player_launches}")
    log(f"the views a 4K pair (phase 20): {json.dumps(views)}")
    log(f"grouped engine, a pair: {json.dumps(grouped)}")
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
