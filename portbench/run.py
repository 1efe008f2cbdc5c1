"""Runs one cell of the benchmark once.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up (``setup_s``, from the start of the process): import, the
kernels' library (built into ``build/mfi_torch_kernels/<hash>/`` in the
checkout at the first run there), the ring of source frames made on the
card from the seed, one engine, and the cell's own calls as warm-up (the
group graph's capture included).  Then the measured window of
``--seconds``: the traffic's calls back to back, ending when the last
output is ready.  With ``--trace 1`` a profiled stretch follows.  Then
the check (``check.py``), once the program's state is freed, and the
result: the last line of standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` when traced), and last the numbers compared (``checks``),
which also end standard error.

The configuration file reaches the engine whole (``engine_config``): each
key is the benchmark's own (``BENCH_KEYS``) or a field of the engine's
``EngineConfig``, and the reference that judges the outputs is the one
the configuration chooses (``reference/models.py``).  A key of neither
kind, or a configuration that its reference does not cover, stops the
run at set-up, before the ring is made, with a message that names it and
no result.

Without CUDA, or with fewer cards than the cell asks for, the run fails
and prints no result; it never falls back to the CPU.  It fails as well
if ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from portbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "mpv_frame_interpolator_tpu")
# the configuration file's own keys; every other key is a field of the
# engine's EngineConfig
BENCH_KEYS = ("source", "assumed", "reduced", "width", "height", "pixfmt",
              "source_fps", "device", "reference")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    each compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the kernels' own library already lands in ``build/`` there)."""
    base = spec.ROOT / "build" / "portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


@dataclasses.dataclass
class Shapes:
    """The cell's shapes, as the work counts and readers take them."""
    height: int
    width: int
    stride: int
    item: int
    scale_shift: int
    rs: int
    lh: int
    lw: int
    windows: tuple
    radius: int
    positions: int          # outputs a pair
    levels: tuple


@dataclasses.dataclass
class RunView:
    """What the metric readers read."""
    cell: dict
    config: dict
    traffic: dict
    shapes: Shapes
    setup_s: float
    calls: list             # the window's calls (driver.Call)
    window_s: float         # first call to the last output's completion
    latencies_ms: list      # each call's start to its last output
    launches: int           # kernel launches the window counted
    peaks: object           # work.Peaks or None
    trace: object           # trace.TraceView or None

    @property
    def pairs(self) -> int:
        return sum(c.frames for c in self.calls)

    @property
    def outputs(self) -> int:
        return sum(len(c.pts) for c in self.calls)

    def host_ms_per_pair(self) -> Optional[float]:
        """The host's time inside the engine's calls a pair: the
        benchmark's spans around each call, their total over the pairs."""
        if not self.pairs:
            return None
        return sum(c.t1 - c.t0 for c in self.calls) / self.pairs * 1e3


def _tuples(value):
    """Lists, nested too, as tuples (JSON has no tuple)."""
    if isinstance(value, (list, tuple)):
        return tuple(_tuples(v) for v in value)
    return value


def engine_config(cfg: dict, device: str):
    """(EngineConfig, settings): the engine's configuration that the
    configuration file `cfg` states, each of its keys that is a field of
    EngineConfig passed as it stands (lists as tuples where the field is
    a tuple), on `device`; and `cfg` with every field of that
    EngineConfig but ``device`` filled in, as the reference reads it.  A
    key that is neither the benchmark's (``BENCH_KEYS``) nor a field is a
    ``spec.SetupError`` that names it."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import EngineConfig
    fields = {f.name: f for f in dataclasses.fields(EngineConfig)
              if f.name != "device"}
    unknown = sorted(set(cfg) - set(BENCH_KEYS) - set(fields))
    if unknown:
        raise spec.SetupError(
            f"configuration keys {unknown} are neither the benchmark's "
            f"{list(BENCH_KEYS)} nor fields of EngineConfig")
    given = {k: _tuples(cfg[k]) if isinstance(fields[k].default, tuple)
             else cfg[k] for k in fields if k in cfg}
    engine_cfg = EngineConfig(**given, device=device)
    return engine_cfg, {**cfg, **{k: getattr(engine_cfg, k) for k in fields}}


def _note(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _by_second(calls) -> List[int]:
    """Outputs of the calls made in each whole second of the window."""
    counts: Dict[int, int] = {}
    for c in calls:
        k = int(c.t0 - calls[0].t0)
        counts[k] = counts.get(k, 0) + len(c.pts)
    return [counts.get(k, 0) for k in range(max(counts) + 1)][:-1]


def _segments(on_cuda: bool) -> int:
    """Device memory segments the caching allocator has made so far (each
    one a cudaMalloc)."""
    if not on_cuda:
        return 0
    import torch
    return int(torch.cuda.memory_stats().get("segment.all.allocated", 0))


def _kernel_launches() -> int:
    from mpv_frame_interpolator_tpu_torch.pipeline import engine as eng
    return sum(c.kernel for c in eng._KERNEL_COUNTS)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[dict] = None,
             max_calls: Optional[int] = None,
             engine_hook: Optional[Callable] = None) -> dict:
    """One run of a cell; returns the result object (without printing).
    `overrides` (``spec.settings``), `max_calls` and `engine_hook`
    (called with the engine before set-up) serve the CPU tests, at small
    sizes."""
    import torch

    import mpv_frame_interpolator_tpu_torch as port
    from mpv_frame_interpolator_tpu_torch.frame import FrameFormat
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        InterpolationEngine)
    from portbench import check, content, driver, work
    from portbench import trace as tracing
    from portbench.reference import models
    from portbench.reference import pair as ref

    if spec.ROOT not in Path(port.__file__).resolve().parents:
        raise RuntimeError(f"the program under test {port.__file__} is not "
                           f"the checkout's ({spec.ROOT})")
    bench = spec.benchmark()
    cell, cfg, traffic, ring_params, sample = spec.settings(cell_name,
                                                            overrides)
    on_cuda = device == "cuda"
    engine_cfg, cfg = engine_config(cfg, device)
    models.for_config(cfg)      # a configuration it does not cover stops here

    fmt = FrameFormat(cfg["width"], cfg["height"], cfg["pixfmt"])
    scale_shift = 0 if cfg["pixfmt"] == "nv12" else 8
    geom = ref.geometry(cfg["height"], cfg["width"], cfg["width"],
                        cfg["max_calc_res"], cfg["num_iterations"])
    levels = ref.level_ints(cfg["black_level"], cfg["white_level"])
    ring = content.make_ring(cfg["width"], cfg["height"], cfg["pixfmt"],
                             content.RingParams(**ring_params), seed, device)
    engine = InterpolationEngine(engine_cfg)
    if engine_hook is not None:
        engine = engine_hook(engine)
    stream = driver.Stream(ring, fmt, float(cfg["source_fps"]))
    drv = driver.Driver(engine, stream, traffic)
    dev = torch.device(device)
    drv.warm(int(traffic["warm_calls"]),
             int(sample["pairs"]) + int(sample["cut_pairs"]) + 1)
    setup_s = driver.drain(dev) - t_start
    _note(f"set-up {setup_s:.3f} s")

    first = stream.next_index
    shot_len = int(ring_params["frames_per_shot"])
    sampled = check.sample_frames(seed, first, sample, shot_len)
    plan = check.plan_for(max(sampled) + 1, cfg)
    drv.keep_pts = {pts: f for f in sampled for pts, _ in (plan[f] or ())}
    launches0, segments0 = _kernel_launches(), _segments(on_cuda)
    calls = drv.run(seconds, max_calls)
    t_end = driver.drain(dev)
    latencies = driver.latencies_ms(calls, dev)
    launches = _kernel_launches() - launches0
    _note(f"device memory segments the caching allocator made in the "
          f"window: {_segments(on_cuda) - segments0}")
    last, last_frame = drv.last, stream.next_index - 1
    _note(f"window {t_end - calls[0].t0:.3f} s, {len(calls)} calls; "
          f"outputs a second, second by second: {_by_second(calls)}")
    view_trace = None
    if trace:
        def stretch(s):
            n = sum(c.frames for c in drv.run(s))
            driver.drain(dev)
            return n
        view_trace = tracing.stretch(stretch, float(
            traffic["trace_stretch_s"]))
        _note("host ops of the traced stretch (name, calls, us): "
              f"{view_trace.host_ops}")
    memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    program_cuts = engine.scene_cuts()
    frames = stream.next_index
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded: {found}")

    outputs = dict(drv.kept)
    plan = check.plan_for(frames, cfg)
    last_pts = {p for p, _ in (plan[last_frame] or ())}
    outputs[last_frame] = [o for o in (last or []) if o.pts in last_pts]
    # free the program's state before the reference runs
    del engine, drv, last
    stream.ring = None
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    cuts = check.transition_cuts(ring, geom, scale_shift,
                                 float(cfg["scene_threshold"]),
                                 bool(cfg["scene_detection"]))
    verdict = check.judge(ring, cfg, geom, plan, calls, outputs, cuts,
                          program_cuts, frames, scale_shift, levels)
    _note(f"check {time.perf_counter() - t_check:.3f} s")

    kind = torch.cuda.get_device_name(0) if on_cuda else "cpu"
    shapes = Shapes(cfg["height"], cfg["width"], cfg["width"],
                    1 if scale_shift == 0 else 2, scale_shift, geom.rs,
                    geom.lh, geom.lw, geom.windows,
                    int(cfg["initial_search_radius"]),
                    len(plan[first] or ()), levels)
    view = RunView(cell, cfg, traffic, shapes, setup_s, calls,
                   t_end - calls[0].t0, latencies, launches,
                   work.peaks_for(kind), view_trace)
    entries = (spec.per_layer(bench, cell_name) if trace
               else spec.end_to_end(bench, cell_name))
    metrics = {}
    for m in entries:
        value = spec.reader(m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    card = {"platform": "gpu" if on_cuda else "cpu", "kind": kind,
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(memory_peak)}
    if view_trace is not None:
        card["busy_s"] = view_trace.busy_us / 1e6
        card["window_s"] = view_trace.window_us / 1e6
    result = {"correct": verdict.correct, "attempted": view.pairs,
              "failed": verdict.failed, "metrics": metrics, "device": card}
    if view_trace is not None:
        result["breakdown"] = view_trace.breakdown()
    result["checks"] = verdict.checks
    return result


def _card_name_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = spec.workload(spec.benchmark(), args.workload)
    _cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available; no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found; no result",
              file=sys.stderr)
        return 3
    print(f"portbench: {_card_name_and_limit()}", file=sys.stderr)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start)
    except spec.SetupError as e:
        print(f"portbench: set-up: {e}; no result", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['op']} {c['limit']} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0
