"""Per-pair device time of the engine's pair body, from captured CUDA
graphs (counterpart of the JAX package's ``utils/chiptime.py``).

The JAX package chains k pair steps under ``lax.scan`` in one program, so
that the host cannot pace the chip, and takes (t(k2) - t(k1)) / (k2 - k1),
which cancels every fixed cost.  The port's counterpart of that one
program is one CUDA graph that holds k pair bodies, captured by the
grouped path's machinery (``pipeline/engine._GroupGraph``): a replay is a
single launch, so the card runs the k pairs back to back whatever the
host does, and the difference of two replays' CUDA-event times cancels
the launch and the events.  An event-timed loop of ``push`` would time
the host instead (its enqueue, ~0.9 ms a 4K pair, exceeds the pair's
device time).  On the CPU the same k bodies run eagerly under
``time.perf_counter``, as the JAX harness runs on any backend.

    python -m mpv_frame_interpolator_tpu_torch.tools.chip_time [WxH] [N] [radius]
"""

from __future__ import annotations

import time


def chip_pair_seconds(width=3840, height=2160, n_outputs=5, radius=16,
                      model="hopper", k1=8, k2=40, p010=False,
                      repeats=2, layers=None, warp_sampling=None,
                      max_calc_res=None, num_iterations=0, device="cuda"):
    """Seconds of device time a pair of `n_outputs` blend positions takes
    on the engine's pair body: min over `repeats` of (t(k2) - t(k1)) /
    (k2 - k1), each t one replay of a graph of k pair bodies on the same
    pair (gradient_pan, 3 px right and 1 down a frame).  The defaults
    track the engine's: its sampler (``EngineConfig.warp_sampling``), the
    layer bucket of the radius and ``max_calc_res``."""
    import torch

    from mpv_frame_interpolator_tpu_torch.convert import require_device
    from mpv_frame_interpolator_tpu_torch.io import synthetic
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, InterpolationEngine, _GroupGraph, _GroupSlots)

    if not 1 <= k1 < k2:
        raise ValueError(f"need 1 <= k1 < k2, got {k1}, {k2}")
    dev = require_device(device)
    defaults = EngineConfig()
    cfg = EngineConfig(
        model=model, initial_search_radius=radius, auto_quality=False,
        measure_timing=False, scene_detection=True,
        warp_sampling=warp_sampling or defaults.warp_sampling,
        layer_buckets=(layers,) if layers else defaults.layer_buckets,
        max_calc_res=max_calc_res or defaults.max_calc_res,
        num_iterations=num_iterations, device=str(dev))
    engine = InterpolationEngine(cfg)
    src = synthetic.SyntheticConfig(width=width, height=height, fps=24.0,
                                    pixfmt="p010" if p010 else "nv12")
    f1, f2, _ = list(synthetic.gradient_pan(src, 3, vx=3, vy=1))
    engine._ensure_geometry(f1.fmt)
    knobs = engine._knobs()
    pair = (engine._use(f1), engine._use(f2))
    ts = torch.linspace(0.1, 0.9, n_outputs, dtype=torch.float32,
                        device=dev)
    slots = _GroupSlots(f1.fmt, 1, n_outputs, dev)
    slots.fill([pair], ts[None])

    def body_of(k):
        def body(slots, cuts):
            return [engine._pair_outputs(0, radius, slots.frames[0],
                                         slots.frames[1], slots.ts[0], cuts,
                                         knobs) for _ in range(k)]
        return body

    on_cuda = dev.type == "cuda"
    if on_cuda:
        graphs = {k: _GroupGraph(slots, body_of(k), engine._cuts)
                  for k in (k1, k2)}
        for g in graphs.values():       # the first replay uploads the graph
            g.replay()
        torch.cuda.synchronize(dev)

    def run(k) -> float:
        if not on_cuda:
            t0 = time.perf_counter()
            body_of(k)(slots, engine._cuts)
            return time.perf_counter() - t0
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        graphs[k].replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3

    if not on_cuda:
        for k in (k1, k2):              # warm, as the card's first replays
            run(k)
    best = []
    for _ in range(repeats):
        times = {k: run(k) for k in (k1, k2)}
        best.append((times[k2] - times[k1]) / (k2 - k1))
    return min(best)
