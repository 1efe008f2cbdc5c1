"""The port's StreamFarm on the CPU: the analog of the JAX package's
tests/test_farm.py.  Each stream is a full engine on its own worker
thread; the farm gives the bytes of independent sequential engines (and,
for one stream, of the JAX engine), keeps streams independent (rates,
formats, degradation, failures) and applies per-stream backpressure."""

import dataclasses as dc
import queue
import threading

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.io import synthetic as jax_synthetic
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.parallel.farm import (
    StreamFarm, StreamWorkerError)
from mpv_frame_interpolator_tpu_torch.pipeline.cadence import (
    InterpolationState)
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)

from _stream_timing import OVERLOAD, pin_healthy

torch.set_num_threads(1)

KW = dict(scene_detection=False, auto_quality=False, measure_timing=False)
SMALL = synthetic.SyntheticConfig(width=64, height=48, fps=24.0)


def cfg(**kw):
    return EngineConfig(device="cpu", **kw)


def sources(n_streams, n_frames, fps=None):
    cfgs = [dc.replace(SMALL, seed=SMALL.seed + k,
                       **({"fps": fps} if fps else {}))
            for k in range(n_streams)]
    return [list(synthetic.gradient_pan(c, n_frames)) for c in cfgs]


def run_sequential(config, frames):
    eng = InterpolationEngine(config)
    return [eng.push(f) for f in frames]


def same_batches(expect, got):
    assert len(got) == len(expect)
    for outs_e, outs_g in zip(expect, got):
        assert len(outs_g) == len(outs_e)
        for a, b in zip(outs_e, outs_g):
            va, vb = a.to_video_frame(), b.to_video_frame()
            assert va.pts == vb.pts
            np.testing.assert_array_equal(va.y, vb.y)
            np.testing.assert_array_equal(va.uv, vb.uv)


class TestOutputParity:
    def test_matches_sequential_engines_and_jax(self):
        config = cfg(**KW, initial_search_radius=5)
        srcs = sources(3, 5)
        expect = [run_sequential(config, s) for s in srcs]
        with StreamFarm(config, n_streams=3) as farm:
            for step in range(5):
                for sid in range(3):
                    farm.submit(sid, srcs[sid][step])
            got = farm.drain_all(timeout=120.0)
        for sid in range(3):
            same_batches(expect[sid], got[sid])
        ref = jax_engine.InterpolationEngine(jax_engine.EngineConfig(
            background_precompile=False, initial_search_radius=5, **KW))
        jcfg = jax_synthetic.SyntheticConfig(width=64, height=48, fps=24.0,
                                             seed=SMALL.seed)
        same_batches([ref.push(f) for f in
                      jax_synthetic.gradient_pan(jcfg, 5)], got[0])

    def test_mixed_formats_per_stream(self):
        """Unlike the lockstep engine, streams may differ in geometry and
        pixel format."""
        fa = list(synthetic.gradient_pan(SMALL, 3))
        fb = list(synthetic.gradient_pan(dc.replace(
            SMALL, width=32, height=32, pixfmt="p010"), 3))
        with StreamFarm(cfg(**KW), n_streams=2) as farm:
            for step in range(3):
                farm.submit(0, fa[step])
                farm.submit(1, fb[step])
            got = farm.drain_all(timeout=120.0)
        assert got[0][0][0].fmt.pixfmt == "nv12"
        assert got[1][0][0].fmt.pixfmt == "p010"
        assert got[1][-1][-1].to_video_frame().y.dtype == np.uint16


class TestIndependence:
    def test_stalled_stream_does_not_gate_others(self):
        srcs = sources(1, 4)
        with StreamFarm(cfg(**KW), n_streams=2) as farm:
            for f in srcs[0]:
                farm.submit(0, f)
            got = farm.drain(0, timeout=120.0)
            assert farm.pending(1) == 0
        assert sum(len(o) for o in got) >= 4

    def test_per_stream_rates(self):
        srcs = sources(2, 6)
        with StreamFarm(cfg(**KW), n_streams=2) as farm:
            for f in srcs[0]:
                farm.submit(0, f)
            for f in srcs[1][:2]:
                farm.submit(1, f)
            got = farm.drain_all(timeout=120.0)
        assert len(got[0]) == 6
        assert len(got[1]) == 2

    def test_degradation_isolated(self):
        config = cfg(scene_detection=False, auto_quality=True,
                     measure_timing=True, initial_search_radius=8,
                     too_slow_patience=1000)
        srcs = sources(2, 6, fps=8.0)
        farm = StreamFarm(config, n_streams=2)
        try:
            for step in range(3):
                # stream 0's worker is idle here (drained): safe to poke
                pin_healthy(farm.engines[0])
                farm.submit(0, srcs[0][step])
                farm.drain(0, timeout=120.0)
                farm.submit(1, srcs[1][step])
            farm.drain_all(timeout=120.0)
            r0 = farm.engines[0].quality.search_radius
            r1 = farm.engines[1].quality.search_radius
            for step in range(3, 6):
                # the workers are idle here (drained): safe to poke
                farm.engines[1]._last_calc_duration = OVERLOAD
                farm.submit(1, srcs[1][step])
                farm.drain(1, timeout=120.0)
                pin_healthy(farm.engines[0])
                farm.submit(0, srcs[0][step])
                farm.drain(0, timeout=120.0)
            assert farm.engines[1].quality.search_radius <= max(r1 - 3, 5)
            assert farm.engines[0].quality.search_radius >= r0
            assert farm.engines[0].cadence.state == InterpolationState.ACTIVE
        finally:
            farm.close()

    def test_worker_error_propagates_and_is_isolated(self):
        srcs = sources(2, 3)
        farm = StreamFarm(cfg(**KW), n_streams=2)
        try:
            farm.submit(0, "not a frame")      # kills stream 0's worker
            with pytest.raises(StreamWorkerError) as ei:
                farm.get(0, timeout=60.0)
            assert ei.value.stream_id == 0
            with pytest.raises(StreamWorkerError):
                farm.submit(0, srcs[0][0])     # stream 0 stays dead
            for f in srcs[1]:                  # stream 1 unaffected
                farm.submit(1, f)
            assert len(farm.drain(1, timeout=120.0)) == 3
        finally:
            farm.close()


class TestFlowControl:
    def test_backpressure_is_per_stream(self):
        """A full input queue blocks only that stream's producer."""
        srcs = sources(2, 8)
        farm = StreamFarm(cfg(**KW), n_streams=2, queue_depth=1)
        try:
            stop = threading.Event()

            def flood():
                i = 0
                while not stop.is_set():
                    try:
                        farm.submit(0, srcs[0][i % 8], timeout=0.05)
                        i += 1
                    except queue.Full:
                        pass

            t = threading.Thread(target=flood, daemon=True)
            t.start()
            for f in srcs[1]:
                farm.submit(1, f)
            assert len(farm.drain(1, timeout=120.0)) == 8
            stop.set()
            t.join(timeout=10.0)
            assert not t.is_alive()
        finally:
            farm.close()
            farm.drain_all(timeout=120.0)   # results survive close()

    def test_get_without_submit_raises(self):
        with StreamFarm(cfg(**KW), n_streams=1) as farm:
            with pytest.raises(queue.Empty):
                farm.get(0)
            assert farm.try_get(0) is None

    def test_close_then_submit_raises(self):
        farm = StreamFarm(cfg(**KW), n_streams=1)
        farm.close()
        with pytest.raises(RuntimeError):
            farm.submit(0, sources(1, 1)[0][0])

    def test_per_stream_configs(self):
        configs = [cfg(**KW, display_fps=60.0), cfg(**KW, display_fps=120.0)]
        srcs = sources(2, 4)
        with StreamFarm(n_streams=2, configs=configs) as farm:
            for step in range(4):
                farm.submit(0, srcs[0][step])
                farm.submit(1, srcs[1][step])
            got = farm.drain_all(timeout=120.0)
        n0 = sum(len(o) for o in got[0])
        n1 = sum(len(o) for o in got[1])
        assert n1 > n0    # the 120 Hz stream makes ~2x the outputs
