"""The port's player on the CPU (the analogs of the JAX package's
``tests/test_seek.py``, ``test_pause.py``, ``test_framedrop.py`` and
``test_display_sync.py``): the y4m reader's O(1) seek and its pooled
buffers, ``RawYUVReader``, the pipeline's seek, loop, end, pause, resume,
frame-step and quit, late-source shedding, display-rate retargeting,
counted fail-open, staged uploads, and one seek + loop run against the
JAX ``Pipeline`` on the same y4m bytes.  Every thread is joined with a
timeout; pause is observed at the pipeline's pause gate, not by sleeping
and counting."""

import io
import threading

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.io import y4m as jax_y4m
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu.pipeline import player as jax_player
from mpv_frame_interpolator_tpu_torch import cli as port_cli
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool
from mpv_frame_interpolator_tpu_torch.io.y4m import (
    RawYUVReader, Y4MError, Y4MReader, Y4MWriter)
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator_tpu_torch.pipeline.player import Pipeline
from mpv_frame_interpolator_tpu_torch.pipeline.present import (
    PresentClock, PresentInfo)

torch.set_num_threads(1)

JOIN_S = 60.0


def small_y4m(n=20, w=16, h=16, fps=24.0, pixfmt="nv12") -> io.BytesIO:
    cfg = synthetic.SyntheticConfig(width=w, height=h, fps=fps,
                                    pixfmt=pixfmt)
    buf = io.BytesIO()
    wtr = Y4MWriter(buf, w, h, fps, pixfmt)
    for f in synthetic.moving_box(cfg, n):
        wtr.write(f)
    buf.seek(0)
    return buf


def reader(buf) -> Y4MReader:
    return Y4MReader(buf, pool=PinnedPool(8, device="cpu"))


def eng(**kw):
    kw.setdefault("scene_detection", False)
    return InterpolationEngine(EngineConfig(
        auto_quality=False, measure_timing=False, device="cpu", **kw))


class _PtsSink:
    """Records pts; queues a pipeline seek after `trigger_at` writes."""

    def __init__(self, pipe_ref=None, seek_to=None, trigger_at=None):
        self.pts = []
        self._pipe_ref = pipe_ref
        self._seek_to = seek_to
        self._trigger_at = trigger_at

    def write(self, out):
        self.pts.append(out.pts)
        if self._trigger_at is not None and len(self.pts) == self._trigger_at:
            self._pipe_ref[0].seek(self._seek_to)

    def close(self):
        pass


# --- the readers ------------------------------------------------------------

def test_reader_seek_frame_is_o1():
    rdr = reader(small_y4m(50))
    assert rdr.seekable() and rdr.n_frames() == 50
    rdr.seek_frame(40)
    frames = list(rdr)
    assert len(frames) == 10
    assert frames[0].pts == pytest.approx(40 / 24.0)


def test_reader_seek_pts_and_backwards():
    rdr = reader(small_y4m(30))
    first = next(iter(rdr))
    y0 = first.y.copy()
    assert first.pts == 0.0
    assert rdr.seek_pts(20 / 24.0) == pytest.approx(20 / 24.0)
    assert next(iter(rdr)).pts == pytest.approx(20 / 24.0)
    rdr.seek_pts(0.0)
    f0 = next(iter(rdr))
    assert f0.pts == 0.0
    np.testing.assert_array_equal(f0.y, y0)


def test_reader_seek_past_eof_and_variable_markers():
    assert list(_seeked(reader(small_y4m(10)), 500)) == []
    base = small_y4m(8, w=8, h=8).getvalue()
    header_end = base.index(b"\n") + 1
    payload = 8 * 8 + 2 * 4 * 4
    out, pos, idx = bytearray(base[:header_end]), header_end, 0
    while pos < len(base):
        marker_end = base.index(b"\n", pos) + 1
        out += b"FRAME Ip\n" if idx == 2 else base[pos:marker_end]
        out += base[marker_end:marker_end + payload]
        pos, idx = marker_end + payload, idx + 1
    frames = list(_seeked(reader(io.BytesIO(bytes(out))), 5))
    assert len(frames) == 3 and frames[0].pts == pytest.approx(5 / 24.0)


def _seeked(rdr, n):
    rdr.seek_frame(n)
    return rdr


def test_reader_unseekable_raises():
    class NoSeek(io.RawIOBase):
        def __init__(self, data):
            self._b = io.BytesIO(data)

        def readinto(self, b):
            return self._b.readinto(b)

        def readable(self):
            return True

        def seekable(self):
            return False

    rdr = reader(io.BufferedReader(NoSeek(small_y4m(4).getvalue())))
    assert not rdr.seekable()
    with pytest.raises(Y4MError):
        rdr.seek_frame(2)
    assert len(list(rdr)) == 4


@pytest.mark.parametrize("pixfmt", ["nv12", "p010"])
def test_reader_recycles_pooled_buffers(pixfmt):
    """Frames come from the pool; recycle hands both planes back, so the
    next frames reuse them, and the planes equal the JAX reader's."""
    data = small_y4m(6, w=16, h=8, pixfmt=pixfmt).getvalue()
    pool = PinnedPool(8, device="cpu")
    assert not pool.pinned
    port = Y4MReader(io.BytesIO(data), pool=pool)
    ref = list(jax_y4m.Y4MReader(io.BytesIO(data)))
    for i, (f, r) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(f.y, r.y)
        np.testing.assert_array_equal(f.uv, r.uv)
        assert f.pts == r.pts
        f.recycle()
    stats = pool.stats()
    assert stats["misses"] == 2 and stats["hits"] == 10
    assert stats["lent"] == 0 and stats["free"] == 2


def test_reader_crops_odd_sizes():
    buf = io.BytesIO()
    w, h = 9, 7
    buf.write(f"YUV4MPEG2 W{w} H{h} F24:1 C420mpeg2\n".encode())
    rng = np.random.default_rng(0)
    planes = rng.integers(0, 256, w * h + 2 * (w // 2) * (h // 2),
                          dtype=np.uint8)
    for _ in range(2):
        buf.write(b"FRAME\n" + planes.tobytes())
    buf.seek(0)
    frames = list(reader(buf))
    assert len(frames) == 2
    assert frames[0].y.shape == (6, 8) and frames[0].recycle is None
    np.testing.assert_array_equal(frames[0].y,
                                  planes[:w * h].reshape(h, w)[:6, :8])


def test_raw_reader_seek():
    cfg = synthetic.SyntheticConfig(width=16, height=16, fps=24.0)
    buf = io.BytesIO()
    src = list(synthetic.moving_box(cfg, 12))
    for f in src:
        buf.write(f.y.tobytes())
        buf.write(np.ascontiguousarray(f.uv[:, 0::2]).tobytes())
        buf.write(np.ascontiguousarray(f.uv[:, 1::2]).tobytes())
    buf.seek(0)
    rdr = RawYUVReader(buf, 16, 16, 24.0)
    assert rdr.seekable() and rdr.n_frames() == 12
    rdr.seek_pts(8 / 24.0)
    frames = list(rdr)
    assert len(frames) == 4
    assert frames[0].pts == pytest.approx(8 / 24.0)
    np.testing.assert_array_equal(frames[0].y, src[8].y)
    np.testing.assert_array_equal(frames[0].uv, src[8].uv)


# --- seek, loop, end ----------------------------------------------------------

def _seek_run(n_frames, seek_to, trigger_at, **kw):
    pipe_ref = [None]
    sink = _PtsSink(pipe_ref, seek_to=seek_to, trigger_at=trigger_at)
    pipe = Pipeline(reader(small_y4m(n_frames)), eng(), sink, present=None,
                    **kw)
    pipe_ref[0] = pipe
    pipe.run()
    return pipe, sink


def test_pipeline_seek_forward():
    """The seek lands at the next source-frame boundary: the current
    plan's outputs flush, then the timeline restarts at the target."""
    pipe, sink = _seek_run(24, 16 / 24.0, 5)
    assert pipe.seeks == 1
    jump = next(i for i, p in enumerate(sink.pts) if p >= 16 / 24.0 - 1e-6)
    assert jump - 5 <= 4
    assert (np.diff(sink.pts[jump:]) > 0).all()


@pytest.mark.parametrize("stage_uploads", [False, True])
def test_pipeline_seek_backwards(stage_uploads):
    pipe, sink = _seek_run(16, 0.0, 8, stage_uploads=stage_uploads)
    assert pipe.seeks == 1
    drops = np.where(np.diff(sink.pts) < 0)[0]
    assert len(drops) == 1
    j = int(drops[0]) + 1
    assert sink.pts[j] <= 2 / 24.0
    assert (np.diff(sink.pts[j:]) > 0).all()
    assert len(sink.pts) - j > 8


def test_pipeline_seek_unseekable_degrades_to_reset(small_cfg):
    frames = list(synthetic.moving_box(small_cfg, 8))
    pipe_ref = [None]
    sink = _PtsSink(pipe_ref, seek_to=0.1, trigger_at=3)
    pipe = Pipeline(iter(frames), eng(), sink, present=None)
    pipe_ref[0] = pipe
    pipe.run()
    assert pipe.seeks == 0
    assert len(sink.pts) > 3


def test_end_stops_early():
    sink = _PtsSink()
    pipe = Pipeline(reader(small_y4m(24)), eng(), sink, present=None)
    pipe.end_pts = 10 / 24.0
    pipe.run()
    assert pipe.frames_in <= 11
    assert max(sink.pts) <= 11 / 24.0 + 1e-9


def test_loop_replays_and_end_beats_loop():
    sink = _PtsSink()
    pipe = Pipeline(reader(small_y4m(8)), eng(), sink, present=None)
    pipe.loop = 2
    pipe.run()
    assert len(np.where(np.diff(sink.pts) < 0)[0]) == 2
    assert pipe.seeks == 2 and pipe.frames_in == 24
    sink = _PtsSink()
    pipe = Pipeline(reader(small_y4m(24)), eng(), sink, present=None)
    pipe.loop, pipe.end_pts = 5, 6 / 24.0
    pipe.run()
    assert pipe.seeks == 0
    assert max(sink.pts) <= 7 / 24.0 + 1e-9


def test_cli_loop_and_end(tmp_path):
    src = tmp_path / "in.y4m"
    src.write_bytes(small_y4m(10, w=64, h=48).getvalue())
    stats = tmp_path / "stats.json"
    out = tmp_path / "out.y4m"
    assert port_cli.main([str(src), "--device", "cpu", "--untimed",
                          "--no-auto-quality", "--loop", "1", "--end",
                          str(7 / 24.0), "-o", str(out), "--dump-stats",
                          str(stats), "--frames", "0"]) == 0
    import json
    d = json.loads(stats.read_text())
    # --end beats --loop: frames 0..7, no wrap
    assert (d["frames_in"], d["seeks"], d["engine_failures"]) == (8, 0, 0)
    assert port_cli.main([str(src), "--device", "cpu", "--untimed",
                          "--no-auto-quality", "--loop", "1", "-o",
                          str(out), "--dump-stats", str(stats),
                          "--frames", "0"]) == 0
    d = json.loads(stats.read_text())
    assert (d["frames_in"], d["seeks"]) == (20, 1)
    assert d["frames_out"] == 2 * (1 + 3 + 2 + 3 + 2 + 3 + 2 + 3 + 2 + 3)


def test_seek_and_loop_equal_the_jax_pipeline():
    """One seek (backwards, after 7 outputs) and one loop on a 64x48 y4m
    file: the port's pipeline writes the JAX pipeline's pts and bytes."""
    data = small_y4m(10, w=64, h=48).getvalue()
    results = []
    for rdr, engine, pipeline in (
            (jax_y4m.Y4MReader(io.BytesIO(data)),
             jax_engine.InterpolationEngine(jax_engine.EngineConfig(
                 auto_quality=False, measure_timing=False,
                 initial_search_radius=5, background_precompile=False)),
             jax_player.Pipeline),
            (reader(io.BytesIO(data)), eng(scene_detection=True),
             Pipeline)):
        pipe_ref = [None]
        frames = []

        class Sink(_PtsSink):
            def write(self, out):
                f = out.to_video_frame()
                frames.append((out.pts, np.array(f.y), np.array(f.uv)))
                super().write(out)

        pipe = pipeline(rdr, engine, Sink(pipe_ref, 2 / 24.0, 7),
                        present=None, stage_uploads=False)
        pipe_ref[0] = pipe
        pipe.loop = 1
        pipe.run()
        results.append((frames, pipe.seeks, pipe.frames_in))
    (ref, ref_seeks, ref_in), (port, seeks, n_in) = results
    assert (seeks, n_in) == (ref_seeks, ref_in) and seeks == 2
    assert len(port) == len(ref)
    for (p1, y1, uv1), (p2, y2, uv2) in zip(ref, port):
        assert p1 == p2
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(uv1, uv2)


# --- pause, frame-step, quit ------------------------------------------------

class _GatedPipeline(Pipeline):
    """Signals each time the consumer is at its pause gate (commands are
    applied there while paused)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.at_gate = threading.Event()

    def _apply_commands(self):
        super()._apply_commands()
        if not self._unpaused.is_set():
            self.at_gate.set()


class _PausingSink(_PtsSink):
    """Pauses the pipeline from the consumer thread after `n` writes."""

    def __init__(self, pipe_ref, n):
        super().__init__()
        self._ref, self._n = pipe_ref, n

    def write(self, out):
        super().write(out)
        if len(self.pts) == self._n:
            self._ref[0].set_pause(True)


def _wait_paused(pipe, frames_in):
    """Wait until the consumer sits at the pause gate with `frames_in`
    source frames consumed."""
    for _ in range(400):
        pipe.at_gate.clear()
        assert pipe.at_gate.wait(timeout=JOIN_S)
        if pipe.frames_in == frames_in and not pipe._unpaused.is_set():
            return
    raise AssertionError(f"not paused at {frames_in}: {pipe.frames_in}")


def test_pause_frame_step_resume(small_cfg):
    frames = list(synthetic.moving_box(small_cfg, 12))
    pipe_ref = [None]
    sink = _PausingSink(pipe_ref, 4)
    pipe = _GatedPipeline(iter(frames), eng(), sink, present=None)
    pipe_ref[0] = pipe
    t = threading.Thread(target=pipe.run, daemon=True)
    t.start()
    # outputs 1 | 3 (the 4th write pauses); the gate holds frame 3
    _wait_paused(pipe, 2)
    held = len(sink.pts)
    assert held == 4
    pipe.frame_step()
    _wait_paused(pipe, 3)
    assert len(sink.pts) == held + 2       # frame 3's two outputs
    pipe.set_pause(False)
    t.join(timeout=JOIN_S)
    assert not t.is_alive()
    assert pipe.frames_in == 12
    assert len(sink.pts) == 1 + 6 * 3 + 5 * 2    # 24 -> 60 over 12 frames


def test_quit_while_paused(small_cfg):
    frames = list(synthetic.moving_box(small_cfg, 12))
    pipe_ref = [None]
    sink = _PausingSink(pipe_ref, 1)
    pipe = _GatedPipeline(iter(frames), eng(), sink, present=None)
    pipe_ref[0] = pipe
    t = threading.Thread(target=pipe.run, daemon=True)
    t.start()
    _wait_paused(pipe, 1)
    pipe.quit()
    t.join(timeout=JOIN_S)
    assert not t.is_alive()
    # the frame held at the gate is the last one played
    assert pipe.frames_in == 2 and len(sink.pts) == 1 + 3


# --- shedding, display-rate adaptation -------------------------------------

class _AlwaysLateClock:
    """Present clock whose feedback always reports a late frame."""

    untimed = False
    display_fps = 60.0
    vsync_interval = 1.0 / 60.0

    def __init__(self):
        self.presented = 0

    def present(self, pts):
        self.presented += 1
        return PresentInfo(self.presented, 1, 0.0, 0.005, False)

    def reset(self):
        pass

    def estimated_display_fps(self):
        return self.display_fps

    def vsync_jitter(self):
        return 0.0


def test_late_sources_are_shed(small_cfg):
    frames = list(synthetic.moving_box(small_cfg, 16))
    sink = _PtsSink()
    pipe = Pipeline(iter(frames), eng(), sink, present=_AlwaysLateClock(),
                    adapt_display_rate=False)
    pipe.run()
    assert pipe.sources_dropped >= 1
    assert pipe.frames_out > pipe.frames_in - pipe.sources_dropped
    assert (np.diff(sink.pts) > 0).all()


class FakeTime:
    """perf_counter/sleep pair where sleep is exact (zero jitter)."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def sleep(self, d):
        self.t += max(d, 0.0)


def test_display_rate_retargets_to_the_measured_refresh(small_cfg):
    frames = list(synthetic.moving_box(small_cfg, 60))
    engine = eng()
    pc = PresentClock(60.0, actual_fps=59.94, clock=FakeTime())
    pipe = Pipeline(iter(frames), engine, _PtsSink(), present=pc)
    pipe.drop_late_sources = False
    pipe.run()
    assert pc.presented >= 128
    assert pc.estimated_display_fps() == pytest.approx(59.94, rel=1e-6)
    assert pc.vsync_jitter() == pytest.approx(0.0, abs=1e-9)
    assert engine.cadence.target_frame_time == pytest.approx(1.0 / 59.94,
                                                             rel=1e-3)


# --- fail-open, staged uploads ---------------------------------------------

class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("group", [1, 4])
def test_fail_open_is_counted(small_cfg, group):
    """An engine failure passes every later source frame through, logs
    its traceback and counts one engine_failure; fail-closed raises."""
    frames = list(synthetic.moving_box(small_cfg, 10))
    engine = eng()
    calls = [0]
    push = engine.push_many if group > 1 else engine.push

    def failing(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            raise _Boom("injected")
        return push(*a, **kw)

    setattr(engine, "push_many" if group > 1 else "push", failing)
    sink = _PtsSink()
    pipe = Pipeline(iter(frames), engine, sink, present=None, group=group)
    pipe.run()
    assert pipe.engine_failed and pipe.engine_failures() == 1
    assert engine.stats.count("engine_failures") == 1
    assert pipe.frames_in == 10
    assert sink.pts[-1] == pytest.approx(9 / 24.0)
    engine = eng()
    setattr(engine, "push_many" if group > 1 else "push", failing)
    calls[0] = 1
    with pytest.raises(_Boom):
        Pipeline(iter(frames), engine, _PtsSink(), present=None,
                 group=group, fail_open=False).run()


def test_staged_pipeline_equals_unstaged():
    data = small_y4m(9, w=64, h=48).getvalue()
    got = []
    for staged in (False, True):
        frames = []

        class Sink(_PtsSink):
            def write(self, out):
                f = out.to_video_frame()
                frames.append((out.pts, np.array(f.y), np.array(f.uv)))

        pool = PinnedPool(8, device="cpu")
        pipe = Pipeline(Y4MReader(io.BytesIO(data), pool=pool),
                        eng(scene_detection=True), Sink(), present=None,
                        stage_uploads=staged)
        pipe.run()
        got.append(frames)
        # the staged path hands every frame's buffers back for reuse;
        # the engine's own upload leaves them to the caller
        assert (pool.stats()["hits"] > 0) == staged
    assert len(got[0]) == len(got[1]) == 1 + 3 + 2 + 3 + 2 + 3 + 2 + 3 + 2
    for (p1, y1, uv1), (p2, y2, uv2) in zip(*got):
        assert p1 == p2
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(uv1, uv2)
