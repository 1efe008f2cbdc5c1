"""Pipeline orchestrator of the port: source -> prefetch -> engine ->
present -> sink (counterpart of the JAX package's
``pipeline/player.Pipeline``, the reference's playloop,
player/playloop.c:1251).

* a reader thread and a bounded queue (``_Prefetcher``) stand in for the
  demux thread and its packet cache (demux/demux.c:2549,1187): with
  ``stage_uploads`` the reader thread also uploads each frame
  (``engine.stage``: a non-blocking copy on the engine's copy stream from
  a page-locked buffer), so reading and uploading overlap the card's
  work on earlier pairs;
* the engine enqueues its device work without a host sync; the sink's
  download is the one sync an output (the reference's blocking
  downloadFrame, opticalFlowCalc.c:109-124);
* commands (speed, seek, pause, frame-step, quit) are applied between
  source frames, like mp_output_chain_command routing into the filter
  (vf_HopperRender.c:541-555); ``loop`` and ``end_pts`` are --loop-file
  and --end;
* ``group`` > 1 is the encode path: frames go to ``engine.push_many`` a
  group at a time (one CUDA graph replay a group on the card);
* ``fail_open``: an engine failure passes the source frames through from
  then on (filters/filter.h:359-362, a dead filter drops out of the
  chain), and is counted in the engine's stats as ``engine_failures``
  with its traceback logged -- never hidden, and never a fall back to the
  plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Optional

from mpv_frame_interpolator_tpu_torch.frame import VideoFrame
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    InterpolationEngine, OutputFrame)
from mpv_frame_interpolator_tpu_torch.pipeline.present import PresentClock
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("player")

_EOF = object()


def _recycle(frame):
    """Hand an unconsumed frame's pooled host buffers back (a staged frame
    has none left)."""
    recycle = getattr(frame, "recycle", None)
    if recycle is not None:
        recycle()


class _Prefetcher:
    """Reader thread + bounded frame queue (demux-thread analog).

    With a `stage` callable (engine.stage) each frame is uploaded from
    this thread, so its copies overlap both reading and compute.
    `last_wait`: how long the consumer last waited for a frame;
    `read_time`: the reader's seconds in the source and in `stage`."""

    def __init__(self, source: Iterable[VideoFrame], depth: int = 4,
                 stage=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stage = stage
        self._stop = threading.Event()
        self.stopped = False
        self.last_wait = 0.0
        self.read_time = 0.0
        self.stage_time = 0.0
        self._thread = threading.Thread(target=self._run, args=(source,),
                                        daemon=True)
        self._thread.start()

    def _run(self, source):
        try:
            it = iter(source)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                frame = next(it, _EOF)
                t1 = time.perf_counter()
                self.read_time += t1 - t0
                if frame is _EOF:
                    break
                if self._stage is not None:
                    frame = self._stage(frame)
                    self.stage_time += time.perf_counter() - t1
                self._q.put(frame)
        except Exception as e:   # surface read errors at the consumer
            self._q.put(e)
        finally:
            self._q.put(_EOF)

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            self.last_wait = time.perf_counter() - t0
            if item is _EOF:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def stop(self, timeout: float = 60.0):
        """Stop and join the reader thread (it must not touch the source
        file handle after this returns: a queued seek repositions it).
        Raises if the thread is still alive after `timeout` seconds."""
        self.stopped = True
        self._stop.set()
        deadline = time.monotonic() + timeout
        while True:
            alive = self._thread.is_alive()
            self._drain()
            if not alive:
                return
            self._thread.join(timeout=0.05)
            if time.monotonic() > deadline:
                raise RuntimeError("the prefetch thread did not stop")

    def _drain(self):
        """Hand back the buffers of frames that never reached the
        engine."""
        try:
            while True:
                item = self._q.get_nowait()
                if item is not _EOF and not isinstance(item, Exception):
                    _recycle(item)
        except queue.Empty:
            pass


class Pipeline:
    def __init__(self, source: Iterable[VideoFrame],
                 engine: InterpolationEngine, sink,
                 present: Optional[PresentClock] = None,
                 prefetch: int = 4, stage_uploads: bool = True,
                 fail_open: bool = True, adapt_display_rate: bool = True,
                 group: int = 1):
        self.source = source
        self.engine = engine
        self.sink = sink
        self.present = present
        self.prefetch = prefetch
        self.stage_uploads = stage_uploads
        # pair-grouped dispatch for the encode path (engine.push_many):
        # adds up to `group` source intervals of latency, so pause, seek,
        # late-frame shedding and pacing are not available there
        self.group = max(int(group), 1)
        # filter-failure semantics (filters/filter.h:359-362 +
        # vf_HopperRender.c ERR_CHECK): a failed engine drops out of the
        # chain and playback continues with source frames passed through
        self.fail_open = fail_open
        self.engine_failed = False
        # display-sync adaptation (vo.c:416 check_estimated_display_fps
        # analog): retarget the cadence to the measured refresh when the
        # presentation feedback shows a stable, nearby estimate
        self.adapt_display_rate = adapt_display_rate
        # decoder-level framedrop (check_framedrop analog,
        # player/video.c:315-332): sustained late presents shed whole
        # source frames; the cadence re-anchors over the pts gap
        self.drop_late_sources = True
        self.sources_dropped = 0
        self._late_streak = 0
        # source underruns (player/video.c:1078-1088 analog): frames the
        # reader could not deliver within a source interval
        self.underruns = 0
        self.frames_in = 0
        self.frames_out = 0
        # the most recent output that reached the sink
        self.last_output = None
        self.seeks = 0
        self._pending_seek: Optional[float] = None
        self._commands: "queue.Queue" = queue.Queue()
        # pause state: cleared = paused.  frame-step = unpause for exactly
        # one source frame's outputs (player/command.c frame-step)
        self._unpaused = threading.Event()
        self._unpaused.set()
        self._step_frames = 0
        self._quit = False
        self.paused = False
        # --loop-file / --end analogs: loop counts additional plays (-1 =
        # forever); end_pts stops playback at a source timestamp
        self.loop = 0
        self.end_pts: Optional[float] = None
        self._eof_stop = False
        # the reader's seconds in the source and in uploads, summed over
        # segments (the CLI's wall split)
        self.read_time = 0.0
        self.stage_time = 0.0
        # the consumer's seconds in engine.push / push_many
        self.engine_time = 0.0

    # -- runtime command surface (mp_filter_command analog) --------------

    def set_speed(self, speed: float):
        self._commands.put(("speed", speed))

    def seek_reset(self):
        self._commands.put(("reset", None))

    def seek(self, pts: float):
        """Queue a source-side seek (execute_queued_seek analog,
        player/playloop.c:1294): flush the prefetcher, reposition the
        source, reset the engine and the present clock.  Needs a seekable
        source (io/y4m.py readers); otherwise degrades to seek_reset."""
        self._commands.put(("seek", float(pts)))

    def set_pause(self, paused: bool):
        """mpv `pause` property: halt consumption between source frames;
        the present clock re-anchors on resume so the vblank grid does
        not accumulate the paused wall time."""
        self.paused = bool(paused)
        if paused:
            self._unpaused.clear()
        else:
            self._commands.put(("resync-present", None))
            self._unpaused.set()

    def quit(self):
        """Stop playback at the next frame boundary (mpv quit command);
        safe from any thread."""
        self._quit = True
        self._unpaused.set()

    def frame_step(self):
        """mpv `frame-step`: while paused, advance by one source frame's
        outputs, then stay paused."""
        self._step_frames += 1
        self._unpaused.set()

    def source_seekable(self) -> bool:
        s = self.source
        return hasattr(s, "seek_pts") and getattr(s, "seekable",
                                                  lambda: False)()

    def engine_failures(self) -> int:
        return self.engine.stats.count("engine_failures")

    def _engine_failed(self, what: str):
        """Fail-open: log the traceback, count the failure, pass frames
        through from now on."""
        log.exception("%s failed; passing source frames through "
                      "(filter-failure semantics)", what)
        self.engine.stats.add("engine_failures", 1.0)
        self.engine_failed = True

    def _apply_commands(self):
        try:
            while True:
                cmd, arg = self._commands.get_nowait()
                if cmd == "speed":
                    self.engine.set_speed(arg)
                elif cmd == "reset":
                    self.engine.reset()
                    if self.present:
                        self.present.reset()
                elif cmd == "resync-present":
                    if self.present:
                        self.present.reset()
                elif cmd == "seek":
                    if self.source_seekable():
                        self._pending_seek = arg
                    else:
                        log.warning("seek requested on an unseekable "
                                    "source; resetting filter state only")
                        self.engine.reset()
                        if self.present:
                            self.present.reset()
        except queue.Empty:
            pass

    def _maybe_adapt_display_rate(self):
        """Retarget the cadence to the measured refresh rate once the
        estimate is stable and plausibly the same mode (within 5% of the
        nominal; vo.c:416-450).  Untimed runs never adapt."""
        pc = self.present
        if not self.adapt_display_rate or pc.untimed or pc.presented < 128:
            return
        est = pc.estimated_display_fps()
        nominal = pc.display_fps
        if est <= 0 or abs(est - nominal) / nominal > 0.05:
            return
        if pc.vsync_jitter() > 0.2 * pc.vsync_interval:
            return
        new_tft = 1.0 / est
        if abs(new_tft - self.engine.cadence.target_frame_time) > 1e-9:
            log.info("display-sync: retargeting cadence to measured "
                     "%.4f Hz (nominal %.4f)", est, nominal)
            self.engine.cadence.target_frame_time = new_tft

    def _execute_seek(self, pts: float):
        """Reposition the source and reset downstream state (demux_seek +
        reset_video_state + the filter's own seek reset, player/video.c:98
        + vf_HopperRender.c:562-567)."""
        actual = self.source.seek_pts(pts)
        self.engine.reset()
        if self.present:
            self.present.reset()
        self.seeks += 1
        log.info("seeked to %.3fs (requested %.3fs)", actual, pts)

    def run(self, max_source_frames: Optional[int] = None) -> int:
        """Play until EOF (and the loops), `end_pts`, quit or
        `max_source_frames`; returns the frames written."""
        try:
            while True:
                restart = self._run_segment(max_source_frames)
                if restart:
                    continue
                if (self.loop != 0 and not self._eof_stop
                        and self.source_seekable()
                        and not (max_source_frames
                                 and self.frames_in >= max_source_frames)):
                    if self.loop > 0:
                        self.loop -= 1
                    log.info("looping (remaining: %s)",
                             "inf" if self.loop < 0 else self.loop)
                    self._execute_seek(0.0)
                    continue
                break
            self.engine.flush()
        finally:
            self.sink.close()
        return self.frames_out

    def _reader(self) -> _Prefetcher:
        return _Prefetcher(self.source, self.prefetch,
                           stage=self.engine.stage if self.stage_uploads
                           else None)

    def _stop_reader(self, reader: _Prefetcher):
        if reader.stopped:
            return
        reader.stop()
        self.read_time += reader.read_time
        self.stage_time += reader.stage_time

    def _write(self, out: OutputFrame):
        self.sink.write(out)
        self.last_output = out
        self.frames_out += 1

    def _at_end(self, frame) -> bool:
        """Quit or --end: stop before `frame` (its buffers go back)."""
        if self._quit or (self.end_pts is not None
                          and frame.pts > self.end_pts):
            self._eof_stop = True
            _recycle(frame)
            return True
        return False

    def _run_segment_grouped(self, max_source_frames: Optional[int]) -> bool:
        """Encode path (self.group > 1): buffer source frames and dispatch
        them pair-grouped through engine.push_many -- the same outputs as
        push().  Pause, seek, late-frame shedding and display-rate
        adaptation need per-frame pacing and are not available here; quit
        and --end are honoured at frame boundaries.  No present pacing
        (grouped mode implies untimed)."""
        self._eof_stop = False
        reader = self._reader()

        def flush(buf):
            if not buf:
                return
            t0 = time.perf_counter()
            try:
                outs = self.engine.push_many(buf, group_size=self.group)
            except Exception:
                if not self.fail_open:
                    raise
                self._engine_failed("grouped engine dispatch")
                outs = [OutputFrame(f.pts, f.fmt, f.y, f.uv) for f in buf]
            self.engine_time += time.perf_counter() - t0
            del buf[:]
            for out in outs:
                self._write(out)

        buf: list = []
        try:
            for frame in reader:
                if self._at_end(frame):
                    break
                self._apply_commands()
                self.frames_in += 1
                if self.engine_failed:
                    self._write(OutputFrame(frame.pts, frame.fmt, frame.y,
                                            frame.uv))
                    continue
                buf.append(frame)
                if len(buf) >= self.group:
                    flush(buf)
                if max_source_frames and self.frames_in >= max_source_frames:
                    self._eof_stop = True
                    break
            flush(buf)
        finally:
            self._stop_reader(reader)
        return False

    def _run_segment(self, max_source_frames: Optional[int]) -> bool:
        """Play until EOF, frame budget, or a queued seek.  Returns True if
        a seek was executed and playback should restart from the new
        position."""
        if self.group > 1:
            return self._run_segment_grouped(max_source_frames)
        self._eof_stop = False
        reader = self._reader()
        try:
            for frame in reader:
                if self._at_end(frame):
                    break
                if (self.present is not None and not self.present.untimed
                        and reader.last_wait
                        > self.engine.cadence.source_frame_time):
                    self.underruns += 1
                    if self.underruns % 32 == 1:
                        log.warning("source underrun: the reader is %.1f "
                                    "ms behind the source cadence",
                                    reader.last_wait * 1e3)
                # pause gate (commands and queued seeks stay live)
                while not self._unpaused.is_set():
                    self._unpaused.wait(0.05)
                    self._apply_commands()
                    if self._pending_seek is not None or self._quit:
                        break
                self._apply_commands()
                if self._pending_seek is not None:
                    pts = self._pending_seek
                    self._pending_seek = None
                    _recycle(frame)
                    self._stop_reader(reader)
                    self._execute_seek(pts)
                    return True
                if (self.drop_late_sources and self._late_streak >= 8
                        and self.present is not None
                        and not self.present.untimed):
                    # shedding one source frame relieves ~numIntFrames of
                    # device and present work; the pts gap re-anchors
                    self.sources_dropped += 1
                    self._late_streak = 0
                    self.frames_in += 1
                    _recycle(frame)
                    continue
                if self.engine_failed:
                    outs = [OutputFrame(frame.pts, frame.fmt, frame.y,
                                        frame.uv)]
                else:
                    t0 = time.perf_counter()
                    try:
                        outs = self.engine.push(frame)
                    except Exception:
                        if not self.fail_open:
                            raise
                        self._engine_failed("interpolation engine")
                        outs = [OutputFrame(frame.pts, frame.fmt, frame.y,
                                            frame.uv)]
                    self.engine_time += time.perf_counter() - t0
                self.frames_in += 1
                for out in outs:
                    if self.present is not None:
                        info = self.present.present(out.pts)
                        if info.late_by > 0:
                            self._late_streak += 1
                        else:
                            self._late_streak = 0
                        if info.dropped:
                            continue
                    self._write(out)
                if self.present is not None:
                    self._maybe_adapt_display_rate()
                if self._step_frames > 0:
                    self._step_frames -= 1
                    if self._step_frames == 0 and self.paused:
                        self._unpaused.clear()
                if max_source_frames and self.frames_in >= max_source_frames:
                    break
        finally:
            self._stop_reader(reader)
        return False
