"""StreamFarm: per-stream asynchronous dispatch for serving many videos
at once (counterpart of the JAX package's ``parallel/farm.py``).

``MultiStreamEngine`` (parallel/streams.py) advances every stream in
lockstep.  A real transcode or serving farm is not lockstep: streams
arrive at different rates, stall independently and differ in geometry.
StreamFarm models that: each stream is a full InterpolationEngine driven
by its own worker thread with a bounded input queue, all on one card, and
on a card each worker runs its engine on a ``torch.cuda.Stream`` of its
own, entered once in its thread (the current stream, and a graph
capture, are per thread).  A worker spends its time enqueuing work and
waiting on the card, both of which release the interpreter lock, so
while one stream waits the others enqueue, and the card's streams run
their kernels concurrently where they fit.

  * independent rates: a stalled or slow source never gates another
    stream's submissions;
  * per-stream formats: each engine owns its geometry, so one farm mixes
    4K NV12 and 1080p P010;
  * bounded memory: each input queue applies backpressure to its own
    producer.

Per-stream behaviour (quality controller, scene state, stats, TooSlow
degradation) is InterpolationEngine's.  Each output records an event on
its worker's stream, and ``OutputFrame.block`` / ``to_video_frame`` wait
for it, so a consumer on any thread reads finished planes.

    farm = StreamFarm(EngineConfig(...), n_streams=4)
    farm.submit(0, frame)            # enqueue; blocks only if stream 0
                                     # is backlogged (queue_depth deep)
    for out in farm.get(0):          # FIFO results for stream 0
        ...
    farm.close()                     # flush + join workers
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Dict, List, Optional, Sequence

import torch

from mpv_frame_interpolator_tpu_torch.frame import VideoFrame
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine, OutputFrame)
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("farm")

_STOP = object()


class StreamWorkerError(RuntimeError):
    """An exception raised inside a stream's worker thread, re-raised to
    the caller on the next get()/submit() for that stream."""

    def __init__(self, stream_id: int, cause: BaseException):
        super().__init__(f"stream {stream_id} worker failed: {cause!r}")
        self.stream_id = stream_id
        self.cause = cause


class _Stream:
    """One stream: engine, CUDA stream, worker thread, bounded in/out
    queues."""

    def __init__(self, sid: int, config: EngineConfig, queue_depth: int):
        self.sid = sid
        self.engine = InterpolationEngine(config)
        dev = self.engine.device
        self.cuda_stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                            else None)
        self.inq: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self.outq: "queue.Queue" = queue.Queue()
        self.submitted = 0
        self.delivered = 0          # result batches handed to the caller
        self.error: Optional[StreamWorkerError] = None
        self.thread = threading.Thread(
            target=self._work, name=f"mfi-stream-{sid}", daemon=True)
        self.thread.start()

    def _work(self):
        with (torch.cuda.stream(self.cuda_stream)
              if self.cuda_stream is not None
              else contextlib.nullcontext()):
            while True:
                item = self.inq.get()
                if item is _STOP:
                    self.outq.put(_STOP)
                    return
                try:
                    self.outq.put(self.engine.push(item))
                except BaseException as e:   # handed to the consumer
                    self.error = StreamWorkerError(self.sid, e)
                    self.outq.put(self.error)
                    return


class StreamFarm:
    def __init__(self, config: Optional[EngineConfig] = None,
                 n_streams: int = 2, queue_depth: int = 4,
                 configs: Optional[Sequence[EngineConfig]] = None):
        """`configs` optionally gives each stream its own EngineConfig
        (e.g. different display_fps per client); otherwise all streams
        share `config`."""
        base = config or EngineConfig()
        if configs is not None:
            if len(configs) != n_streams:
                raise ValueError("configs must have n_streams entries")
        else:
            configs = [base] * n_streams
        self.n = n_streams
        self._streams = [_Stream(sid, c, queue_depth)
                         for sid, c in enumerate(configs)]
        self._closed = False

    # ------------------------------------------------------------------ #

    @property
    def engines(self) -> List[InterpolationEngine]:
        return [s.engine for s in self._streams]

    def stats(self, sid: int):
        return self._streams[sid].engine.stats

    def pending(self, sid: int) -> int:
        """Source frames submitted but whose results were not yet taken."""
        s = self._streams[sid]
        return s.submitted - s.delivered

    # ------------------------------------------------------------------ #

    def submit(self, sid: int, frame: VideoFrame,
               timeout: Optional[float] = None):
        """Enqueue one source frame for stream `sid`.  Blocks only when
        that stream's queue is full (per-stream backpressure); other
        streams are unaffected.  Raises queue.Full on timeout."""
        if self._closed:
            raise RuntimeError("farm is closed")
        s = self._streams[sid]
        if s.error is not None:
            raise s.error
        s.inq.put(frame, timeout=timeout)
        s.submitted += 1

    def get(self, sid: int, timeout: Optional[float] = None
            ) -> List[OutputFrame]:
        """The output frames of the next completed source frame of stream
        `sid`, in submission order.  Blocks until one is ready; raises
        queue.Empty on timeout, StreamWorkerError if the worker died."""
        s = self._streams[sid]
        if s.submitted == s.delivered:
            if s.error is not None:
                raise s.error
            raise queue.Empty(f"stream {sid}: no pending submissions")
        item = s.outq.get(timeout=timeout)
        if isinstance(item, StreamWorkerError):
            raise item
        s.delivered += 1
        return item

    def try_get(self, sid: int) -> Optional[List[OutputFrame]]:
        """Non-blocking get: None when no result is ready."""
        s = self._streams[sid]
        if s.submitted == s.delivered:
            if s.error is not None:
                raise s.error
            return None
        try:
            item = s.outq.get_nowait()
        except queue.Empty:
            return None
        if isinstance(item, StreamWorkerError):
            raise item
        s.delivered += 1
        return item

    def drain(self, sid: int, timeout: Optional[float] = None
              ) -> List[List[OutputFrame]]:
        """Wait for and return ALL outstanding results of stream `sid`."""
        out = []
        while self.pending(sid):
            out.append(self.get(sid, timeout=timeout))
        return out

    def drain_all(self, timeout: Optional[float] = None
                  ) -> Dict[int, List[List[OutputFrame]]]:
        return {sid: self.drain(sid, timeout=timeout)
                for sid in range(self.n)}

    def close(self, timeout: float = 60.0):
        """Stop accepting input, join the workers.  Outstanding results
        remain fetchable with get()/drain() after close."""
        if self._closed:
            return
        self._closed = True
        for s in self._streams:
            if s.error is None:
                s.inq.put(_STOP)
        for s in self._streams:
            s.thread.join(timeout=timeout)
            if s.thread.is_alive():
                log.warning("stream %d worker did not stop in %.0fs",
                            s.sid, timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
