"""Device profiling hooks of the port (counterpart of the JAX package's
``utils/trace.py``, which captures ``jax.profiler`` traces).

* ``device_trace(log_dir)``: a ``torch.profiler`` capture of everything
  inside the block -- host ops and, on a card, every CUDA kernel, memset
  and copy with its device time -- written to ``log_dir/trace.json``
  (the Chrome trace format; chrome://tracing or Perfetto read it).  This
  is the CLI's ``--profile-dir``;
* ``annotate(name)``: a named region in such a trace
  (``record_function``);
* ``timed_block``: (result, seconds) of one call, with the streams of the
  CUDA tensors it returns synchronised before the clock stops.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("trace")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of everything inside the block into
    ``log_dir/trace.json`` (the CUDA activity too where a card is
    present)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter()
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        log.info("device trace (%.2fs) written to %s",
                 time.perf_counter() - t0, path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in profiler traces."""
    with record_function(name):
        yield


def _cuda_devices(out, found: set):
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (list, tuple)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


def timed_block(fn, *args, sync=True):
    """(result, seconds) of ``fn(*args)``; with `sync`, the current stream
    of each card the returned tensors live on is synchronised before the
    clock stops (PyTorch returns before the card is done)."""
    t0 = time.perf_counter()
    out = fn(*args)
    if sync:
        for dev in _cuda_devices(out, set()):
            torch.cuda.current_stream(dev).synchronize()
    return out, time.perf_counter() - t0
