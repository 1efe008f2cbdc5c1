"""Device profiling hooks of the port (counterpart of the JAX package's
``utils/trace.py``, which captures ``jax.profiler`` traces).

* ``device_trace(log_dir)``: a ``torch.profiler`` capture of everything
  inside the block -- host ops and, on a card, every CUDA kernel, memset
  and copy with its device time -- written to ``log_dir/trace.json``
  (the Chrome trace format; chrome://tracing or Perfetto read it).  This
  is the CLI's ``--profile-dir``;
* ``annotate(name)``: a named span on the host in such a trace, on
  the profiler's clock beside the device rows.  The engine and its kernel
  wrappers open the spans of ``SPANS`` with it.  While no profiler
  records, it returns one shared object that does nothing, so a span
  costs the engine a check of the profiler's state and no more.

The spans (a main-path ``push`` pair on the card opens 7, a ``push_many``
call of one group 5):

* ``mfi.push`` / ``mfi.push_many``: all of ``InterpolationEngine.push`` /
  ``push_many``;
* ``mfi.engine.wait``: the host waiting on the card for the pair (or
  group) before, from its end event's synchronize to its cut score's
  read-back (``_collect_timing``);
* ``mfi.pair``: the pair body (``_pair_outputs``, or ``push``'s launch
  plan, ``pipeline/push_plan.PushPlan.run``);
* ``mfi.c1``, ``mfi.k1``, ``mfi.k2``, ``mfi.k4``, ``mfi.q1``: the card
  path of the wrappers of C1 (``prologue.pair_prologue``), K1
  (``flow_step``'s launch), K2 (``warp_pair.pair_blend``), K4
  (``warp_fused.fused_blend``) and Q1 (``warp_bilinear.bilinear_blend``);
  each holds ``mfi.<k>.alloc``, its output allocations, so the span less
  that child is the card path's checks and its launch.  On ``push``'s
  launch plan, ``mfi.c1``, ``mfi.k1`` and ``mfi.k2`` hold the plan's
  launches and ``mfi.k2.alloc`` K2's outputs; ``mfi.c1.alloc`` and
  ``mfi.k1.alloc`` do not open there (the plan allocates those
  intermediates once per key);
* ``mfi.group.fill``, ``mfi.group.replay``, ``mfi.group.copy_out``: a
  group's slot fills, its graph's replay, its copies out;
  ``mfi.group.capture``: a group graph's warm-up and capture (set-up).

The spans of one push, or of one group, are those that nest inside its
``mfi.push`` or ``mfi.push_many`` on the engine's thread.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("trace")

TRACE_FILE = "trace.json"

SPANS = ("mfi.push", "mfi.push_many", "mfi.engine.wait", "mfi.pair",
         "mfi.c1", "mfi.c1.alloc", "mfi.k1", "mfi.k1.alloc", "mfi.k2",
         "mfi.k2.alloc", "mfi.k4", "mfi.k4.alloc", "mfi.q1", "mfi.q1.alloc",
         "mfi.group.fill", "mfi.group.replay", "mfi.group.copy_out",
         "mfi.group.capture")

_profiler_enabled = torch._C._autograd._profiler_enabled


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


class _Off:
    """The span of ``annotate`` while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return False


_OFF = _Off()


def annotate(name: str):
    """A span named `name` in the trace of the profiler that records on
    this thread; while none records, the shared ``_OFF``.

    The span is a host op of the profiler's (``_RecordFunctionFast``), not
    ``record_function``: that one also costs ~11 us a span with no
    profiler on an H100's host, and under CUDA activity it adds a copy of
    itself to the device rows (a ``gpu_user_annotation`` from its first
    kernel's start to its last one's end), which readers of the trace
    would count as device work."""
    if not _profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
