"""What carries across from the JAX package to the port.

The system has no learned weights: what carries across is the engine
configuration and the frames.  ``engine_config_from_jax`` takes
``dataclasses.asdict`` of a JAX ``EngineConfig`` (so the port never imports
it) and returns the port's config; ``frame_to_device`` turns a host
``VideoFrame``'s numpy planes into tensors on a device (on a card, copies
that do not block the host, with an event the compute stream waits on).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from mpv_frame_interpolator_tpu_torch.frame import FrameFormat, VideoFrame

# Knobs that only pick a TPU/XLA mechanism: which Pallas kernel runs the
# flow step or the blur, how the warp batch is looped, how the batch
# shapes are padded and how compiles are cached and warmed (the port
# compiles nothing per shape, batch size or rung: its kernel library
# builds once, at first use, so `batch_shapes` and the background warm-up
# have nothing to do), and how a relay's dispatch acknowledgements are
# timed.  None changes an output; on the port they are accepted with any
# value and ignored.  (`warp_sampling` is not among them: it picks a
# kernel of the port as well, and the port's EngineConfig validates it;
# nor is `layer_buckets`, which picks the flow kernel's instantiation.)
NO_OP_KNOBS = ("flow_kernel", "pallas_blur", "warp_loop", "batch_shapes",
               "precompile", "background_precompile",
               "compilation_cache_dir", "timing_source",
               "timing_sync_period")

# Mechanisms the port leaves out, each with its JAX default: accepted at
# that default, under which the port runs without them; any other value
# raises NotImplementedError.  None is left out since the stats log
# (`stats_log_path`) became a field of the port's config.
OMITTED_AT_DEFAULT: dict = {}


def engine_config_from_jax(mapping: dict, device: str = "cuda"):
    """The port's EngineConfig, running on `device`, from
    ``dataclasses.asdict(jax_config)``.

    Fields both configs have are copied, ``frame_output_mode``,
    ``model``, ``warp_sampling``, ``layer_buckets``, ``degrade_rungs``,
    ``split_timing``, ``subpel_flow`` and ``stats_log_path`` among them:
    modes 0-6, every model family, sampler, radius, ladder, timing mode
    and stats log convert; TPU mechanism knobs are dropped; omitted
    mechanisms must sit at their JAX default.  An unknown key raises
    KeyError."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import EngineConfig
    fields = {f.name for f in dataclasses.fields(EngineConfig)} - {"device"}
    kwargs = {"device": device}
    for key, value in mapping.items():
        if key in fields:
            kwargs[key] = value
        elif key in OMITTED_AT_DEFAULT:
            default = OMITTED_AT_DEFAULT[key]
            if value != default:
                raise NotImplementedError(
                    f"{key}={value!r} is not covered by the port "
                    f"(only the default {default!r} is)")
        elif key not in NO_OP_KNOBS:
            raise KeyError(f"unknown EngineConfig field {key!r}")
    return EngineConfig(**kwargs)


@dataclasses.dataclass
class DeviceFrame:
    """A source frame whose planes live on a device: luma (H, stride) and
    interleaved chroma (H/2, stride) as uploaded (uint8 NV12 or uint16
    P010), plus the planar chroma (H/2, stride/2) the flow reads, split
    once per frame.

    `ready`, on a card: the CUDA event recorded after the upload's copies
    and the split on the stream that made them; ``wait_on`` makes the
    stream that computes with the planes wait for it, before first use."""

    y: torch.Tensor
    uv: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    fmt: FrameFormat
    pts: float = 0.0
    nominal_fps: float = 0.0
    ready: Optional[torch.cuda.Event] = dataclasses.field(
        default=None, repr=False, compare=False)

    def wait_on(self, stream):
        """Order `stream` after the upload (a device-side wait: the host
        does not block) and tell the caching allocator that `stream` uses
        the planes, so their memory is not reused before its work on them
        is done.  Once per frame; a frame made on the CPU has nothing to
        wait for."""
        if self.ready is None:
            return
        stream.wait_event(self.ready)
        for t in (self.y, self.uv, self.u, self.v):
            t.record_stream(stream)
        self.ready = None


def frame_to_device(frame: VideoFrame, device, stream=None) -> DeviceFrame:
    """Copy a host frame's numpy planes to `device` as they are (uint8
    stays uint8, P010's uint16 stays uint16) and split its chroma there.

    On a card the copies and the split are enqueued on `stream` (default:
    the current stream) without blocking the host -- DMA from a
    page-locked buffer (``io/pinned.PinnedPool``), a staged copy from any
    other -- and an event recorded after them rides on the DeviceFrame
    (``ready``).  The host buffers are handed back to their pool
    (``frame.recycle``) only once that event has completed: the caller's
    thread waits for it then, and only then.  On the CPU the planes are
    copied and handed back at once."""
    device = torch.device(device)
    y = torch.from_numpy(np.ascontiguousarray(frame.y))
    uv = torch.from_numpy(np.ascontiguousarray(frame.uv))
    recycle: Optional[Callable[[], None]] = frame.recycle
    ready = None
    if device.type == "cuda":
        stream = stream or torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            y = y.to(device, non_blocking=True)
            uv = uv.to(device, non_blocking=True)
            u, v = uv[:, 0::2].contiguous(), uv[:, 1::2].contiguous()
            ready = torch.cuda.Event(enable_timing=True)
            ready.record(stream)
        if recycle is not None:
            ready.synchronize()
    else:
        y, uv = y.to(device, copy=True), uv.to(device, copy=True)
        u, v = uv[:, 0::2].contiguous(), uv[:, 1::2].contiguous()
    if recycle is not None:
        recycle()
    return DeviceFrame(y, uv, u, v, frame.fmt, frame.pts, frame.nominal_fps,
                       ready)
