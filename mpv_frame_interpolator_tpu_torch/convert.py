"""What carries across from the JAX package to the port.

The system has no learned weights: what carries across is the engine
configuration and the frames.  ``engine_config_from_jax`` takes
``dataclasses.asdict`` of a JAX ``EngineConfig`` (so the port never imports
it) and returns the port's config; ``frame_to_device`` turns a host
``VideoFrame``'s numpy planes into tensors on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from mpv_frame_interpolator_tpu_torch.frame import FrameFormat, VideoFrame

# Knobs that only pick a TPU/XLA mechanism: which Pallas kernel runs the
# flow step or the blur, how the warp batch is looped, which layer counts
# are compiled, how compiles are cached and warmed, and how a relay's
# dispatch acknowledgements are timed.  None changes an output; on the
# port they are accepted with any value and ignored.  (`warp_sampling` is
# not among them: it picks a kernel of the port as well, and the port's
# EngineConfig validates it.)
NO_OP_KNOBS = ("flow_kernel", "pallas_blur", "warp_loop",
               "layer_buckets", "batch_shapes", "precompile",
               "background_precompile", "compilation_cache_dir",
               "timing_source", "timing_sync_period")

# Mechanisms the port's slice leaves out (ROADMAP.md lists them).  They
# are accepted at the JAX default, under which the slice runs without
# them; any other value raises NotImplementedError.
OMITTED_AT_DEFAULT = {
    "split_timing": "auto",
    "degrade_rungs": ((2, 2, None), (3, 4, None), (3, 4, "blend")),
    "subpel_flow": False,
    "stats_log_path": "",
}


def engine_config_from_jax(mapping: dict, device: str = "cuda"):
    """The port's EngineConfig, running on `device`, from
    ``dataclasses.asdict(jax_config)``.

    Fields both configs have are copied (the port's own validation then
    raises NotImplementedError for a mode, model or sampler it does not
    cover); TPU mechanism knobs are dropped; omitted mechanisms must sit
    at their JAX default.  An unknown key raises KeyError."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import EngineConfig
    fields = {f.name for f in dataclasses.fields(EngineConfig)} - {"device"}
    kwargs = {"device": device}
    for key, value in mapping.items():
        if key in fields:
            kwargs[key] = value
        elif key in OMITTED_AT_DEFAULT:
            default = OMITTED_AT_DEFAULT[key]
            if key == "degrade_rungs":
                value = tuple(tuple(r) + (None,) * (3 - len(r))
                              for r in value)
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
    once per frame."""

    y: torch.Tensor
    uv: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    fmt: FrameFormat
    pts: float = 0.0
    nominal_fps: float = 0.0


def frame_to_device(frame: VideoFrame, device) -> DeviceFrame:
    """Copy a host frame's numpy planes to `device` as they are (uint8
    stays uint8, P010's uint16 stays uint16) and split its chroma there.  The host buffers are handed back to
    their pool (``frame.recycle``) once copied."""
    device = torch.device(device)
    y = torch.from_numpy(np.ascontiguousarray(frame.y)).to(device, copy=True)
    uv = torch.from_numpy(np.ascontiguousarray(frame.uv)).to(device,
                                                             copy=True)
    recycle: Optional[Callable[[], None]] = frame.recycle
    if recycle is not None:
        recycle()
    return DeviceFrame(y, uv, uv[:, 0::2].contiguous(),
                       uv[:, 1::2].contiguous(), frame.fmt, frame.pts,
                       frame.nominal_fps)
