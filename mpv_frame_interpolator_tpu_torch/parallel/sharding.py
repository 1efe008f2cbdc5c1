"""The interpolation step of one pair sharded over a ``torch.distributed``
process group (counterpart of the JAX package's ``parallel/sharding.py``,
whose ``shard_map`` over a device mesh a process group replaces).

* **Layer sharding (flow).**  A pyramid step evaluates `radius`
  independent candidate layers on one axis.  Rank d of D owns the layers
  [d R/D, (d+1) R/D) and runs K1's layer slice on them
  (``ops/cuda/flow_step.flow_layer_slice``): per window, the first
  minimum of its window sums in unsigned order and the global layer that
  reaches it, written straight into the tensor that one all_gather
  exchanges.  The next step's launch first commits the gathered pairs:
  each window takes the layer of the first rank that holds the unsigned
  minimum (the blocks of layers ascend with the rank, so that is the
  single-device first minimum, determineLowestLayerKernel.cl:13-18) and
  adds it to its own copy of the field, so every rank holds the same
  field for the next step's neighbour bias; a commit-only launch ends the
  pyramid.  A step is that one launch and the gather; the rank's field
  and its two sums buffers (a step's zero on entry, its launch zeroing
  the other for the next step) live for the pair, on its stream.  The
  blur then runs once, on the blur kernel (``ops/flow.blur_flow``).
* **Row sharding (warp).**  In mode 2 each rank runs K2's row band
  (``ops/cuda/warp_pair.pair_blend_rows``) on its rows of the output,
  reading the sources whole, and one all_gather assembles the frame.
  Other modes run the engine's warp stage for the whole frame on every
  rank and keep their band (the JAX package's ``row_sharded_warp_fn``
  takes any mode and leaves the split of work to GSPMD).

Collectives: on **nccl** the gathered tensors stay on the card, and each
rank needs a card of its own; on **gloo** every gathered tensor goes
through an explicit copy to the host and back, always.  The backend is
the process group's; a group on any other backend is refused, and there
is no switch from one backend to the other.

Frames are planar, as the JAX functions take them: y (H, stride), u and v
(H/2, stride/2), uint8 (NV12) or uint16 (P010, with a shift of 8), numpy
or tensors; they go to `device` ("cuda" unless the caller passes "cpu";
without a card that raises).  The outputs are the JAX functions': the
(2, lh, lw) int32 offset and its blur, and planar (y, u, v).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mpv_frame_interpolator_tpu_torch.convert import require_device
from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
from mpv_frame_interpolator_tpu_torch.ops import warp as warp_ops
from mpv_frame_interpolator_tpu_torch.ops.cuda.flow_step import (
    flow_layer_slice, pyramid_steps, slice_sums_words)
from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_pair import (
    band_rows, pair_blend_rows)
from mpv_frame_interpolator_tpu_torch.ops.flow import FlowGeometry


def make_group(ranks=None):
    """The process group of `ranks` (None: every rank of the default
    group, which ``torch.distributed.init_process_group`` made)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_process_group(backend, init_method, rank, "
                           "world_size) first")
    return dist.group.WORLD if ranks is None else dist.new_group(ranks)


def _group(group):
    return make_group() if group is None else group


def gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` (one shape on every rank) stacked in rank order,
    (world, *t.shape) on t's device: on nccl one all_gather_into_tensor on
    the card, on gloo through the host (the list form, one copy back)."""
    backend = dist.get_backend(group)
    world = dist.get_world_size(group)
    t = t.contiguous()
    if backend == "nccl":
        if not t.is_cuda:
            raise ValueError(f"nccl gathers CUDA tensors, got {t.device}")
        out = torch.empty((world, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    if backend == "gloo":
        host = t.cpu()
        out = torch.empty((world, *t.shape), dtype=t.dtype)
        dist.all_gather(list(out.unbind(0)), host, group=group)
        return out.to(t.device)
    raise ValueError(f"backend {backend!r}: the sharded step gathers over "
                     "nccl or gloo")


def _to(device, planes):
    return [p.to(device) if isinstance(p, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(p)).to(device)
            for p in planes]


def interleave(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Planar (u, v) -> the interleaved NV12/P010 chroma plane."""
    return torch.stack((u, v), dim=-1).reshape(u.shape[0], -1)


def sharded_flow(geom: FlowGeometry, radius: int, group=None,
                 luma_shift: int = 0, device="cuda"):
    """The flow with the candidate layers sharded over the group's ranks
    (`radius` divisible by the group's size).  Returns fn(f1y, f1u, f1v,
    f2y, f2u, f2v, ds=8, nbs=6) -> (offset, blurred), each (2, lh, lw)
    int32 on `device`, the same on every rank."""
    group = _group(group)
    world = dist.get_world_size(group)
    if radius % world:
        raise ValueError(f"radius {radius} does not split over {world} "
                         "ranks")
    n = radius // world
    z0 = dist.get_rank(group) * n
    dev = require_device(device)
    steps = pyramid_steps(geom.window_schedule(),
                          flow_ops.FIRST_NEIGHBOR_ITERATION)

    lh, lw = geom.low_h, geom.low_w
    words = slice_sums_words(lh, lw, n, geom.window_schedule())

    def flow(f1y, f1u, f1v, f2y, f2u, f2v, ds: int = 8, nbs: int = 6):
        f1y, f1u, f1v, f2y, f2u, f2v = _to(dev, (f1y, f1u, f1v, f2y, f2u,
                                                 f2v))
        planes = (f1y, f1u, f1v, *flow_ops.subsampled_f2(geom, f2y, f2u,
                                                         f2v))
        scalars = (radius, ds, nbs, geom.res_scalar, geom.height,
                   geom.stride, luma_shift)
        field = torch.zeros((2, lh, lw), dtype=torch.int32, device=dev)
        # K1's ping-pong sums: a step's buffer is zero, its launch zeroes
        # the other for the next step
        sums = (torch.zeros((2, words), dtype=torch.int32, device=dev)
                if dev.type == "cuda" else None)
        gathered = prev = None
        for k, (window, is_y, nb) in enumerate(steps):
            pairs = flow_layer_slice(
                *planes, field, gathered, prev, (window, is_y, nb), z0, n,
                *scalars, sums=None if sums is None else (sums[k & 1],
                                                          sums[~k & 1]))
            gathered = gather(pairs, group)
            prev = (window, is_y)
        flow_layer_slice(*planes, field, gathered, prev, None, z0, n,
                         *scalars)
        return field, flow_ops.blur_flow(field)

    return flow


def row_sharded_warp(geom: FlowGeometry, mode: int, group=None,
                     scale_shift: int = 0, device="cuda"):
    """The warp of one blend position with the output rows sharded over
    the group's ranks (``band_rows``: even edges, the last band takes the
    remainder).  Returns fn(f1y, f1u, f1v, f2y, f2u, f2v, blurred, t,
    black=0.0, white=255.0) -> planar (y, u, v) on `device`, the whole
    frame on every rank."""
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import _warp_stage
    group = _group(group)
    bands = band_rows(geom.height, dist.get_world_size(group))
    r0, r1 = bands[dist.get_rank(group)]
    rows = max(b - a for a, b in bands)
    wa = geom.actual_width
    dev = require_device(device)

    def warp(f1y, f1u, f1v, f2y, f2u, f2v, blurred, t, black=0.0,
             white=255.0):
        f1y, f1u, f1v, f2y, f2u, f2v, blurred = _to(
            dev, (f1y, f1u, f1v, f2y, f2u, f2v, blurred))
        f1uv, f2uv = interleave(f1u, f1v), interleave(f2u, f2v)
        levels = warp_ops.level_ints(float(black), float(white))
        ts = torch.tensor([float(t)], dtype=torch.float32, device=dev)
        planes = (f1y, f1uv, f2y, f2uv)
        if mode == warp_ops.BLENDED_FRAME:
            y, uv = pair_blend_rows(*planes, blurred, ts, geom.res_scalar,
                                    wa, r0, r1, scale_shift, levels)
            y, uv = y[0], uv[0]
        else:
            y, uv = _warp_stage(geom, scale_shift, levels, mode, "pair",
                                "hopper", planes, blurred, ts)
            y, uv = y[0][r0:r1], uv[0][r0 // 2:r1 // 2]
        # one gather: each rank's band, luma rows then chroma rows, padded
        # to the widest band
        band = torch.zeros((rows + rows // 2, wa), dtype=y.dtype,
                           device=dev)
        band[:r1 - r0] = y
        band[rows:rows + (r1 - r0) // 2] = uv
        parts = gather(band, group)
        y = torch.cat([p[:b - a] for p, (a, b) in zip(parts, bands)])
        uv = torch.cat([p[rows:rows + (b - a) // 2]
                        for p, (a, b) in zip(parts, bands)])
        return y, uv[:, 0::2].contiguous(), uv[:, 1::2].contiguous()

    return warp


def interp_step_sharded(geom: FlowGeometry, radius: int, group=None,
                        mode: int = warp_ops.BLENDED_FRAME,
                        scale_shift: int = 0, device="cuda"):
    """The whole sharded step: layer-sharded flow, row-sharded warp.
    Returns fn(f1y, f1u, f1v, f2y, f2u, f2v, t, ds=8, nbs=6, black=0.0,
    white=255.0) -> (offset, y, u, v)."""
    flow_fn = sharded_flow(geom, radius, group, scale_shift, device)
    warp_fn = row_sharded_warp(geom, mode, group, scale_shift, device)

    def step(f1y, f1u, f1v, f2y, f2u, f2v, t, ds: int = 8, nbs: int = 6,
             black=0.0, white=255.0):
        offset, blurred = flow_fn(f1y, f1u, f1v, f2y, f2u, f2v, ds, nbs)
        y, u, v = warp_fn(f1y, f1u, f1v, f2y, f2u, f2v, blurred, t, black,
                          white)
        return offset, y, u, v

    return step
