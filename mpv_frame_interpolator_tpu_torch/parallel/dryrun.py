"""Entry points of the port for a compile check and a multi-process dry
run (counterparts of the JAX package's ``__graft_entry__.entry`` and
``dryrun_multichip``).

``entry()`` is one interpolation step at 1080p NV12, radius 8: the flow
pyramid with its blur (K1), then the blended warp of one position (K2).
``dryrun_multichip(n)`` spawns n ranks of a ``torch.distributed`` group
and runs the sharded step (``parallel/sharding.py``) on tiny shapes,
checking it against the single-device path bit for bit.
``run_sharded`` is what both the dry run and the tests drive: each rank
runs the sharded step on the same frames and holds it against the
single-device path (``ops/flow.flow`` and the engine's warp stage) on its
own device.

The rank function lives here, in the package, because a spawned child
imports the module that defines it.  The rendezvous is a file store in a
temporary directory (a fixed TCP port would collide between concurrent
runs).  On a card the kernels are built in the parent before any rank
starts, so that the ranks load one library and never race to build it;
with gloo every rank runs on the one card (``cuda:rank % count``), with
nccl each rank needs a card of its own.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): one interpolation step -- the hierarchical
    block-matching flow and the blended warp of one position -- at 1080p
    NV12, radius 8.  The example args are tensors on `device` (planar y,
    u, v of two frames and t; "cuda" unless the caller passes "cpu",
    which raises without a card); fn runs on the device of its arguments
    and returns planar (y, u, v)."""
    from mpv_frame_interpolator_tpu_torch.convert import require_device
    from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
    from mpv_frame_interpolator_tpu_torch.ops.cuda.warp_pair import (
        pair_blend)
    from mpv_frame_interpolator_tpu_torch.parallel.sharding import (
        interleave)

    H, W = 1080, 1920
    geom = flow_ops.FlowGeometry.create(H, W, W)
    radius = 8

    def step(f1y, f1u, f1v, f2y, f2u, f2v, t):
        _, blurred = flow_ops.flow(geom, f1y, f1u, f1v, f2y, f2u, f2v,
                                   radius, 8, 6)
        y, uv = pair_blend(f1y, interleave(f1u, f1v), f2y,
                           interleave(f2u, f2v), blurred, t.reshape(1),
                           geom.res_scalar, W)
        return y[0], uv[0, :, 0::2], uv[0, :, 1::2]

    dev = require_device(device)
    rng = np.random.default_rng(0)

    def mk(shape):
        return torch.from_numpy(rng.integers(0, 255, shape).astype(
            np.uint8)).to(dev)

    example_args = (mk((H, W)), mk((H // 2, W // 2)), mk((H // 2, W // 2)),
                    mk((H, W)), mk((H // 2, W // 2)), mk((H // 2, W // 2)),
                    torch.tensor(0.4, dtype=torch.float32, device=dev))
    return step, example_args


def _sharded_job(rank: int, world: int, dev: torch.device, spec: dict):
    """One rank: the sharded step in each mode against the single-device
    path; rank 0's arrays and every rank's verdict and ms a pair."""
    import torch.distributed as dist

    from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
    from mpv_frame_interpolator_tpu_torch.parallel import sharding
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import _warp_stage

    with np.load(spec["planes"]) as saved:
        planes = sharding._to(dev, [saved[f"arr_{i}"] for i in range(6)])
    H, stride = planes[0].shape
    geom = flow_ops.FlowGeometry.create(H, stride, stride)
    radius, t = spec["radius"], spec["t"]
    flow_fn = sharding.sharded_flow(geom, radius, None, 0, dev)
    offset, blurred = flow_fn(*planes)
    ref_off, ref_blur = flow_ops.flow(geom, *planes, radius, 8, 6)
    equal = bool(torch.equal(offset, ref_off)
                 and torch.equal(blurred, ref_blur))
    f1uv = sharding.interleave(planes[1], planes[2])
    f2uv = sharding.interleave(planes[4], planes[5])
    ts = torch.tensor([t], dtype=torch.float32, device=dev)
    outputs = {}
    for mode in spec["modes"]:
        warp_fn = sharding.row_sharded_warp(geom, mode, None, 0, dev)
        y, u, v = warp_fn(*planes, blurred, t)
        ry, ruv = _warp_stage(geom, 0, (0, 255), mode, "pair", "hopper",
                              (planes[0], f1uv, planes[3], f2uv), ref_blur,
                              ts)
        equal = equal and bool(
            torch.equal(y, ry[0]) and torch.equal(u, ruv[0][:, 0::2])
            and torch.equal(v, ruv[0][:, 1::2]))
        outputs[mode] = tuple(p.cpu().numpy() for p in (y, u, v))
    ms = None
    if spec["reps"]:
        step = sharding.interp_step_sharded(geom, radius, None,
                                            spec["modes"][0], 0, dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()

        sync()
        t0 = time.perf_counter()
        for _ in range(spec["reps"]):
            step(*planes, t)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / spec["reps"]
    result = {"rank": rank, "equal": equal, "ms": ms}
    if rank == 0 and spec["arrays"]:
        result.update(offset=offset.cpu().numpy(),
                      blurred=blurred.cpu().numpy(), outputs=outputs)
    return result


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               device: str, spec: dict, out):
    """A rank's whole life: join the group, run the job, leave; its result
    (or its traceback) goes to `out`, with the monotonic clock (shared by
    the host's processes) when it started, joined the group and ended
    the job."""
    import torch.distributed as dist
    started = time.monotonic()
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        elif world > 1:     # a spawned rank: one thread each
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
        joined = time.monotonic()
        try:
            result = _sharded_job(rank, world, dev, spec)
            result["clock"] = (started, joined, time.monotonic())
            out.put(result)
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put({"rank": rank, "error": traceback.format_exc()})


def default_backend(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


RANK_TIMEOUT_S = 600.0     # every rank reports within this


def run_sharded(world: int, planes, radius: int, modes=(2,), t=0.5,
                device="cuda", backend=None, reps: int = 0,
                arrays: bool = True):
    """Run the sharded step on `world` ranks over planar 8-bit frames
    `planes` (six numpy arrays: f1y, f1u, f1v, f2y, f2u, f2v) at the
    engine's default scalars and levels; each rank checks it against the
    single-device path.  Returns rank 0's result: `equal` (every rank's
    verdict), `ms` (ms a pair over `reps` timed steps, or None) and, with
    `arrays`, its offset, blur and (y, u, v) of each mode, and `seconds`
    (from the call until every rank had started, joined the group and
    ended its job).  World size 1
    runs in this process; larger worlds spawn a process a rank.  Raises
    with a rank's traceback if one failed."""
    from mpv_frame_interpolator_tpu_torch.convert import require_device
    backend = backend or default_backend(device)
    dev = require_device(device)
    if radius % world:
        raise ValueError(f"radius {radius} does not split over {world} "
                         "ranks")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and (dev.type != "cuda"
                              or world > torch.cuda.device_count()):
        raise ValueError(f"nccl needs a card a rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards on {device}")
    if dev.type == "cuda":
        from mpv_frame_interpolator_tpu_torch.ops.cuda import _build
        _build.load()       # built once, before any rank starts
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="mfi_dist_")
    init = f"file://{os.path.join(tmp, 'store')}"
    # the frames go to the ranks in a file: spawn pickles a process's
    # arguments into a pipe that the child reads only once it has
    # started, so large arguments would start the ranks one by one
    spec = dict(planes=os.path.join(tmp, "planes.npz"), radius=radius,
                modes=tuple(modes), t=float(t), reps=reps, arrays=arrays)
    np.savez(spec["planes"], *planes)
    results = {}
    procs = []
    try:
        if world == 1:
            out = queue_mod.Queue()
            _rank_main(0, 1, init, backend, str(dev), spec, out)
            results[0] = out.get_nowait()
        else:
            ctx = torch.multiprocessing.get_context("spawn")
            out = ctx.Queue()
            procs = [ctx.Process(target=_rank_main,
                                 args=(r, world, init, backend, str(dev),
                                       spec, out), daemon=True)
                     for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + RANK_TIMEOUT_S
            # drained before the ranks are joined
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world - len(results)} of {world} "
                                       f"ranks did not report in "
                                       f"{RANK_TIMEOUT_S} s")
                try:
                    r = out.get(timeout=min(left, 5.0))
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and len(results) < world:
                        raise RuntimeError(f"a rank exited with {dead[0]} "
                                           "before it reported")
                    continue
                results[r["rank"]] = r
            for p in procs:
                p.join(timeout=60.0)
        errors = [r["error"] for r in results.values() if "error" in r]
        if errors:
            raise RuntimeError(f"{len(errors)} of {world} ranks failed; the "
                               f"first:\n{errors[0]}")
        first = results[0]
        first["equal"] = all(r["equal"] for r in results.values())
        first["ms_by_rank"] = [results[r]["ms"] for r in range(world)]
        # seconds from this call until the last rank had started, had
        # joined the group and had ended its job
        first["seconds"] = tuple(max(r["clock"][i] for r in results.values())
                                 - t0 for i in range(3))
        return first
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        shutil.rmtree(tmp, ignore_errors=True)


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> dict:
    """Run ONE sharded interpolation step on n ranks at 64 x 128, radius
    16 (the JAX dry run's shapes): the flow with its candidate layers
    sharded over the ranks, the warp row-sharded; raises unless the offset
    and the warp equal the single-device path bit for bit, and prints one
    line.  Returns rank 0's result."""
    H, W = 64, 128
    radius = 16
    if radius % n_devices:
        if n_devices % radius:
            raise ValueError(f"{n_devices} ranks do not split {radius} "
                             "layers")
        radius = n_devices      # the JAX dry run's degenerate case
    rng = np.random.default_rng(0)

    def mk(shape):
        return rng.integers(0, 255, shape).astype(np.uint8)

    # the JAX dry run's draw order: f1y, f2y, then the chroma planes
    f1y, f2y = mk((H, W)), mk((H, W))
    f1u, f1v = mk((H // 2, W // 2)), mk((H // 2, W // 2))
    f2u, f2v = mk((H // 2, W // 2)), mk((H // 2, W // 2))
    backend = backend or default_backend(device)
    res = run_sharded(n_devices, (f1y, f1u, f1v, f2y, f2u, f2v), radius,
                      (2,), 0.5, device, backend)
    if not res["equal"]:
        raise AssertionError(f"dryrun_multichip: {n_devices} ranks "
                             "disagree with the single-device path")
    print(f"dryrun_multichip: {n_devices} ranks ({backend} on {device}) "
          f"OK; flow sharded over {radius} layers and row-sharded warp "
          f"match single-device", flush=True)
    return res
