"""The launch plan of ``push``'s main-path pair: C1, K1 (with its blur
phase) and K2 launched from arguments checked and derived once per key,
into intermediates the engine owns.

The wrappers of the three kernels (``ops/cuda/prologue.pair_prologue``,
``ops/cuda/flow_step.flow_pyramid`` through ``ops/flow.flow``,
``ops/cuda/warp_pair.pair_blend``) check their arguments, derive their
launch constants and allocate the pair's intermediates at every call.
On the player's path, one pair a ``push``, that host work lies between
the previous pair's end and this pair's first kernel, and the card waits
for it.  None of it changes from pair to pair while the key holds:

* the level and its geometry, the layer count and the radius;
* the runtime state (``PairKnobs``), the level's model, ``warp_sampling``
  and the cut policy;
* the pixel format and the frame size;
* the current stream (its raw handle).

N, the number of positions, is a pair's own: at 24 -> 60 fps it is 2 and
3 in turn, and a key that held it would build a plan every pair.  The
plan passes each pair's N to C1 and K2 and keeps the folded positions in
a buffer grown to the largest N it has seen.

``PushPlan`` runs, once per key, the wrappers' checks that depend on the
key alone (their own functions, so the same errors), derives every launch
constant (the pyramid's step codes, the sums' size, K1's instantiation,
the part of K2's 16-byte path that the key decides, the level ints) and
allocates the pair's intermediates: C1's score, cut flag, folded
positions and probe planes; K1's field, blurred field and its two sums
buffers.  ``PushPlan.run`` then checks only what can differ from frame to
frame -- each plane's device, dtype, shape and contiguity, by attribute
reads (``fits``) -- allocates K2's two outputs, which the caller keeps,
and launches C1, K1 and K2 through their C entries, adding to the
wrappers' launch counters as they do.  The outputs are the wrappers',
bit for bit: each launch writes its intermediates in full (C1 its score,
flag, positions and probe; K1's blur phase zeros under a cut; the sums
need no zeroed start).

Reusing the intermediates is safe for the reason sharing the engine's C1
partials is: the pairs of one engine run in one stream's order, so pair
n + 1's C1 is enqueued behind pair n's K2, the last reader of pair n's
intermediates; and the host reads pair n's score back
(``InterpolationEngine._collect_timing``) after pair n's end event and
before it enqueues pair n + 1.  The stream is part of the key: a caller
that switches streams gets a new plan with intermediates of its own.
"""

from __future__ import annotations

import torch

from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
from mpv_frame_interpolator_tpu_torch.ops.cuda import (
    _build, blur as _k_blur, flow_step as _k_flow_step,
    prologue as _k_prologue, warp_pair as _k_pair)
from mpv_frame_interpolator_tpu_torch.utils.trace import annotate


def plane_shapes(height: int, stride: int):
    """The shapes of a frame's y, uv, u and v planes that a plan takes."""
    return ((height, stride), (height // 2, stride),
            (height // 2, stride // 2), (height // 2, stride // 2))


def frames_fit(f1, f2, device, dtype, shapes) -> bool:
    """Whether both frames' y, uv, u and v planes are on `device`, of
    `dtype` and `shapes`, and contiguous: attribute reads only.  A pair
    whose frames do not fit takes the wrappers, which raise their own
    errors."""
    for frame in (f1, f2):
        for t, shape in zip((frame.y, frame.uv, frame.u, frame.v), shapes):
            if t.dtype is not dtype or t.shape != shape or \
                    t.device != device or not t.is_contiguous():
                return False
    return True


class PushPlan:
    """The checked launches of one key; ``run`` launches one pair.  Built
    from the key's first pair, whose frames fit the format's planes
    (``frames_fit``)."""

    def __init__(self, key, geom: flow_ops.FlowGeometry, f1, f2,
                 ts: torch.Tensor, cuts: torch.Tensor,
                 partials: torch.Tensor, knobs, radius: int, layers: int,
                 scale_shift: int, cut_policy: str, stream: int):
        self.key = key
        y1, y2, u2, v2 = f1.y, f2.y, f2.u, f2.v
        dev, sample = y2.device, y2.dtype
        self.device, self.dtype = dev, sample
        self.shapes = plane_shapes(geom.height, geom.stride)
        ss, rs, lh, lw = scale_shift, geom.res_scalar, geom.low_h, geom.low_w
        h, pitch, wa = geom.height, geom.stride, geom.actual_width
        ds, nbs = knobs.delta_scalar, knobs.neighbor_bias_scalar

        # C1: pair_prologue's checks and outputs, kept as scratch
        _k_prologue._check(geom, y1, y2, u2, v2, ts, cuts, ss, cut_policy,
                           True)
        _k_prologue._require(geom, y1, y2, u2, v2, ts, cuts, partials, True)
        pro = _k_prologue._outputs(geom, y1, ts, knobs.scene_enabled, True)
        self.probe, self.score, self.cut = pro.probe, pro.score, pro.cut
        self.folded = pro.ts
        ptr = (lambda t: None if t is None else t.data_ptr())
        self._c1 = (*(p.data_ptr() for p in pro.probe), ptr(pro.score),
                    pro.cut.data_ptr(), cuts.data_ptr(), partials.data_ptr())
        self._c1_tail = (h, pitch, y1.stride(0), u2.stride(0), rs, lh, lw,
                         y1.element_size(), ss, int(pro.score is not None),
                         int(cut_policy == "nearest"), 0,
                         float(knobs.scene_threshold), stream)

        # K1: flow()'s and flow_pyramid()'s checks, its blur phase on
        flow_ops.check_radius(radius)
        steps = _k_flow_step.pyramid_steps(
            geom.window_schedule(), flow_ops.FIRST_NEIGHBOR_ITERATION)
        _k_flow_step._check_scalars(radius, ds, nbs, ss, steps)
        kernel_layers = _k_flow_step.kernel_layers(radius, layers)
        _k_flow_step._require_planes(y1, f1.u, f1.v, *pro.probe, None, None,
                                     rs, h, pitch)
        words = _k_flow_step.sums_words(steps, radius, lh, lw)
        self.field = torch.empty((2, lh, lw), dtype=torch.int32, device=dev)
        self.blurred = torch.empty_like(self.field)
        self.sums = torch.empty((2, words), dtype=torch.int32, device=dev)
        self._k1 = (*(p.data_ptr() for p in pro.probe), None, None,
                    self.field.data_ptr(), self.blurred.data_ptr(), None,
                    pro.cut.data_ptr(), self.sums.data_ptr(),
                    _k_flow_step.step_codes(steps),
                    len(steps), words, kernel_layers, radius, ds, nbs, rs,
                    h, pitch, lh, lw, y1.shape[1], f1.u.shape[1],
                    y1.element_size(), ss, None, stream)

        # K2: pair_blend's checks; outputs of (n, h, wa) and (n, h/2, wa)
        _k_pair.check_args(y1, f1.uv, y2, f2.uv, self.blurred, wa, ss)
        _k_pair._require_planes(y1, f1.uv, y2, f2.uv, self.blurred, pro.ts,
                                sample, h, pitch)
        self._out_rows = (h, h // 2, wa)
        item = y1.element_size()
        # vector_path's part that the key decides; the planes' addresses
        # are each pair's
        self._vector = (pitch * item % _k_pair.RUN_BYTES == 0
                        and wa * item % _k_pair.RUN_BYTES == 0)
        k, w = knobs.levels
        self._blurred = self.blurred.data_ptr()
        self._k2_tail = (h, wa, pitch, lh, lw, rs, ss, k, w)
        self._stream = stream
        self._lib = _build.load()

    def fits(self, f1, f2) -> bool:
        """Whether both frames' planes are the plan's (``frames_fit``)."""
        return frames_fit(f1, f2, self.device, self.dtype, self.shapes)

    def run(self, f1, f2, ts: torch.Tensor, flow_done=None):
        """One pair on the plan: (y, uv, cut score or None), as
        ``InterpolationEngine._pair_outputs`` returns them; `flow_done`
        is called between K1 and K2 (split timing).  `ts` is the pair's
        (N,) float32 positions on the plan's device, never written."""
        lib, n = self._lib, ts.shape[0]
        if n > self.folded.shape[0]:
            self.folded = torch.empty_like(ts)
        folded = self.folded.data_ptr()
        p1y, p2y = f1.y.data_ptr(), f2.y.data_ptr()
        with annotate("mfi.pair"):
            with annotate("mfi.c1"):
                _build.check("pair_prologue", lib.mfi_pair_prologue(
                    p1y, p2y, f2.u.data_ptr(), f2.v.data_ptr(),
                    ts.data_ptr(), folded, *self._c1, n, *self._c1_tail))
                _k_prologue.counts.kernel += 1
            with annotate("mfi.k1"):
                _build.check("flow_pyramid", lib.mfi_flow_pyramid(
                    p1y, f1.u.data_ptr(), f1.v.data_ptr(), *self._k1))
                _k_flow_step.counts.kernel += 1
            _k_blur.counts.fused += 1
            if flow_done is not None:
                flow_done()
            with annotate("mfi.k2"):
                h, hc, wa = self._out_rows
                with annotate("mfi.k2.alloc"):
                    y = torch.empty((n, h, wa), dtype=self.dtype,
                                    device=self.device)
                    uv = torch.empty((n, hc, wa), dtype=self.dtype,
                                     device=self.device)
                p1uv, p2uv = f1.uv.data_ptr(), f2.uv.data_ptr()
                py, puv = y.data_ptr(), uv.data_ptr()
                vec = self._vector and not (
                    (p1y | p1uv | p2y | p2uv | py | puv)
                    % _k_pair.RUN_BYTES)
                _build.check("pair_blend", lib.mfi_pair_blend(
                    p1y, p1uv, p2y, p2uv, self._blurred, folded, py, puv, n,
                    *self._k2_tail, int(vec), self._stream))
                _k_pair.counts.kernel += 1
        return y, uv, self.score
