"""Quality report: PSNR of each model family against analytic ground truth
(the port's counterpart of the JAX repository's ``tools/quality_report.py``).

    python -m mpv_frame_interpolator_tpu_torch.tools.quality_report [--device cuda|cpu]

Content whose true in-between frames are computable exactly: a 256x128
sinusoidal pattern panned right by a whole number of pixels a frame (6:
the flow must lock on the pixel grid, and the in-between frame at t = 0.5
is hit exactly) and by a fraction (2.5: integer flow cannot lock, which
shows what the measured sub-pixel refinement buys on top of hopperq's
1/64-pel sampling).  The truth at any sub-pixel position comes from the
same formula.  One table per motion, the PSNR of each column at t in
(0.25, 0.4, 0.5, 0.75) and their mean, exact hits printed as 99 dB.

Every column goes through the path the engine runs for its family
(``pipeline/engine._warp_stage`` on the flow of ``ops/flow.flow``), so on
a card each reaches its kernel: the flow is one K1 launch with its blur
phase (the sub-pel columns' one K1 launch with S1's phases before the
blur phase); blend (a zero field) and hopper one K2 launch a position;
hopperx two K5 launches and G1's occlusion variant; hopperq and hopperxq
one Q1 launch, with the sub-pel field (``frac``) in the ``+subpel``
columns.  The device defaults to the card and never falls back to the
CPU; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from mpv_frame_interpolator_tpu_torch.convert import (
    frame_to_device, require_device)
from mpv_frame_interpolator_tpu_torch.frame import (
    FrameFormat, VideoFrame, interleave_chroma, psnr_arrays)
from mpv_frame_interpolator_tpu_torch.models.hopper import HopperModel
from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
from mpv_frame_interpolator_tpu_torch.ops import warp as warp_ops
from mpv_frame_interpolator_tpu_torch.pipeline.engine import _warp_stage

SHIFTS = (6, 2.5)
TS = (0.25, 0.4, 0.5, 0.75)
SEARCH_RADIUS = 10
CROP = (slice(12, -12), slice(24, -24))
CAP_DB = 99.0          # exact hits (integer positions) print as 99 dB

# column -> (the engine's model for it, the flow it warps by: "none" the
# zero field, "flow" the blurred field, "subpel" the floor of the blurred
# 1/64-pel field with its remainder)
COLUMNS = {
    "blend (no flow)": ("blend", "none"),
    "hopper": ("hopper", "flow"),
    "hopperx": ("hopperx", "flow"),
    "hopperq": ("hopperq", "flow"),
    "hopperxq": ("hopperxq", "flow"),
    "hopperq+subpel": ("hopperq", "subpel"),
    "hopperxq+subpel": ("hopperxq", "subpel"),
}


def sine_frames(shift, w=256, h=128):
    """(frame 1, frame 2 `shift` px to the right, the pattern: delta ->
    luma plane of the pan moved by delta px)."""
    def pattern(delta):
        x = np.arange(w)[None, :] - delta
        y = np.arange(h)[:, None]
        val = (128 + 80 * np.sin(2 * np.pi * x / 24.0)
               + 30 * np.sin(2 * np.pi * (x + 2 * y) / 40.0))
        return np.clip(val, 0, 255).astype(np.uint8)

    def mk(delta, pts):
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = np.full((h // 2, w // 2), 128, np.uint8)
        return VideoFrame(pattern(delta), interleave_chroma(u, v),
                          FrameFormat(w, h), pts=pts, nominal_fps=24.0)
    return mk(0.0, 0.0), mk(float(shift), 1 / 24.0), pattern


def _counters():
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blend_levels as KG
    from mpv_frame_interpolator_tpu_torch.ops.cuda import blur as KB
    from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
    from mpv_frame_interpolator_tpu_torch.ops.cuda import subpel as KP
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_bilinear as KQ
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_fused as KF
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_pair as KW
    from mpv_frame_interpolator_tpu_torch.ops.cuda import warp_sample as KD
    return {"flow_step": KS.counts, "blur_flow": KB.counts,
            "subpel_refine": KP.counts, "pair_blend": KW.counts,
            "fused_blend": KF.counts, "sample_dir": KD.counts,
            "blend_levels": KG.counts, "bilinear_blend": KQ.counts}


def _read_counts() -> Dict[str, int]:
    """Every wrapper's launches (the blur and S1 inside K1's launch as
    ``blur_phase`` and ``subpel_phase``) and plain calls (``plain:``)."""
    counters, out = _counters(), {}
    for name, c in counters.items():
        out[name] = c.kernel
        out[f"plain:{name}"] = c.plain
    out["blur_phase"] = counters["blur_flow"].fused
    out["subpel_phase"] = counters["subpel_refine"].fused
    return out


@contextlib.contextmanager
def _tally(stages: Dict[str, Dict[str, int]], stage: str):
    """Adds the calls made inside the block to ``stages[stage]``, keeping
    only the counts that moved."""
    before = _read_counts()
    yield
    acc = stages.setdefault(stage, {})
    for k, v in _read_counts().items():
        if v != before[k]:
            acc[k] = acc.get(k, 0) + v - before[k]


@dataclasses.dataclass
class Report:
    """One motion's table: `rows` [(t, {column: PSNR dB, uncapped})],
    `planes` {(t, column): the cropped rendered luma plane}, `launches`
    {stage: {wrapper: calls}} for the stages "flow", "flow+subpel" and
    each column (summed over t; ``plain:`` entries are plain-version
    calls)."""

    shift: float
    rows: List[Tuple[float, Dict[str, float]]]
    planes: Dict[Tuple[float, str], np.ndarray]
    launches: Dict[str, Dict[str, int]]

    def capped(self) -> List[Tuple[float, Dict[str, float]]]:
        return [(t, {n: min(v, CAP_DB) for n, v in vals.items()})
                for t, vals in self.rows]

    def mean(self) -> Dict[str, float]:
        rows = self.capped()
        return {n: sum(v[n] for _, v in rows) / len(rows) for n in COLUMNS}

    def table(self) -> str:
        names = list(COLUMNS)
        lines = [f"pan shift = {self.shift} px/frame",
                 f"{'t':>5} " + " ".join(f"{n:>16}" for n in names)]
        for t, vals in self.capped():
            lines.append(f"{t:>5} " + " ".join(f"{vals[n]:>14.1f}dB"
                                               for n in names))
        mean = self.mean()
        lines.append(f"{'mean':>5} " + " ".join(f"{mean[n]:>14.1f}dB"
                                                for n in names))
        return "\n".join(lines) + "\n"


def render(geom, model: str, planes, field, frac, t: float) -> np.ndarray:
    """The luma plane the engine writes for `model` at blend position t
    (mode 2, levels 0 / 255, the default sampler), on the planes'
    device, as a host array."""
    ts = torch.tensor([t], dtype=torch.float32, device=planes[0].device)
    y, _ = _warp_stage(geom, 0, warp_ops.level_ints(0.0, 255.0),
                       warp_ops.BLENDED_FRAME, "pair", model, planes, field,
                       ts, frac)
    return y[0].cpu().numpy()


def report(shift, device="cuda", quiet: bool = False) -> Report:
    """The table of one pan, printed unless `quiet`."""
    dev = require_device(device)
    f1, f2, pattern = sine_frames(shift)
    m = HopperModel.for_frame(f1.fmt.height, f1.fmt.width,
                              search_radius=SEARCH_RADIUS, device=str(dev))
    d1, d2 = frame_to_device(f1, dev), frame_to_device(f2, dev)
    planar = (d1.y, d1.u, d1.v, d2.y, d2.u, d2.v)
    launches: Dict[str, Dict[str, int]] = {}
    with _tally(launches, "flow"):
        _, blur = m.analyze(*planar)
    # the measured sub-pixel refinement (EngineConfig.subpel_flow): the
    # blurred 1/64-pel field from the same launch as the engine takes it
    with _tally(launches, "flow+subpel"):
        _, b64 = flow_ops.flow(m.geom, *planar, m.search_radius,
                               m.delta_scalar, m.neighbor_bias_scalar,
                               m.scale_shift, subpel=True)
    blur_sub = b64 >> 6
    fields = {"none": (torch.zeros_like(blur), None), "flow": (blur, None),
              "subpel": (blur_sub, b64 - (blur_sub << 6))}
    sources = (d1.y, d1.uv, d2.y, d2.uv)
    rows, planes = [], {}
    for t in TS:
        gt = pattern(shift * t)[CROP]
        vals = {}
        for name, (model, flow_kind) in COLUMNS.items():
            with _tally(launches, name):
                y = render(m.geom, model, sources, *fields[flow_kind], t)
            planes[(t, name)] = y[CROP]
            vals[name] = psnr_arrays(y[CROP], gt, 255)
        rows.append((t, vals))
    rep = Report(shift, rows, planes, launches)
    if not quiet:
        print(rep.table(), flush=True)
    return rep


def run(device="cuda", quiet: bool = False) -> List[Report]:
    """Both pans' reports, printed after a line naming the device unless
    `quiet`."""
    dev = require_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if not quiet:
        print(f"device: {dev} ({name})")
    return [report(s, dev, quiet) for s in SHIFTS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
