"""Oracle-parity checks of the port on its device (counterpart of the JAX
package's ``utils/parity.py``).

The CPU tests prove the plain versions bit-exact; this module proves the
kernels on the card against the NumPy oracle (``ops/oracle.py``, the
port's copy of the JAX package's), so that a fault of the hardware path
or of the compiler shows.  The flow runs through ``ops/flow.flow`` (the
flow-pyramid kernel with its blur phase) and each output mode through the
engine's warp stage at its default sampler: mode 2 on the pair-blend
kernel, modes 0 and 1 on the one-direction sampler, modes 5/6 on the
side-by-side kernel (``ops/cuda/warp_views.warp_sbs``) and mode 4 as
tensor ops.  ``python -m mpv_frame_interpolator_tpu_torch.tools.
parity_report`` prints the full matrix.

Frames are small, as the JAX package keeps them.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

# (width, height, synthetic source, search radius, blend t)
FULL_CASES = [
    (96, 64, "moving_box", 5, 0.4),
    (96, 64, "gradient_pan", 16, 0.75),
    (320, 180, "moving_box", 8, 0.5),     # res_scalar >= 1
    (128, 544, "gradient_pan", 11, 0.3),  # res_scalar 2, tall
]
SMOKE_CASES = FULL_CASES[:2]

MODE_NAMES = {0: "warp12", 1: "warp21", 2: "blend", 4: "grey",
              5: "sbs1", 6: "sbs2"}


def run_parity(cases: Iterable[tuple] = SMOKE_CASES,
               modes: Iterable[int] = (0, 2),
               device="cuda") -> List[Tuple[str, bool]]:
    """Compare the device's flow and warp against the NumPy oracle;
    returns [(case name, bit_exact), ...], the JAX function's rows."""
    from mpv_frame_interpolator_tpu_torch.convert import require_device
    from mpv_frame_interpolator_tpu_torch.frame import split_chroma
    from mpv_frame_interpolator_tpu_torch.io import synthetic
    from mpv_frame_interpolator_tpu_torch.ops import oracle
    from mpv_frame_interpolator_tpu_torch.ops.flow import FlowGeometry, flow
    from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
        EngineConfig, _warp_stage)

    dev = require_device(device)
    sampling = EngineConfig.warp_sampling
    rows: List[Tuple[str, bool]] = []
    for (w, h, src, radius, t) in cases:
        cfg = synthetic.SyntheticConfig(width=w, height=h, fps=24.0)
        gen = getattr(synthetic, src)(cfg, 2)
        f1, f2 = next(gen), next(gen)
        geom = FlowGeometry.create(h, w, w)

        def on_dev(*planes):
            return [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                    for p in planes]

        y1, u1, v1 = on_dev(f1.y, *split_chroma(f1.uv))
        y2, u2, v2 = on_dev(f2.y, *split_chroma(f2.uv))
        f1uv, f2uv = on_dev(f1.uv, f2.uv)

        off_ref, blur_ref = oracle.calculate_optical_flow(
            f1.y, f1.uv, f2.y, f2.uv, search_radius=radius,
            res_scalar=geom.res_scalar, lh=geom.low_h, lw=geom.low_w)
        off_dev, _ = flow(geom, y1, u1, v1, y2, u2, v2, radius, 8, 6)
        flow_ok = np.array_equal(off_ref.astype(np.int32),
                                 off_dev.cpu().numpy())
        rows.append((f"flow {w}x{h} {src} r{radius}", flow_ok))

        blurred = on_dev(blur_ref.astype(np.int32))[0]
        ts = torch.tensor([t], dtype=torch.float32, device=dev)
        for mode in modes:
            ry, ruv = oracle.warp_frame(
                f1.y, f1.uv, f2.y, f2.uv, blur_ref, t, mode,
                geom.res_scalar, geom.actual_width)
            y, uv = _warp_stage(geom, 0, (0, 255), mode, sampling,
                                "hopper", (y1, f1uv, y2, f2uv), blurred, ts)
            ok = (np.array_equal(ry, y[0].cpu().numpy())
                  and np.array_equal(ruv, uv[0].cpu().numpy()))
            rows.append((f"warp {w}x{h} {MODE_NAMES.get(mode, mode)} t={t}",
                         ok))
    return rows


def parity_ok(cases=SMOKE_CASES, modes=(0, 2), device="cuda") -> bool:
    return all(ok for _, ok in run_parity(cases, modes, device))
