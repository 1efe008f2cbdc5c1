"""The flow's layer count follows the search radius (the analog of
``tests/test_layer_buckets.py``), and radii up to 256 run.

* The plain pyramid (K1's specification) against the JAX package's
  ``make_flow_fn`` at radius 2, 5, 8, 24 and 64 at 64 x 48, and at
  radius 2 at 96 x 544 (res scalar 2), P010 among them: offset and
  blurred field bit-exact.  (Radii 2-16 share one JAX program a
  geometry, layers = 16; each radius above 16 compiles its own.)
* ``kernel_layers``: the kernel's instantiation for a radius and the
  layer count the engine chose (5, 8 or 16 layers, 16-layer chunks above
  16), and what it refuses; a layer count >= the radius leaves the flow
  as it is.
* The engine picks the bucket of the live radius
  (``EngineConfig.layer_buckets``, default (5, 8, 16)) and hands it to the
  flow kernel; a mid-stream radius change across a bucket keeps its
  outputs equal to an engine that runs 16 layers (``layer_buckets=()``).

On the card ``tests/test_torch_cuda.py`` holds every instantiation
against the plain pyramid.  Bit-exact throughout (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.frame import split_chroma
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.ops.flow import FlowGeometry, make_flow_fn
from mpv_frame_interpolator_tpu_torch.ops import flow as TF
from mpv_frame_interpolator_tpu_torch.ops.cuda import flow_step as KS
from mpv_frame_interpolator_tpu_torch.pipeline import engine as port_engine

torch.set_num_threads(1)


def _planes(cfg, source):
    gen = getattr(synthetic, source)(cfg, 2)
    f1, f2 = next(gen), next(gen)
    return [np.ascontiguousarray(p) for p in
            (f1.y, *split_chroma(f1.uv), f2.y, *split_chroma(f2.uv))]


@pytest.mark.parametrize("w,h,pixfmt,source,radius", [
    (64, 48, "nv12", "noise", 2), (64, 48, "nv12", "moving_box", 5),
    (64, 48, "nv12", "gradient_pan", 8), (64, 48, "p010", "noise", 24),
    (64, 48, "nv12", "moving_box", 64),
    (96, 544, "nv12", "gradient_pan", 2)])
def test_plain_pyramid_equals_jax(w, h, pixfmt, source, radius):
    cfg = synthetic.SyntheticConfig(width=w, height=h, pixfmt=pixfmt)
    planes = _planes(cfg, source)
    geom = FlowGeometry.create(h, w, w)
    luma_shift = 8 if pixfmt == "p010" else 0
    want = make_flow_fn(geom, radius, luma_shift)(
        *(jnp.asarray(p) for p in planes), jnp.int32(8), jnp.int32(6))
    tgeom = TF.FlowGeometry.create(h, w, w)
    got = TF.flow(tgeom, *(torch.from_numpy(p) for p in planes), radius, 8,
                  6, luma_shift)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if source != "noise":
        assert got[0].any(), "the clip must produce some flow"


@pytest.mark.parametrize("radius,layers,want", [
    (2, None, 5), (5, None, 5), (5, 5, 5), (5, 8, 8), (5, 16, 16),
    (6, None, 8), (8, 8, 8), (9, None, 16), (11, 16, 16), (16, 16, 16),
    (5, 12, 16), (3, 4, 5), (17, None, 16), (24, 24, 16), (64, 64, 16),
    (256, 256, 16), (16, 32, 16)])
def test_kernel_layers(radius, layers, want):
    """The instantiation (layers a chunk) for a radius and the layer count
    the caller chose: the smallest of 5, 8 and 16 that holds it, 16-layer
    chunks above a radius of 16."""
    assert KS.kernel_layers(radius, layers) == want


def test_kernel_layers_refuses_fewer_layers_than_the_radius():
    with pytest.raises(ValueError, match="layers"):
        KS.kernel_layers(9, 8)
    geom = TF.FlowGeometry.create(48, 64, 64)
    planes = [torch.from_numpy(p) for p in _planes(
        synthetic.SyntheticConfig(width=64, height=48), "moving_box")]
    with pytest.raises(ValueError, match="layers"):
        TF.flow(geom, *planes, 16, layers=8)


def test_layer_count_leaves_the_flow_as_it_is():
    """Any layer count >= the radius gives the same field (on the card it
    picks the instantiation; the plain version has one)."""
    geom = TF.FlowGeometry.create(48, 64, 64)
    planes = [torch.from_numpy(p) for p in _planes(
        synthetic.SyntheticConfig(width=64, height=48), "gradient_pan")]
    ref = TF.flow(geom, *planes, 5, 8, 6)
    for layers in (5, 8, 16, 64):
        got = TF.flow(geom, *planes, 5, 8, 6, layers=layers)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def _engine(buckets, radius=5):
    return port_engine.InterpolationEngine(port_engine.EngineConfig(
        device="cpu", display_fps=60.0, auto_quality=False,
        initial_search_radius=radius, measure_timing=False,
        layer_buckets=buckets))


def test_engine_bucket_selection_and_parity(monkeypatch):
    """The engine's bucket for each radius, the layer count the flow kernel
    receives, and a mid-stream radius change across a bucket with outputs
    equal to a 16-layer engine's."""
    cfg = synthetic.SyntheticConfig(width=96, height=64, fps=24.0)
    frames = list(synthetic.moving_box(cfg, 8))
    e_b, e_m = _engine((16, 5, 8)), _engine(())
    assert e_b.config.layer_buckets == (5, 8, 16)
    assert [e_b._layers_for(r) for r in (2, 5, 6, 8, 9, 16, 17, 64)] == [
        5, 5, 8, 8, 16, 16, 17, 64]
    assert [e_m._layers_for(r) for r in (5, 16, 24)] == [16, 16, 24]
    assert _engine((4, 24))._layers_for(17) == 24

    seen = []
    real = KS.flow_pyramid

    def spy(*args, layers=None, **kw):
        seen.append((args[6], layers))          # (radius, layers)
        return real(*args, layers=layers, **kw)

    monkeypatch.setattr(KS, "flow_pyramid", spy)
    o_b, o_m = [], []
    for i, f in enumerate(frames):
        if i == 4:
            # mid-stream radius change crossing a bucket boundary
            e_b.quality.search_radius = e_m.quality.search_radius = 9
        o_b.extend(o.to_video_frame() for o in e_b.push(f))
        o_m.extend(o.to_video_frame() for o in e_m.push(f))
    assert len(o_b) == len(o_m) > 0
    for a, b in zip(o_b, o_m):
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.uv, b.uv)
    # pairs 1-3 at radius 5, then 9; each pair in both engines
    assert seen == [(5, 5), (5, 16)] * 3 + [(9, 16), (9, 16)] * 4
