"""mpv_frame_interpolator_tpu_torch -- the PyTorch + CUDA port of the
frame interpolator, for one NVIDIA Hopper card (sm_90a).

It sits beside the JAX package ``mpv_frame_interpolator_tpu``, which stays
the reference, and keeps that package's layout and names: each module here
is the counterpart of the module at the same path there.  It imports
nothing of that package: the host modules it needs (frame, io.synthetic,
io.y4m, pipeline.cadence, pipeline.quality, pipeline.present, utils and
the flow geometry of ops.oracle and the model registry) are its own
copies.  The port covers every model family (hopper, hopperx, hopperq,
hopperxq, blend, repeat), scene detection, 8-bit NV12 and 10-bit P010,
any black/white levels, output modes 0-6 (warp12, warp21, blend, hsv,
grey, sbs1, sbs2) and every warp sampler of mode 2 ("pair", "shift" and
"gather" on K2, "fused" on K4, "pallas" on K5 and G1), search radii 2-256 with the degradation ladder,
and the player around the engine (``pipeline/player.Pipeline``: a
prefetch thread with staged uploads from page-locked buffers, seek,
pause, frame-step, loop and end, counted fail-open) with the grouped
encode path (``InterpolationEngine.push_many``, CUDA graph replays).

Its device work is hand-written CUDA kernels (``csrc/*.cu``), one for each
Pallas kernel of the JAX package plus G1 and Q1, each with a plain
PyTorch twin that is both its specification and its CPU path:

  ops/cuda/flow_step.py    K1: the whole flow pyramid of a pair in one
                           cooperative launch, with the blur (K3's tile
                           body) as its last phase
  ops/cuda/blur.py         K3: the 8x8 box blur of the flow field on its
                           own (the public ops/flow.blur_flow)
  ops/cuda/warp_pair.py    K2: every blended output of one source pair
  ops/cuda/warp_fused.py   K4: the blended output of one blend position
  ops/cuda/warp_sample.py  K5: the raw samples of one direction at one
                           position (modes 0, 1, 3 and "pallas")
  ops/cuda/blend_levels.py G1: the blend and level maps of K5's two
                           directions, with hopperx's occlusion correction
                           as a variant (not a TPU kernel: XLA's fusion)
  ops/cuda/warp_bilinear.py Q1: one 1/64-pel bilinear blended position of
                           hopperq / hopperxq (not a TPU kernel: XLA's
                           shift sampler)
  tools/pack_probe.py,     P1, P2: the toolchain probes
  tools/dma_probe.py

Importing the package touches neither ``torch.cuda`` nor any compiler: the
kernels are built with ``nvcc`` at their first launch (ops/cuda/_build.py).
"""

__version__ = "0.1.0"
